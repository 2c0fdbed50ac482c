"""The model zoo of the PyTorch port (the counterpart of ``client_tpu.models``):
the fixture contracts, ``batched_matmul``, the decoder family (``decoder_lm``,
``tiny_lm_generate``, ``decoder_lm_batched``, ``decoder_lm_prefill``, the
tensor-parallel ``decoder_lm_tp`` and ``decoder_lm_tp_prefill``, and the
disagg pair), the ``chain_*`` pipeline fixtures, the long-context encoder,
the expert-parallel ``moe_ffn`` and the vision path, on a torch device or a
mesh of them (``client_tpu_torch.parallel``). ``decoder_lm_tp``,
``long_context_encoder``, ``moe_ffn`` and the vision models are not in
:func:`default_model_zoo` (as in the JAX package): add a
:class:`TPDecoderModel`, :class:`LongContextEncoderModel`,
:class:`MoEFFNModel`, or the three models of :func:`build_image_ensemble`
(``preprocess``, ``densenet_onnx``, ``ensemble_image``), to a
``ServerCore`` to serve them. ``draw_params`` and
``load_jax_params`` here are the decoder's; the other models' live in their
modules."""

from .base import Model, TensorSpec
from .batched import BatchedMatMulModel
from .chain import (
    ChainCore,
    ChainEmbedModel,
    ChainFusedModel,
    ChainRerankModel,
    ChainTokenizeModel,
)
from .decoder import TinyDecoderModel, draw_params, load_jax_params
from .decoder_batched import BatchedDecoderModel
from .decoder_prefill import PrefillDecoderModel
from .decoder_tp import TPDecoderModel
from .disagg import DisaggPrefillModel, KvDecodeModel
from .ensemble import EnsembleModel, EnsembleStep, build_image_ensemble
from .generate import TinyGenerateModel
from .long_context import LongContextEncoder, LongContextEncoderModel
from .moe import MoEFFNModel
from .simple import (
    AddSubModel,
    IdentityModel,
    RepeatModel,
    SequenceAccumulatorModel,
    StringAddSubModel,
    default_model_zoo,
)
from .vision import DenseNetModel, ImagePreprocessModel

__all__ = [
    "AddSubModel",
    "BatchedDecoderModel",
    "BatchedMatMulModel",
    "ChainCore",
    "ChainEmbedModel",
    "ChainFusedModel",
    "ChainRerankModel",
    "ChainTokenizeModel",
    "DenseNetModel",
    "DisaggPrefillModel",
    "EnsembleModel",
    "EnsembleStep",
    "IdentityModel",
    "ImagePreprocessModel",
    "KvDecodeModel",
    "LongContextEncoder",
    "LongContextEncoderModel",
    "Model",
    "MoEFFNModel",
    "PrefillDecoderModel",
    "RepeatModel",
    "SequenceAccumulatorModel",
    "StringAddSubModel",
    "TensorSpec",
    "TinyDecoderModel",
    "TPDecoderModel",
    "TinyGenerateModel",
    "build_image_ensemble",
    "default_model_zoo",
    "draw_params",
    "load_jax_params",
]
