"""The model zoo of the PyTorch port (the counterpart of ``client_tpu.models``):
the fixture contracts, the decoder family and the long-context encoder, on a
torch device. ``long_context_encoder`` is not in :func:`default_model_zoo`
(as in the JAX package); add a :class:`LongContextEncoderModel` to a
``ServerCore`` to serve it."""

from .base import Model, TensorSpec
from .decoder import TinyDecoderModel, draw_params, load_jax_params
from .generate import TinyGenerateModel
from .long_context import LongContextEncoder, LongContextEncoderModel
from .simple import AddSubModel, IdentityModel, default_model_zoo

__all__ = [
    "AddSubModel",
    "IdentityModel",
    "LongContextEncoder",
    "LongContextEncoderModel",
    "Model",
    "TensorSpec",
    "TinyDecoderModel",
    "TinyGenerateModel",
    "default_model_zoo",
    "draw_params",
    "load_jax_params",
]
