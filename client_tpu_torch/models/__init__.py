"""The model zoo of the PyTorch port (the counterpart of ``client_tpu.models``):
the fixture contracts and the decoder family, on a torch device."""

from .base import Model, TensorSpec
from .decoder import TinyDecoderModel, draw_params, load_jax_params
from .generate import TinyGenerateModel
from .simple import AddSubModel, IdentityModel, default_model_zoo

__all__ = [
    "AddSubModel",
    "IdentityModel",
    "Model",
    "TensorSpec",
    "TinyDecoderModel",
    "TinyGenerateModel",
    "default_model_zoo",
    "draw_params",
    "load_jax_params",
]
