"""KServe v2 GRPC client namespace (mirrors ``client_tpu.grpc``)."""

from .._base import (
    BasicAuth,
    InferenceServerClientBase,
    InferenceServerClientPlugin,
    Request,
)
from .._tensor import InferInput, InferRequestedOutput
from ..utils import InferenceServerException
from ._client import CallContext, InferenceServerClient, KeepAliveOptions
from ._infer import InferResult

__all__ = [
    "BasicAuth",
    "CallContext",
    "InferInput",
    "InferRequestedOutput",
    "InferResult",
    "InferenceServerClient",
    "InferenceServerClientBase",
    "InferenceServerClientPlugin",
    "InferenceServerException",
    "KeepAliveOptions",
    "Request",
]
