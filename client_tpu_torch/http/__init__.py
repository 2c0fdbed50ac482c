"""KServe v2 HTTP/REST client namespace (mirrors ``client_tpu.http``)."""

from .._base import (
    BasicAuth,
    InferenceServerClientBase,
    InferenceServerClientPlugin,
    Request,
)
from .._tensor import InferInput, InferRequestedOutput
from ..utils import InferenceServerException
from ._client import InferenceServerClient
from ._infer_result import InferResult

__all__ = [
    "BasicAuth",
    "InferInput",
    "InferRequestedOutput",
    "InferResult",
    "InferenceServerClient",
    "InferenceServerClientBase",
    "InferenceServerClientPlugin",
    "InferenceServerException",
    "Request",
]
