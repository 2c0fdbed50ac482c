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


def proto_path() -> str:
    """Filesystem path of the vendored ``grpc_service.proto``.

    Ships as package data so an install can generate stubs in any language:
    ``protoc -I $(dirname path) --go_out=... grpc_service.proto``. The file
    is the KServe v2 service this package's wire codec speaks."""
    import os

    return os.path.join(os.path.dirname(os.path.abspath(__file__)),
                        "grpc_service.proto")


__all__ = [
    "proto_path",
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
