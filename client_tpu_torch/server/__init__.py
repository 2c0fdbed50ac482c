"""In-process KServe v2 inference server with a PyTorch backend (the
counterpart of ``client_tpu.server``): ``ServerCore`` plus the threaded HTTP,
the aiohttp and the GRPC frontends, with the system and cuda shared-memory
data planes. Each frontend drains on ``close``: ready goes to not-ready
while in-flight requests finish."""

from .core import InferError, ServerCore
from .grpc_server import GrpcInferenceServer
from .http_server import HttpInferenceServer

__all__ = [
    "AioHttpInferenceServer",
    "GrpcInferenceServer",
    "HttpInferenceServer",
    "InferError",
    "ServerCore",
]


def __getattr__(name):
    # lazy: the aio frontend needs aiohttp, which importing the package must not
    if name == "AioHttpInferenceServer":
        from .http_server_aio import AioHttpInferenceServer

        return AioHttpInferenceServer
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
