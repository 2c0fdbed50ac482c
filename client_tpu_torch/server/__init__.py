"""In-process KServe v2 inference server with a PyTorch backend (the
counterpart of ``client_tpu.server``): ``ServerCore`` plus the threaded HTTP
frontend, with the system and cuda shared-memory data planes."""

from .core import InferError, ServerCore
from .http_server import HttpInferenceServer

__all__ = ["HttpInferenceServer", "InferError", "ServerCore"]
