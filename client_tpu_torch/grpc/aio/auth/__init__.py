"""Auth plugins for the asyncio GRPC client (mirrors
``client_tpu.grpc.aio.auth``).

Plugins are transport-agnostic: ``BasicAuth`` from the shared base works on
the sync and aio clients alike; this module keeps the reference's import
path.
"""

from ...._base import BasicAuth, InferenceServerClientPlugin

__all__ = ["BasicAuth", "InferenceServerClientPlugin"]
