"""Auth plugins for the GRPC clients (mirrors ``client_tpu.grpc.auth``).

Plugins are transport-agnostic: ``BasicAuth`` from the shared base sets the
``authorization`` metadata key as it sets the HTTP header.
"""

from ..._base import BasicAuth, InferenceServerClientPlugin

__all__ = ["BasicAuth", "InferenceServerClientPlugin"]
