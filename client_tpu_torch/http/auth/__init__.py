"""Auth plugins for the sync HTTP client (mirrors ``client_tpu.http.auth``).

Plugins are transport-agnostic: ``BasicAuth`` from the shared base; this
module keeps the reference's import path.
"""

from ..._base import BasicAuth, InferenceServerClientPlugin

__all__ = ["BasicAuth", "InferenceServerClientPlugin"]
