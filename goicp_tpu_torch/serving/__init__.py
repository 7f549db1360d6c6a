"""The serving package: resident-target registration over JSON lines (port
of the JAX package's ``serving/``).

- :mod:`~goicp_tpu_torch.serving.service` — resident state (targets,
  distance grids, normals, tracking closures) and the solve methods.
- :mod:`~goicp_tpu_torch.serving.protocol` — wire encoding, request
  dispatch, stdio transport.
- :mod:`~goicp_tpu_torch.serving.tcp` — TCP transport with cross-connection
  micro-batching and token authentication.
- :mod:`~goicp_tpu_torch.serving.cli` — ``python -m goicp_tpu_torch serve``.

:mod:`goicp_tpu_torch.serve` re-exports this surface.
"""

from goicp_tpu_torch.serving.cli import main
from goicp_tpu_torch.serving.protocol import handle_request, serve_stdio
from goicp_tpu_torch.serving.service import MultiTargetService, RegistrationService
from goicp_tpu_torch.serving.tcp import Batcher, serve_tcp

__all__ = [
    "Batcher",
    "MultiTargetService",
    "RegistrationService",
    "handle_request",
    "main",
    "serve_stdio",
    "serve_tcp",
]
