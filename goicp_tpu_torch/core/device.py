"""Device choice for the port's entry points.

``device=None`` means ``"cuda"``.  There is no silent CPU fallback: with no
GPU a CUDA request raises, and the CPU runs only when the caller asks for it
(the tests pass ``device="cpu"``, which takes every kernel's plain PyTorch
version).
"""

from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "goicp_tpu_torch runs on a CUDA device and none is available; "
            "pass device='cpu' to run the plain PyTorch path"
        )
    return dev


def to_device(x, device: torch.device, dtype=torch.float32) -> torch.Tensor:
    """Host array → tensor on ``device`` without blocking the host.

    A plain ``.to("cuda")`` from pageable memory synchronises the stream,
    which would drain the queued BnB rounds; pinned memory with
    ``non_blocking=True`` keeps the copy in stream order instead.  The
    caching host allocator keeps the pinned block alive until the copy ran.
    """
    t = torch.as_tensor(x, dtype=dtype)
    if device.type != "cuda" or t.device.type != "cpu":
        return t.to(device)
    return t.pin_memory().to(device, non_blocking=True)
