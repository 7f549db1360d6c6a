"""goicp_tpu_torch — the PyTorch/CUDA port of goicp_tpu for one NVIDIA H100.

The port sits beside the JAX package, which stays the reference, and
imports nothing from it.  It carries the certified flat SE(3) Go-ICP solve
of one pair (:func:`register`, :func:`make_solver`), untrimmed and trimmed,
on Hopper kernels written in CUDA C++ (``csrc/``, K1-K7, one for each
Pallas kernel of the JAX package; see :mod:`goicp_tpu_torch.nn.fused`).
Entry points run on CUDA unless the caller passes ``device="cpu"``, which
runs each kernel's plain PyTorch version.

All arithmetic is f32; TF32 is off, mirroring the JAX package's pinned
``Precision.HIGHEST``.
"""

import torch

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
torch.set_float32_matmul_precision("highest")

from goicp_tpu_torch.bnb import (  # noqa: E402
    BnbParams,
    GoIcpResult,
    make_solver,
    register,
)
from goicp_tpu_torch.core.types import RigidTransform  # noqa: E402

__all__ = ["BnbParams", "GoIcpResult", "RigidTransform", "make_solver", "register"]
