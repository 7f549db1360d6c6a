"""goicp_tpu_torch — the PyTorch/CUDA port of goicp_tpu for one NVIDIA H100.

The port sits beside the JAX package, which stays the reference, and
imports nothing from it.  It carries the reference-TOML CLI and its five
run modes (``python -m goicp_tpu_torch scenario.toml``,
:mod:`goicp_tpu_torch.cli`); the certified Go-ICP solve of one pair
(:func:`register`, :func:`make_solver`) on the flat SE(3) or the nested
engine, untrimmed and trimmed, point or plane metric, on the fused bounds
or a distance grid, with checkpoint/resume and full-cloud certification
(:func:`goicp_tpu_torch.bnb.register_full_cert`); the lockstep solve of
many pairs (:func:`register_pairs`, :func:`icp_pairs`); and the JSON-lines
registration service (``python -m goicp_tpu_torch serve``,
:mod:`goicp_tpu_torch.serve`).  Its kernels are written for Hopper in CUDA
C++ (``csrc/``, K1-K7, one for each Pallas kernel of the JAX package; see
:mod:`goicp_tpu_torch.nn.fused`).
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
from goicp_tpu_torch.core.config import Config, Mode  # noqa: E402
from goicp_tpu_torch.core.types import RigidTransform  # noqa: E402
from goicp_tpu_torch.multipair import icp_pairs, register_pairs  # noqa: E402

__all__ = ["BnbParams", "Config", "GoIcpResult", "Mode", "RigidTransform", "icp_pairs",
           "make_solver", "register", "register_pairs"]
