"""Bound constants of a (source, grid) pair — port of the JAX package's
``bnb/bounds.py`` as far as the flat SE(3) engine reads it.

:class:`BoundsEvaluator` holds the source norms, the inlier count ``h`` and
the grid's lattice slack; :func:`lookup_sq` is the grid lookup of the
"grid" backend.  The bounds themselves are evaluated by
:mod:`goicp_tpu_torch.bnb.se3_eval`.
"""

from __future__ import annotations

import math
from typing import Optional

import torch

from goicp_tpu_torch.nn.fused import _sq3_fma, sqrt_rn
from goicp_tpu_torch.nn.grid import DistanceGrid, lookup_sq_nearest, lookup_sq_trilinear

_SQRT3 = math.sqrt(3.0)


def lattice_slack(grid: DistanceGrid, lookup: str) -> float:
    """Worst-case |grid distance − true distance| inside the domain
    (``bounds.py:49``): half the cell diagonal for the nearest-cell lookup,
    the full diagonal for trilinear interpolation of d², plus the build's
    rasterization error."""
    interp = grid.cell * _SQRT3 * (1.0 if lookup == "trilinear" else 0.5)
    return interp + float(grid.raster_err)


def lookup_sq(grid: DistanceGrid, pts, lookup: str):
    """Squared-distance lookup (``"nearest"`` or ``"trilinear"``) and the
    escape distance (``device_inner.py:63``)."""
    if lookup == "trilinear":
        return lookup_sq_trilinear(grid, pts)
    return lookup_sq_nearest(grid, pts)


class BoundsEvaluator:
    """Bound constants of one (source, grid) pair (``bounds.py:124``).
    ``grid`` may be None when every bound comes from the fused kernels;
    then the slack is 0."""

    def __init__(
        self,
        src: torch.Tensor,
        grid: Optional[DistanceGrid] = None,
        *,
        trim_fraction: float = 0.0,
        lookup: str = "trilinear",
        conservative: bool = True,
    ):
        self.src = src                                     # [N,3]
        # ≙ normData, jly_goicp.cpp:142; rounded as the jitted
        # jnp.linalg.norm: fused multiply-adds, a correctly rounded root
        self.norms = sqrt_rn(_sq3_fma(src))
        self.grid = grid
        self.n_points = int(src.shape[0])
        self.trim_fraction = float(trim_fraction)
        self.h = max(1, int(round(self.n_points * (1.0 - self.trim_fraction))))
        self.lookup = lookup
        self.slack = lattice_slack(grid, lookup) if (conservative and grid is not None) else 0.0
