"""Bound evaluation on the distance grid for a (source, grid) pair — port
of the JAX package's ``bnb/bounds.py``.

:class:`BoundsEvaluator` holds the source norms, the inlier count ``h`` and
the grid's lattice slack, and evaluates job batches by :func:`bounds_step`:
per (rotation, translation cube) job, the center value and the cube's lower
bound from grid lookups (:func:`lookup_sq`).  The SE(3) engine's rounds
evaluate their bounds in :mod:`goicp_tpu_torch.bnb.se3_eval`; the mesh's
``dist.sharding.sharded_bounds_step`` computes this step's per-point terms
(:func:`step_distances`, :func:`step_terms`) on each point shard.
"""

from __future__ import annotations

import math
from typing import Optional

import numpy as np
import torch

from goicp_tpu_torch.geo.rotation import rotation_displacement
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


def step_distances(grid: DistanceGrid, src, R, t_center, lookup: str):
    """Grid distance and escape term of every job's transformed points,
    ``R_m·p + t_m``: ``(d, esc) [M, N]``."""
    pts = src[None] @ R.transpose(-1, -2) + t_center[:, None, :]
    val, esc = lookup_sq(grid, pts, lookup)
    return sqrt_rn(torch.clamp(val, min=0.0)), esc


def step_terms(d, esc, slack, max_angle, norms, t_span, rot_flag):
    """The bound step's per-point terms ``(center, lb) [M, N]``
    (``bounds.py:82``): with ``d_lo = max(d − esc − slack, 0)`` and ``d_hi
    = d + esc + slack``, the center term is ``max(d_lo − γr, 0)²`` for a
    job with ``rot_flag`` (a lower-bound path) and ``d_hi²`` without, and
    the lb term ``max(d_lo − γr − √3·span, 0)²``; ``γr`` is the rotation
    radius ``2·sin(min(θ,π)/2)·|p|`` where ``rot_flag`` is set, else 0."""
    d_lo = torch.clamp(d - esc - slack, min=0.0)
    d_hi = d + esc + slack
    gamma_r = rotation_displacement(max_angle, norms) * rot_flag[:, None]
    gamma_t = (_SQRT3 * t_span)[:, None]
    center_d = torch.where(rot_flag[:, None] > 0, d_lo, d_hi)
    cc = torch.clamp(center_d - gamma_r, min=0.0)
    lc = torch.clamp(d_lo - gamma_r - gamma_t, min=0.0)
    return cc * cc, lc * lc


def _trimmed_row_sum(x, h: int):
    """Sum of the ``h`` smallest entries of each row, ``x [M, N] → [M]``
    (``bounds.py:63``): the row sum less its ``N − h`` largest entries when
    those are the fewer, else the sum of the ``h`` smallest."""
    n = x.shape[-1]
    if h >= n:
        return x.sum(-1)
    drop = n - h
    if drop <= h:
        return x.sum(-1) - torch.topk(x, drop, dim=-1).values.sum(-1)
    return torch.topk(x, h, dim=-1, largest=False).values.sum(-1)


def bounds_step(src, norms, grid: DistanceGrid, slack, R, max_angle, t_center, t_span,
                rot_flag, mask, *, h: int, lookup: str):
    """The bound step on the grid (``bounds.py:82``): for jobs ``[M, ...]``
    (rotation ``R``, its angle bound, translation cube center and half
    span, ``rot_flag`` 1 for a lower-bound path), ``(center_val, node_lb)
    [M]``: the trimmed sums (``h`` inliers) of :func:`step_terms`, +inf
    where ``mask`` is False.  Sums in ATen's order, as the mesh's
    ``sharded_bounds_step``: within rtol 1e-5 of the jitted JAX step."""
    d, esc = step_distances(grid, src, R, t_center, lookup)
    cc, lc = step_terms(d, esc, slack, max_angle, norms, t_span, rot_flag)
    inf = torch.full((R.shape[0],), float("inf"), dtype=torch.float32, device=R.device)
    return (torch.where(mask, _trimmed_row_sum(cc, h), inf),
            torch.where(mask, _trimmed_row_sum(lc, h), inf))


class BoundsEvaluator:
    """Bound evaluator of one (source, grid) pair (``bounds.py:124``).
    ``grid`` may be None when every bound comes from the fused kernels;
    then the slack is 0 and only :meth:`evaluate` and :meth:`sse_at`, which
    read the grid, are refused."""

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

    def evaluate(self, R, max_angle, t_center, t_span, rot_flag, mask):
        """Evaluate a padded job batch on the grid (:func:`bounds_step`, on
        the source's device); returns numpy ``(center_val, node_lb)``."""
        if self.grid is None:
            raise ValueError("BoundsEvaluator.evaluate needs a distance grid")
        dev = self.src.device
        f = lambda x: torch.as_tensor(np.asarray(x, np.float32), device=dev)  # noqa: E731
        cv, lb = bounds_step(
            self.src, self.norms, self.grid, self.slack, f(R), f(max_angle), f(t_center),
            f(t_span), f(rot_flag), torch.as_tensor(np.asarray(mask, bool), device=dev),
            h=self.h, lookup=self.lookup,
        )
        return cv.cpu().numpy(), lb.cpu().numpy()

    def sse_at(self, R, t) -> np.ndarray:
        """Plain (trimmed) SSE at the exact poses ``[B]`` via the grid
        (``bounds.py:177``): the center value of rotation-free jobs."""
        R = np.asarray(R, np.float32).reshape(-1, 3, 3)
        t = np.asarray(t, np.float32).reshape(-1, 3)
        zeros = np.zeros((R.shape[0],), np.float32)
        cv, _ = self.evaluate(R, zeros, t, zeros, zeros, np.ones((R.shape[0],), bool))
        return cv
