"""Batched ICP — the local refiner of the SE(3) engine (port of the JAX
package's ``icp/solver.py``: the point metric with exact correspondences).

One masked loop refines a batch ``[B]`` of poses together; Procrustes is
Horn's quaternion method (:mod:`goicp_tpu_torch.geo.procrustes`) and the
correspondences come from the exact nearest-neighbour kernel K1
(:func:`goicp_tpu_torch.nn.fused.nearest_neighbor_mxu`).

The JAX version is a ``lax.while_loop`` that stops when no pose is active.
Here the host tests ``any(active)`` before every iteration, which reads one
flag from the device and so waits for the work queued before it.  Results
are the same as the device loop's: an inactive pose is never updated.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable

import torch

from goicp_tpu_torch.core.types import RigidTransform
from goicp_tpu_torch.geo.procrustes import procrustes


@dataclasses.dataclass(frozen=True)
class IcpParams:
    """Solver knobs (same fields as the JAX package's)."""

    max_iter: int = 128          # ref: 1000 initial / 500 refine (fgoicp.cpp:11,77)
    rel_tol: float = 1e-3        # ref convergence_threshold (icp3d.cu:95)
    trim_fraction: float = 0.0   # trimmed ICP: not ported yet (ROADMAP queue 1)
    metric: str = "point"        # "plane": not ported yet (ROADMAP queue 1)


@dataclasses.dataclass(frozen=True)
class IcpResult:
    transform: RigidTransform  # [B,3,3], [B,3]
    sse: Any                   # [B]
    iters: Any                 # [B] int32 iterations actually run


def exact_correspondence(targets) -> Callable:
    """Correspondence closure: exact NN against ``targets [Nt,3]`` through K1
    (its plain version for CPU tensors).  Returns ``(dst, d2)``."""
    from goicp_tpu_torch.nn.fused import nearest_neighbor_mxu

    def corr(pts):
        d2, idx = nearest_neighbor_mxu(pts, targets)
        dst = targets.index_select(0, idx.reshape(-1)).reshape(*idx.shape, 3)
        return dst, d2

    return corr


def _check_params(params: IcpParams):
    if params.trim_fraction > 0.0:
        raise NotImplementedError(
            "trimmed ICP is not ported yet (ROADMAP queue 1, item 7: the "
            "trimmed path)"
        )
    if params.metric != "point":
        raise NotImplementedError(
            f"icp metric {params.metric!r} is not ported yet (ROADMAP queue 1, "
            "item 2: geo/normals.py and the plane metric)"
        )


def run_icp(
    src,
    corr: Callable,
    init: RigidTransform,
    params: IcpParams = IcpParams(),
    active0=None,
) -> IcpResult:
    """Refine a batch of poses with ICP until convergence or ``max_iter``.

    ``src [N,3]``; ``init``: batched ``[B]`` (or single) transforms;
    ``corr(pts [B,N,3]) -> (dst, d2)``; ``active0``: optional ``[B]`` bool —
    poses starting False are never iterated and report ``sse=inf``,
    ``iters=0`` (the round tail's refine gate).  Per-pose convergence:
    relative SSE improvement below ``rel_tol`` (``icp3d.cu:95``).
    ``max_iter=0`` scores the initial poses with one correspondence pass.
    """
    _check_params(params)
    batched = init.t.dim() > 1
    R0 = init.R if batched else init.R[None]
    t0 = init.t if batched else init.t[None]
    B = t0.shape[0]
    dev = t0.device

    def _unbatch(R, t, sse, iters):
        if not batched:
            R, t, sse, iters = R[0], t[0], sse[0], iters[0]
        return IcpResult(RigidTransform(R, t), sse, iters)

    if params.max_iter == 0:
        _, d2 = corr(RigidTransform(R0, t0).apply(src))
        return _unbatch(R0, t0, d2.sum(-1), torch.zeros((B,), dtype=torch.int32, device=dev))

    if active0 is None:
        active = torch.ones((B,), dtype=torch.bool, device=dev)
    else:
        active = torch.as_tensor(active0, device=dev).to(torch.bool).expand(B)
    R_best, t_best = R0, t0
    R_cur, t_cur = R0, t0
    sse_best = torch.full((B,), float("inf"), dtype=torch.float32, device=dev)
    iters = torch.zeros((B,), dtype=torch.int32, device=dev)
    it = 0
    while it < params.max_iter and bool(active.any()):
        pts = RigidTransform(R_cur, t_cur).apply(src)        # [B,N,3]
        dst, d2 = corr(pts)
        sse_cur = d2.sum(-1)
        take = active & (sse_cur < sse_best)
        R_best = torch.where(take[:, None, None], R_cur, R_best)
        t_best = torch.where(take[:, None], t_cur, t_best)
        still = active & (
            sse_best - sse_cur >= params.rel_tol * torch.clamp(sse_cur, min=1e-30)
        )
        sse_best = torch.where(take, sse_cur, sse_best)
        R_d, t_d = procrustes(pts, dst)
        nxt = RigidTransform(R_d, t_d).compose(RigidTransform(R_cur, t_cur))
        R_cur = torch.where(still[:, None, None], nxt.R, R_cur)
        t_cur = torch.where(still[:, None], nxt.t, t_cur)
        iters = iters + active.to(torch.int32)
        active = still
        it += 1
    return _unbatch(R_best, t_best, sse_best, iters)
