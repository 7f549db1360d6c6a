"""Batched ICP — the local refiner of every solver mode (port of the JAX
package's ``icp/solver.py``: point and plane metrics, exact or grid
correspondences, plain or trimmed).

One masked loop refines a batch ``[B]`` of poses together; the point
metric's step is Horn's quaternion Procrustes
(:mod:`goicp_tpu_torch.geo.procrustes`), the plane metric's a damped
Gauss-Newton step on the 6-DoF twist (:func:`_plane_update`).
Correspondences come from the exact nearest-neighbour kernel K1
(:func:`goicp_tpu_torch.nn.fused.nearest_neighbor_mxu`) or from the index
field of a distance grid (:func:`grid_correspondence`).  The reported and
best-tracked SSE is the point-to-point (trimmed) SSE in both metrics, so
mse thresholds and BnB incumbents do not depend on the metric; the plane
metric changes only the step and the convergence gate.

The JAX version is a ``lax.while_loop`` that stops when no pose is active.
Here the host tests ``any(active)`` before every iteration, which reads one
flag from the device and so waits for the work queued before it.  Results
are the same as the device loop's: an inactive pose is never updated.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Optional

import torch

from goicp_tpu_torch.core.types import RigidTransform
from goicp_tpu_torch.geo.procrustes import procrustes
from goicp_tpu_torch.geo.rotation import axis_angle_rotation
from goicp_tpu_torch.nn.fused import _sq3
from goicp_tpu_torch.nn.grid import DistanceGrid, lookup_index


@dataclasses.dataclass(frozen=True)
class IcpParams:
    """Solver knobs (same fields as the JAX package's)."""

    max_iter: int = 128          # ref: 1000 initial / 500 refine (fgoicp.cpp:11,77)
    rel_tol: float = 1e-3        # ref convergence_threshold (icp3d.cu:95)
    trim_fraction: float = 0.0   # keep the n(1 − trim) closest pairs per pose
    metric: str = "point"        # "point" (ref parity) | "plane" (point-to-plane)


@dataclasses.dataclass(frozen=True)
class IcpResult:
    transform: RigidTransform  # [B,3,3], [B,3]
    sse: Any                   # [B]
    iters: Any                 # [B] int32 iterations actually run


def _gather(rows, idx):
    """``rows[idx]`` for ``idx`` of any shape: ``[..., 3]``."""
    return rows.index_select(0, idx.reshape(-1)).reshape(*idx.shape, 3)


def exact_correspondence(targets, normals=None) -> Callable:
    """Correspondence closure: exact NN against ``targets [Nt,3]`` through K1
    (its plain version for CPU tensors), whose target layout is packed once
    here for CUDA tensors.  Returns ``(dst, d2)``, or ``(dst, nrm, d2)``
    with ``normals [Nt,3]`` (the plane-metric contract)."""
    from goicp_tpu_torch.nn.fused import nearest_neighbor_mxu, pack_nn_targets

    packed = pack_nn_targets(targets) if targets.is_cuda else None

    def corr(pts):
        d2, idx = nearest_neighbor_mxu(pts, targets, packed=packed)
        if normals is None:
            return _gather(targets, idx), d2
        return _gather(targets, idx), _gather(normals, idx), d2

    return corr


def grid_correspondence(grid: DistanceGrid, targets, normals=None) -> Callable:
    """Correspondence closure: O(1) grid index lookup (the grid needs
    ``with_index``), ``icp/solver.py:116``.  Returns ``(dst, d2)``, or
    ``(dst, nrm, d2)`` with ``normals [Nt,3]``."""

    def corr(pts):
        idx = lookup_index(grid, pts)
        dst = _gather(targets, idx)
        d2 = _sq3(pts - dst)
        if normals is None:
            return dst, d2
        return dst, _gather(normals, idx), d2

    return corr


def _split_corr(out):
    """Normalize a correspondence result to ``(dst, nrm_or_None, d2)``."""
    if len(out) == 3:
        return out
    dst, d2 = out
    return dst, None, d2


def _plane_update(pts, dst, nrm, w):
    """One damped Gauss-Newton step of the point-to-plane metric
    (``icp/solver.py:143``).

    Minimizes ``sum_i w_i ((R pts_i + t - dst_i) . nrm_i)^2`` linearized at
    identity (small-angle twist ``x = (omega, t)``); returns ``(R_d, t_d)``
    to compose on top of the current transform, as :func:`procrustes` does.
    Tikhonov damping (1e-6 · mean diag) keeps rank-deficient systems
    (planar targets) finite.  Shapes: ``pts/dst/nrm [...,N,3]``, ``w
    [...,N]`` or None.  The batched 6x6 solves run in f32 (TF32 is off for
    the package).
    """
    r = ((pts - dst) * nrm).sum(-1)                             # [...,N]
    a = torch.linalg.cross(pts, nrm)                            # [...,N,3]
    J = torch.cat([a, nrm], dim=-1)                             # [...,N,6]
    Jw = J if w is None else J * w[..., None]
    H = Jw.transpose(-1, -2) @ J                                # [...,6,6]
    g = (Jw.transpose(-1, -2) @ r[..., None])[..., 0]           # [...,6]
    damp = 1e-6 * (torch.diagonal(H, dim1=-2, dim2=-1).sum(-1) / 6.0 + 1e-12)
    Hd = H + damp[..., None, None] * torch.eye(6, dtype=H.dtype, device=H.device)
    x = -torch.linalg.solve(Hd, g[..., None])[..., 0]           # [...,6]
    return axis_angle_rotation(x[..., :3]), x[..., 3:]


def _need_normals(nrm):
    if nrm is None:
        raise ValueError(
            "metric='plane' needs a correspondence closure built with normals= "
            "(see exact_correspondence/grid_correspondence)"
        )


def trim_weights(d2, trim_fraction: float):
    """0/1 inlier weights keeping the ``n(1 − trim)`` closest pairs per pose
    (``icp/solver.py:172``): ``d2 [..., N]``, threshold the k-th smallest
    distance, so ties at it can admit more than k points."""
    n = d2.shape[-1]
    k = max(1, int(round(n * (1.0 - trim_fraction))))
    if k >= n:
        return torch.ones_like(d2)
    kth = torch.kthvalue(d2, k, dim=-1, keepdim=True).values
    return (d2 <= kth).to(d2.dtype)


def _trim_weighted(d2, pw, trim_fraction: float):
    """Trim weights under point weights ``pw`` (``icp/solver.py:200-210``):
    weight-0 points sit at +inf, so they take no inlier slot, and each
    pose keeps the ``round(count·(1 − trim))`` closest of its weighted
    points, ties at the threshold included."""
    masked = torch.where(pw > 0, d2, torch.full_like(d2, float("inf")))
    cnt = (pw > 0).to(torch.float32).sum(-1).expand(d2.shape[:-1])
    k = torch.clamp(torch.round(cnt * (1.0 - trim_fraction)).to(torch.int64), min=1)
    kth = torch.sort(masked, dim=-1).values.gather(-1, (k - 1)[..., None])
    return (masked <= kth).to(d2.dtype) * pw


def sse_of_distances(d2, trim_fraction: float = 0.0):
    """(Trimmed) SSE from per-point squared distances ``[..., N]``."""
    if trim_fraction > 0.0:
        return (d2 * trim_weights(d2, trim_fraction)).sum(-1)
    return d2.sum(-1)


def _check_metric(params: IcpParams):
    if params.metric not in ("point", "plane"):
        raise ValueError(f"unknown IcpParams.metric {params.metric!r}")


def _sse(d2, w):
    return d2.sum(-1) if w is None else (d2 * w).sum(-1)


def _step(pts, dst, nrm, w, plane: bool):
    """The pose update of one iteration, ``(R_d, t_d)``."""
    if plane:
        return _plane_update(pts, dst, nrm, w)
    return procrustes(pts, dst, weights=w)


def _gate(pts, dst, nrm, d2, w, plane: bool):
    """Point SSE, and the convergence gate: the point SSE for the point
    metric, the plane SSE for the plane metric (plane steps may raise the
    point SSE for a while as they descend their own objective)."""
    sse = _sse(d2, w)
    if not plane:
        return sse, sse
    _need_normals(nrm)
    r = ((pts - dst) * nrm).sum(-1)
    return sse, _sse(r * r, w)


def run_icp(
    src,
    corr: Callable,
    init: RigidTransform,
    params: IcpParams = IcpParams(),
    point_weights=None,
    active0=None,
    record: Optional[list] = None,
) -> IcpResult:
    """Refine a batch of poses with ICP until convergence or ``max_iter``.

    ``src [N,3]``, or ``[B,N,3]``: one source per pose (the lockstep
    multipair refines each pair's poses against that pair's source, as the
    JAX package's ``vmap`` over pairs does); ``init``: batched ``[B]`` (or
    single) transforms; ``corr(pts [B,N,3]) -> (dst, d2)`` or ``(dst, nrm,
    d2)`` (needed by the plane metric); ``point_weights``: optional ``[N]``
    or ``[B,N]`` weights, whose 0 entries (padding) leave both the step and
    the SSE (``icp/solver.py:196-210``); ``active0``: optional ``[B]`` bool —
    poses starting False are never iterated and report ``sse=inf``,
    ``iters=0`` (the round tail's refine gate).  Per-pose convergence:
    relative improvement of the gate below ``rel_tol`` (``icp3d.cu:95``); a
    pose that has stopped keeps its pose and count while others iterate.
    ``max_iter=0`` scores the initial poses with one correspondence pass.
    With ``trim_fraction > 0`` the SSE and the step weigh only each pose's
    ``n(1 − trim)`` closest pairs (:func:`trim_weights`; with weights, ``n``
    counts the weighted points, and padding never takes an inlier slot).
    ``record``: a list that gets one ``(R [B,3,3], t [B,3], sse [B], active
    [B])`` row per iteration run, the poses visited and their point SSE
    (:func:`run_icp_trace` reads it).
    """
    _check_metric(params)
    plane = params.metric == "plane"
    batched = init.t.dim() > 1
    R0 = init.R if batched else init.R[None]
    t0 = init.t if batched else init.t[None]
    B = t0.shape[0]
    dev = t0.device

    tf = params.trim_fraction
    pw = None if point_weights is None else torch.as_tensor(
        point_weights, dtype=torch.float32, device=dev)

    def _unbatch(R, t, sse, iters):
        if not batched:
            R, t, sse, iters = R[0], t[0], sse[0], iters[0]
        return IcpResult(RigidTransform(R, t), sse, iters)

    def _weights(d2):
        if pw is None:
            return trim_weights(d2, tf) if tf > 0.0 else None
        if tf <= 0.0:
            return pw.expand(d2.shape)
        return _trim_weighted(d2, pw, tf)

    if params.max_iter == 0:
        _, _, d2 = _split_corr(corr(RigidTransform(R0, t0).apply(src)))
        return _unbatch(R0, t0, _sse(d2, _weights(d2)),
                        torch.zeros((B,), dtype=torch.int32, device=dev))

    if active0 is None:
        active = torch.ones((B,), dtype=torch.bool, device=dev)
    else:
        active = torch.as_tensor(active0, device=dev).to(torch.bool).expand(B)
    R_best, t_best = R0, t0
    R_cur, t_cur = R0, t0
    sse_best = torch.full((B,), float("inf"), dtype=torch.float32, device=dev)
    gate_best = sse_best
    iters = torch.zeros((B,), dtype=torch.int32, device=dev)
    it = 0
    while it < params.max_iter and bool(active.any()):
        pts = RigidTransform(R_cur, t_cur).apply(src)        # [B,N,3]
        dst, nrm, d2 = _split_corr(corr(pts))
        w = _weights(d2)
        sse_cur, gate_cur = _gate(pts, dst, nrm, d2, w, plane)
        if record is not None:
            record.append((R_cur, t_cur, sse_cur, active))
        take = active & (sse_cur < sse_best)
        R_best = torch.where(take[:, None, None], R_cur, R_best)
        t_best = torch.where(take[:, None], t_cur, t_best)
        still = active & (
            gate_best - gate_cur >= params.rel_tol * torch.clamp(gate_cur, min=1e-30)
        )
        sse_best = torch.where(take, sse_cur, sse_best)
        # the point metric's gate is its sse, whose best ``take`` just kept
        gate_best = (torch.where(active & (gate_cur < gate_best), gate_cur, gate_best)
                     if plane else sse_best)
        R_d, t_d = _step(pts, dst, nrm, w, plane)
        nxt = RigidTransform(R_d, t_d).compose(RigidTransform(R_cur, t_cur))
        R_cur = torch.where(still[:, None, None], nxt.R, R_cur)
        t_cur = torch.where(still[:, None], nxt.t, t_cur)
        iters = iters + active.to(torch.int32)
        active = still
        it += 1
    return _unbatch(R_best, t_best, sse_best, iters)


def run_icp_trace(
    src,
    corr: Callable,
    init: RigidTransform,
    params: IcpParams = IcpParams(),
):
    """:func:`run_icp` of one (unbatched) pose that also returns the visited
    pose and SSE of every iteration (``icp/solver.py:347``): the
    artifact-producing form of the reference's per-frame ICP modes.

    Returns ``(IcpResult, trace)`` with ``trace = (R [T,3,3], t [T,3],
    sse [T], active [T])`` over ``T = max(max_iter, 1)`` rows, as the JAX
    package's fixed-length scan gives them: after convergence the rows
    repeat the last visited pose with the best sse and ``active`` False.
    """
    rows = []
    res = run_icp(src, corr, init, params, record=rows)
    if not rows:                       # max_iter = 0: the initial pose, scored
        rows = [(init.R[None], init.t[None], res.sse[None],
                 torch.zeros((1,), dtype=torch.bool, device=res.sse.device))]
    R_tr, t_tr, sse_tr, act = (torch.cat(x) for x in zip(*rows))
    frozen = max(params.max_iter, 1) - len(rows)
    if frozen:
        R_tr = torch.cat([R_tr, R_tr[-1:].expand(frozen, 3, 3)])
        t_tr = torch.cat([t_tr, t_tr[-1:].expand(frozen, 3)])
        sse_tr = torch.cat([sse_tr, res.sse.reshape(1).expand(frozen)])
        act = torch.cat([act, act.new_zeros(frozen)])
    return res, (R_tr, t_tr, sse_tr, act)
