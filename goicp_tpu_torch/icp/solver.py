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
are the same as the device loop's: an inactive pose is never updated.  An
iteration is one function that updates the loop's state in place
(:func:`_icp_iteration`); on CUDA the point metric on exact correspondences
captures it once per shape as a CUDA graph and replays it, a few hundred
small kernels for one launch from the host.
"""

from __future__ import annotations

import collections
import dataclasses
import functools
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


class ExactCorrespondence:
    """Correspondence callable: exact NN against ``targets [Nt,3]`` through
    K1 (its plain version for CPU tensors).  ``packed`` is K1's target
    layout (:func:`~goicp_tpu_torch.nn.fused.pack_nn_targets`), made once
    here for CUDA tensors (None on the CPU).  ``corr(pts)`` returns ``(dst,
    d2)``, or ``(dst, nrm, d2)`` with ``normals [Nt,3]`` (the plane-metric
    contract).  :func:`run_icp` reads the fields to replay a captured
    iteration."""

    def __init__(self, targets, normals=None):
        from goicp_tpu_torch.nn.fused import pack_nn_targets

        self.targets = targets
        self.normals = normals
        self.packed = pack_nn_targets(targets) if targets.is_cuda else None

    def __call__(self, pts):
        from goicp_tpu_torch.nn.fused import nearest_neighbor_mxu

        d2, idx = nearest_neighbor_mxu(pts, self.targets, packed=self.packed)
        if self.normals is None:
            return _gather(self.targets, idx), d2
        return _gather(self.targets, idx), _gather(self.normals, idx), d2


def exact_correspondence(targets, normals=None) -> ExactCorrespondence:
    """Exact-NN correspondences against ``targets [Nt,3]``
    (:class:`ExactCorrespondence`)."""
    return ExactCorrespondence(targets, normals)


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


def _weights(d2, pw, tf: float):
    """The step's and the SSE's per-point weights: None (all 1), the point
    weights ``pw``, the trim's 0/1 inliers, or both."""
    if pw is None:
        return trim_weights(d2, tf) if tf > 0.0 else None
    if tf <= 0.0:
        return pw.expand(d2.shape)
    return _trim_weighted(d2, pw, tf)


@dataclasses.dataclass(frozen=True)
class _IcpState:
    """The loop's state, ``[B]`` poses, updated in place by
    :func:`_icp_iteration`.  The point metric's gate is its SSE, so there
    ``gate_best`` is ``sse_best`` itself."""

    R_cur: Any       # [B,3,3]
    t_cur: Any       # [B,3]
    R_best: Any      # [B,3,3]
    t_best: Any      # [B,3]
    sse_best: Any    # [B]
    gate_best: Any   # [B]
    iters: Any       # [B] int32
    active: Any      # [B] bool

    @staticmethod
    def empty(B: int, dev, plane: bool) -> "_IcpState":
        f32 = dict(dtype=torch.float32, device=dev)
        sse = torch.empty((B,), **f32)
        return _IcpState(
            torch.empty((B, 3, 3), **f32), torch.empty((B, 3), **f32),
            torch.empty((B, 3, 3), **f32), torch.empty((B, 3), **f32),
            sse, torch.empty_like(sse) if plane else sse,
            torch.empty((B,), dtype=torch.int32, device=dev),
            torch.empty((B,), dtype=torch.bool, device=dev),
        )

    def fill(self, R0, t0, active0=None):
        """Start from poses ``R0 [B,3,3]``, ``t0 [B,3]``: nothing kept yet,
        no iteration run, ``active0`` (default all) active."""
        for cur, best, x in ((self.R_cur, self.R_best, R0), (self.t_cur, self.t_best, t0)):
            cur.copy_(x)
            best.copy_(x)
        self.sse_best.fill_(float("inf"))
        self.gate_best.fill_(float("inf"))
        self.iters.zero_()
        if active0 is None:
            self.active.fill_(True)
        else:
            self.active.copy_(torch.as_tensor(active0, device=self.active.device)
                              .to(torch.bool).expand(self.active.shape))


def _icp_iteration(st: _IcpState, src, corr: Callable, pw, tf: float, rel_tol: float,
                   plane: bool, record: Optional[list] = None):
    """One ICP iteration of every pose, in place on ``st``: score the
    current poses, keep each pose's best, stop the poses whose gate
    improved by less than ``rel_tol``, step the others.  A pose that is not
    active is left as it is.  This is what a CUDA graph of :func:`run_icp`
    captures; the eager loop runs it too."""
    pts = RigidTransform(st.R_cur, st.t_cur).apply(src)      # [B,N,3]
    dst, nrm, d2 = _split_corr(corr(pts))
    w = _weights(d2, pw, tf)
    sse_cur, gate_cur = _gate(pts, dst, nrm, d2, w, plane)
    if record is not None:
        record.append((st.R_cur.clone(), st.t_cur.clone(), sse_cur, st.active.clone()))
    take = st.active & (sse_cur < st.sse_best)
    still = st.active & (
        st.gate_best - gate_cur >= rel_tol * torch.clamp(gate_cur, min=1e-30)
    )
    st.R_best.copy_(torch.where(take[:, None, None], st.R_cur, st.R_best))
    st.t_best.copy_(torch.where(take[:, None], st.t_cur, st.t_best))
    if plane:
        st.gate_best.copy_(torch.where(st.active & (gate_cur < st.gate_best),
                                       gate_cur, st.gate_best))
    st.sse_best.copy_(torch.where(take, sse_cur, st.sse_best))
    R_d, t_d = _step(pts, dst, nrm, w, plane)
    nxt = RigidTransform(R_d, t_d).compose(RigidTransform(st.R_cur, st.t_cur))
    st.R_cur.copy_(torch.where(still[:, None, None], nxt.R, st.R_cur))
    st.t_cur.copy_(torch.where(still[:, None], nxt.t, st.t_cur))
    st.iters.add_(st.active.to(torch.int32))
    st.active.copy_(still)


def _run_eager(src, corr, R0, t0, params: IcpParams, pw=None, active0=None,
               record: Optional[list] = None):
    """:func:`run_icp`'s loop, one :func:`_icp_iteration` at a time: the
    host reads ``any(active)`` before each.  Returns ``(R_best, t_best,
    sse_best, iters)``."""
    plane = params.metric == "plane"
    st = _IcpState.empty(t0.shape[0], t0.device, plane)
    st.fill(R0, t0, active0)
    it = 0
    while it < params.max_iter and bool(st.active.any()):
        _icp_iteration(st, src, corr, pw, params.trim_fraction, params.rel_tol, plane, record)
        it += 1
    return st.R_best, st.t_best, st.sse_best, st.iters


def _graphable(src, corr, R0, t0, params: IcpParams, pw, record) -> bool:
    """Whether :func:`run_icp` replays a captured iteration: CUDA f32
    tensors on one device, one source for every pose, exact (K1)
    correspondences, the point metric, no point weights, no record.  The
    plane step's solve synchronises, and the other correspondences and
    weights take the eager loop."""
    tensors = (src, R0, t0, corr.targets, corr.packed) \
        if isinstance(corr, ExactCorrespondence) else ()
    return (bool(tensors) and params.metric == "point" and pw is None and record is None
            and src.dim() == 2
            and all(x is not None and x.is_cuda and x.dtype == torch.float32
                    and x.device == src.device for x in tensors))


@dataclasses.dataclass(frozen=True)
class _IcpGraph:
    """A captured :func:`_icp_iteration` and the buffers it reads and
    writes; ``launches``/``shapes``: the kernel launches of one replay, by
    counter and by K1 shape (:mod:`goicp_tpu_torch.nn.fused`)."""

    graph: Any
    src: Any
    corr: ExactCorrespondence
    state: _IcpState
    launches: collections.Counter
    shapes: collections.Counter


def _launch_counts():
    from goicp_tpu_torch.nn import fused

    return collections.Counter(fused.launches), collections.Counter(fused.nn_launch_shapes)


@functools.lru_cache(maxsize=32)
def _icp_graph(index: int, B: int, N: int, Nt: int, tf: float, rel_tol: float) -> _IcpGraph:
    """A CUDA graph of one point-metric iteration of ``B`` poses of ``N``
    points against ``Nt`` targets on device ``index``.  It is warmed up on a
    side stream and captured on buffers of its own, whose values it leaves
    spent; the launch counts of both are taken back out."""
    from goicp_tpu_torch.nn import fused

    with torch.cuda.device(index):
        dev = torch.device("cuda", index)
        src = torch.zeros((N, 3), dtype=torch.float32, device=dev)
        corr = ExactCorrespondence(torch.zeros((Nt, 3), dtype=torch.float32, device=dev))
        st = _IcpState.empty(B, dev, plane=False)
        st.fill(torch.eye(3, device=dev).expand(B, 3, 3), torch.zeros((B, 3), device=dev))
        counts = _launch_counts()
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            _icp_iteration(st, src, corr, None, tf, rel_tol, plane=False)   # warm-up
        torch.cuda.current_stream().wait_stream(side)
        warm = _launch_counts()
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph, capture_error_mode="thread_local"):
            _icp_iteration(st, src, corr, None, tf, rel_tol, plane=False)
        done = _launch_counts()
        fused.launches.update(counts[0])
        fused.nn_launch_shapes.clear()
        fused.nn_launch_shapes.update(counts[1])
        return _IcpGraph(graph, src, corr, st, done[0] - warm[0], done[1] - warm[1])


def _run_graphed(src, corr: ExactCorrespondence, R0, t0, params: IcpParams,
                 active0=None):
    """:func:`_run_eager` of the point metric, each iteration one replay of
    a CUDA graph of :func:`_icp_iteration` (:func:`_icp_graph`): the same
    kernels in the same order, so the same bits.  The results are copied
    out of the graph's buffers, which the next call overwrites."""
    from goicp_tpu_torch.nn import fused

    g = _icp_graph(src.device.index, t0.shape[0], src.shape[0], corr.targets.shape[0],
                   float(params.trim_fraction), float(params.rel_tol))
    g.src.copy_(src)
    g.corr.targets.copy_(corr.targets)
    g.corr.packed.copy_(corr.packed)
    g.state.fill(R0, t0, active0)
    it = 0
    while it < params.max_iter and bool(g.state.active.any()):
        g.graph.replay()
        for k, n in g.launches.items():
            fused.launches[k] += n
        fused.nn_launch_shapes.update(g.shapes)
        it += 1
    st = g.state
    return st.R_best.clone(), st.t_best.clone(), st.sse_best.clone(), st.iters.clone()


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

    On CUDA, a point-metric batch on :class:`ExactCorrespondence` without
    point weights or a record replays each iteration as one CUDA graph
    (:func:`_run_graphed`); every other call runs the same iteration
    eagerly.  Both give the same results.
    """
    _check_metric(params)
    batched = init.t.dim() > 1
    R0 = init.R if batched else init.R[None]
    t0 = init.t if batched else init.t[None]
    B = t0.shape[0]
    dev = t0.device
    pw = None if point_weights is None else torch.as_tensor(
        point_weights, dtype=torch.float32, device=dev)

    if params.max_iter == 0:
        _, _, d2 = _split_corr(corr(RigidTransform(R0, t0).apply(src)))
        R, t = R0, t0
        sse = _sse(d2, _weights(d2, pw, params.trim_fraction))
        iters = torch.zeros((B,), dtype=torch.int32, device=dev)
    else:
        R, t, sse, iters = (_run_graphed(src, corr, R0, t0, params, active0)
                            if _graphable(src, corr, R0, t0, params, pw, record)
                            else _run_eager(src, corr, R0, t0, params, pw, active0, record))
    if not batched:
        R, t, sse, iters = R[0], t[0], sse[0], iters[0]
    return IcpResult(RigidTransform(R, t), sse, iters)


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
