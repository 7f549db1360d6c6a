"""Batched multi-pair registration (port of the JAX package's ``multipair.py``).

- :func:`icp_pairs` refines one pose per pair, all pairs in one batched ICP
  with per-pair padded clouds;
- :func:`register_pairs` runs the certified Go-ICP of every pair: the
  lockstep driver (:mod:`goicp_tpu_torch.multipair_lockstep`) advances all
  pairs through one round at a time (its pairs split over a pair-axis
  mesh's devices with ``mesh=``), and configurations it does not cover
  solve pair by pair on the single-pair solver;
- :func:`register_pairs_distributed` splits the pairs round-robin over the
  processes of a ``torch.distributed`` group, each solving its slice with
  collective-free solvers, and one all-gather gives every process the
  whole result list.

Correspondences go through K1 (:func:`goicp_tpu_torch.nn.fused.nearest_neighbor_mxu`):
one launch per ICP iteration for all poses whose pairs share one target
object (the serving shape), one per distinct target otherwise.
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from goicp_tpu_torch.bnb import BnbParams, GoIcpResult, make_solver
from goicp_tpu_torch.bnb.params import auto_backend
from goicp_tpu_torch.core.device import resolve_device, to_device
from goicp_tpu_torch.core.logging import get_logger
from goicp_tpu_torch.core.metrics import Metrics
from goicp_tpu_torch.core.types import RigidTransform
from goicp_tpu_torch.icp import IcpParams, exact_correspondence, run_icp


def _pair_normals(normals, pairs) -> Optional[list]:
    """Per-pair target normals from None, one shared ``[Nt,3]`` array (the
    serving shape) or a per-pair sequence: a list with one array per pair,
    the same object wherever the spec shares one (``_pad_pair_normals``,
    ``multipair.py:42``, without its padding: each pair keeps its own
    target here).  An array shorter than its pair's target raises: it would
    give real target points a dummy normal, a wrong plane objective with no
    error."""
    if normals is None:
        return None
    B = len(pairs)
    if isinstance(normals, (list, tuple)):
        if len(normals) != B:
            raise ValueError(
                f"need one normals array per pair: {len(normals)} != {B}"
            )
        per = list(normals)
    else:
        per = [normals] * B
    for b, (nb, (_, t)) in enumerate(zip(per, pairs)):
        if np.shape(nb)[0] < t.shape[0]:
            raise ValueError(
                f"pair {b}: normals cover {np.shape(nb)[0]} of {t.shape[0]} target points"
            )
    return per


class PairTargets:
    """The distinct targets of a batch of pairs on the device, and the pair
    → target map: pairs whose target (and normals) are one array object
    share one entry, so their poses share one K1 launch per ICP iteration.
    ``normals``: None or one array per pair (:func:`_pair_normals`)."""

    def __init__(self, targets: Sequence[np.ndarray], device, normals=None):
        self.device = device
        keys, self.tgts, self.nrms, group = {}, [], [], []
        for b, t in enumerate(targets):
            nb = None if normals is None else normals[b]
            key = (id(t), id(nb))
            if key not in keys:
                keys[key] = len(self.tgts)
                self.tgts.append(to_device(np.asarray(t, np.float32), device))
                self.nrms.append(None if nb is None else to_device(nb, device)[: t.shape[0]])
            group.append(keys[key])
        self.group = np.asarray(group, np.int64)          # [P] target of each pair
        # one pair's correspondence (``_pair_corr``, multipair.py:133): K1
        # against its target, packed once
        self.corrs = [exact_correspondence(t, normals=n) for t, n in zip(self.tgts, self.nrms)]

    def corr(self, pair_of_pose: np.ndarray):
        """Correspondence closure for a batch of poses ``[B]``, pose ``b``
        on pair ``pair_of_pose[b]``'s target: one K1 launch per distinct
        target among them."""
        g = self.group[pair_of_pose]
        uniq = np.unique(g)
        if uniq.size == 1:
            return self.corrs[int(uniq[0])]
        sel = [torch.as_tensor(np.flatnonzero(g == u), device=self.device) for u in uniq]

        def corr(pts):
            outs = [self.corrs[int(u)](pts.index_select(0, s)) for u, s in zip(uniq, sel)]
            res = []
            for k in range(len(outs[0])):
                x = outs[0][k]
                buf = x.new_empty((pts.shape[0], *x.shape[1:]))
                for o, s in zip(outs, sel):
                    buf.index_copy_(0, s, o[k])
                res.append(buf)
            return tuple(res)

        return corr


def _pad_sources(sources: Sequence[np.ndarray], n_src: int):
    """Sources zero-padded to ``[B, n_src, 3]`` and their 0/1 weights."""
    srcs = np.zeros((len(sources), n_src, 3), np.float32)
    w = np.zeros((len(sources), n_src), np.float32)
    for b, s in enumerate(sources):
        srcs[b, : s.shape[0]] = s
        w[b, : s.shape[0]] = 1.0
    return srcs, w


def icp_pairs(
    pairs: Sequence[Tuple[np.ndarray, np.ndarray]],
    inits: Optional[RigidTransform] = None,
    params: IcpParams = IcpParams(),
    normals=None,
    pad_src_to: Optional[int] = None,
    device=None,
):
    """Refine one pose per pair, all pairs in one batched ICP
    (``multipair.py:82``).  Sources are zero-padded to the largest (or to
    ``pad_src_to``) with weight 0, so padding leaves the step and the SSE;
    each pair keeps its own target.  ``normals``: target normals for
    ``params.metric == "plane"`` (see :func:`_pair_normals`).  Returns
    ``(transforms [B], sse [B], iters [B])`` as tensors on the device."""
    dev = resolve_device(device)
    B = len(pairs)
    if B == 0:
        z = torch.zeros((0,), dtype=torch.float32, device=dev)
        return RigidTransform.identity((0,), device=dev), z, z.to(torch.int32)
    n_src = max(p[0].shape[0] for p in pairs)
    if pad_src_to is not None:
        n_src = max(n_src, pad_src_to)
    srcs, w = _pad_sources([s for s, _ in pairs], n_src)
    # normals only matter to the plane metric
    nrm = _pair_normals(normals, pairs) if params.metric == "plane" else None
    targets = PairTargets([t for _, t in pairs], dev, nrm)
    if inits is None:
        T0 = RigidTransform.identity((B,), device=dev)
    else:
        T0 = RigidTransform(to_device(inits.R, dev), to_device(inits.t, dev))
    return _icp_pairs_run(to_device(srcs, dev), targets, to_device(w, dev), T0, params)


def _icp_pairs_run(srcs, targets: "PairTargets", w, T0: RigidTransform, params: IcpParams,
                   pair_of_pose: Optional[np.ndarray] = None, active0=None):
    """Batched ICP of poses ``[B]``, pose ``b`` on its pair's source
    ``srcs [B,N,3]``, weights ``w [B,N]`` and target (``pair_of_pose``,
    default ``b``): the plain form of the JAX package's ``_icp_pairs_jit``
    (``multipair.py:148``), whose ``vmap`` over pairs of a ``while_loop``
    is one masked loop over all poses here."""
    if pair_of_pose is None:
        pair_of_pose = np.arange(srcs.shape[0])
    res = run_icp(srcs, targets.corr(pair_of_pose), T0, params, point_weights=w,
                  active0=active0)
    return res.transform, res.sse, res.iters


def register_pairs(
    pairs: Sequence[Tuple[np.ndarray, np.ndarray]],
    params: BnbParams = BnbParams(),
    batched: bool = True,
    mesh=None,
    local: bool = False,
    solver_grid=None,
    tgt_normals=None,
    inits: Optional[Sequence[Optional[RigidTransform]]] = None,
    pad_src_to: Optional[int] = None,
    device=None,
) -> List[GoIcpResult]:
    """Globally-optimal registration of every pair (``multipair.py:159``).

    ``batched=True`` (default) runs every pair's BnB in lockstep: one round
    advances all pairs (``multipair_lockstep._pairs_round``), trimmed or
    not, on either rotation parametrization, point or plane metric.
    Configurations outside the lockstep (targets above the fused-bound
    cutoff, the nested engine, checkpoints, span floors) solve pair by pair
    on the single-pair solver, with a log line.  ``solver_grid``: a distance
    grid of the shared target (every pair has the same target), reused by
    those solvers.  ``tgt_normals``: target normals for
    ``icp_metric="plane"`` (one shared array or one per pair; None =
    estimated per distinct target).  ``inits``: per-pair prior poses,
    pinned as multistart seeds — the solve stays globally optimal.
    ``mesh``: a single-axis :class:`~goicp_tpu_torch.dist.sharding.Mesh`
    over which the lockstep splits its pairs.  ``local``: the per-pair
    solvers stay collective-free under a process group (work already split
    between processes)."""
    from goicp_tpu_torch import multipair_lockstep

    p = params
    lockstep_ok = (
        batched
        and len(pairs) >= 2
        and lockstep_compatible(
            p,
            max(s.shape[0] for s, _ in pairs),
            max(t.shape[0] for _, t in pairs),
        )
    )
    if lockstep_ok:
        return multipair_lockstep._register_pairs_lockstep(
            pairs, p, mesh=mesh, tgt_normals=tgt_normals, inits=inits,
            pad_src_to=pad_src_to, device=device,
        )
    if batched and len(pairs) >= 2:
        get_logger().info(
            "multipair batch of %d runs per-pair solvers (config outside "
            "the lockstep driver: engine=%s backend=%s checkpoint=%s "
            "floors=%g/%g, or target beyond the exact-bound cutoff)",
            len(pairs), p.engine, p.bound_backend, bool(p.checkpoint_path),
            p.min_rot_span, p.min_trans_span,
        )

    def _nrm(i):
        if tgt_normals is None or p.icp_metric != "plane":
            return None
        if isinstance(tgt_normals, (list, tuple)):
            return tgt_normals[i]
        return tgt_normals

    return [
        make_solver(
            s, t, params, grid=solver_grid, normals=_nrm(i), device=device, local=local,
        ).run(None if inits is None else inits[i])
        for i, (s, t) in enumerate(pairs)
    ]


def lockstep_compatible(p: BnbParams, n_src: int, n_tgt: int) -> bool:
    """True when the lockstep driver covers this configuration
    (``multipair.py:240``): the fused bounds' target cutoff of the "auto"
    backend (``bnb.params.auto_backend``), the whole source within
    ``bound_points``, the SE(3) engine, no grid backend, no checkpoints,
    no span floors."""
    return (
        auto_backend(p, n_tgt) != "grid"
        and n_src <= p.bound_points
        and p.engine == "se3"
        and p.bound_backend != "grid"
        and not p.checkpoint_path
        and p.min_rot_span == 0.0
        and p.min_trans_span == 0.0
    )


_COUNT_BASE = 1 << 20   # counters ride the f32 record as (hi, lo) base-2^20 pairs


def register_pairs_distributed(
    pairs: Sequence[Tuple[np.ndarray, np.ndarray]],
    params: BnbParams = BnbParams(),
    batched: bool = True,
    mesh=None,
    tgt_normals=None,
    inits: Optional[Sequence[Optional[RigidTransform]]] = None,
    device=None,
) -> List[GoIcpResult]:
    """Every pair's globally-optimal registration, the pairs split over the
    processes of the default ``torch.distributed`` group
    (``multipair.py:283``).  Process ``i`` solves ``pairs[i::P]`` with
    :func:`register_pairs` (``local=True``: no collectives inside), on
    ``cuda:{i % device_count}`` by default, then one all-gather of a
    25-float record per pair gives every process the whole list.
    ``GoIcpResult.metrics`` is filled only for the pairs solved here.
    Without a group of more than one process this is
    :func:`register_pairs`."""
    from goicp_tpu_torch.dist.multihost import allgather_np, rank_and_size, rank_device

    pid, P = rank_and_size()
    if P <= 1:
        return register_pairs(pairs, params, batched=batched, mesh=mesh,
                              tgt_normals=tgt_normals, inits=inits, device=device)
    n = len(pairs)
    mine = list(range(pid, n, P))
    local = register_pairs(
        [pairs[i] for i in mine], params, batched=batched, local=True, mesh=mesh,
        tgt_normals=([tgt_normals[i] for i in mine]
                     if isinstance(tgt_normals, (list, tuple)) else tgt_normals),
        inits=None if inits is None else [inits[i] for i in mine],
        device=rank_device(device),
    ) if mine else []

    # [R 9 | t 3 | sse mse converged gap wall | rot_nodes trans_nodes
    # icp_iters rounds as (hi, lo) pairs]: counters exact through 2^40
    def enc(v: int):
        return float(v // _COUNT_BASE), float(v % _COUNT_BASE)

    per = -(-n // P)
    buf = np.full((per, 25), np.nan, np.float32)
    for row, res in enumerate(local):
        buf[row, 0:9] = np.asarray(res.transform.R, np.float32).reshape(9)
        buf[row, 9:12] = np.asarray(res.transform.t, np.float32)
        buf[row, 12:17] = (res.sse, res.mse, float(res.converged), res.gap, res.wall_s)
        buf[row, 17:25] = (*enc(res.rot_nodes), *enc(res.trans_nodes),
                           *enc(res.icp_iters), *enc(res.rounds))
    allb = allgather_np(buf)                                # [P, per, 25]

    results: List[Optional[GoIcpResult]] = [None] * n
    for row, i in enumerate(mine):
        results[i] = local[row]
    for src_pid in range(P):
        if src_pid == pid:
            continue
        for row, i in enumerate(range(src_pid, n, P)):
            r = allb[src_pid, row]

            def dec(k):
                return int(r[k]) * _COUNT_BASE + int(r[k + 1])

            results[i] = GoIcpResult(
                transform=RigidTransform(r[0:9].reshape(3, 3).astype(np.float32),
                                         r[9:12].astype(np.float32)),
                sse=float(r[12]), mse=float(r[13]), converged=bool(r[14] > 0.5),
                gap=float(r[15]), rot_nodes=dec(17), trans_nodes=dec(19),
                icp_iters=dec(21), rounds=dec(23), wall_s=float(r[16]), metrics=Metrics(),
            )
    return results
