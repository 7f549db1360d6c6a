"""Lockstep multi-pair Go-ICP (port of the JAX package's
``multipair_lockstep.py``): every pair's BnB advances through one round at
a time.

Per round, each live pair pops its best nodes and expands them on the host;
the bounds of all pairs' children are evaluated (:func:`_pairs_bounds`), and
one batched ICP refines every pair's top-k candidates (:func:`_pairs_refine`,
K1, one launch an iteration for pairs sharing a target).  Which distance
form runs follows the JAX package (``use_kernel = _on_tpu() and mesh is
None``, ``multipair_lockstep.py:433``): on a CUDA device each live pair's
per-point distances come from K4 (:func:`_bounds_one_pair_mxu`, one launch
a pair), on the CPU from the exact expansion (:func:`_bounds_one_pair`),
whose node counts equal the JAX package's CPU path.  The epilogue sums in
XLA's order and takes glibc's sine (:func:`_deflate_pair`), so ub and lb
are the same bits on the card and the CPU, and the JAX package's on its
CPU.  Rotation angles are the host's ``rotparam.max_angle``: the lockstep
has no center-aware bound.

A pair-axis mesh (``register_pairs(mesh=…)``, any single-axis
:class:`~goicp_tpu_torch.dist.sharding.Mesh`) splits the pairs into equal
contiguous groups, one per mesh device, each group's bounds and refine on
its device end to end with no collectives (``multipair_lockstep.py:407``);
every pair takes the same steps as unsharded.
"""

from __future__ import annotations

import dataclasses
import math
import time
from collections import deque
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from goicp_tpu_torch.bnb import BnbParams, GoIcpResult
from goicp_tpu_torch.bnb.frontier import make_frontier
from goicp_tpu_torch.bnb.rotparam import _PARAMS
from goicp_tpu_torch.bnb.rounds import _OCTANTS
from goicp_tpu_torch.bnb.se3_eval import _exact_min_d2, _target_tiles
from goicp_tpu_torch.bnb.split import classify_split
from goicp_tpu_torch.core.device import resolve_device, to_device
from goicp_tpu_torch.core.metrics import Metrics
from goicp_tpu_torch.core.types import RigidTransform
from goicp_tpu_torch.dist.sharding import on_device
from goicp_tpu_torch.geo.normals import estimate_normals
from goicp_tpu_torch.geo.rotation import deflation_factor, random_rotations
from goicp_tpu_torch.icp import IcpParams
from goicp_tpu_torch.multipair import PairTargets, _icp_pairs_run, _pad_sources, _pair_normals
from goicp_tpu_torch.nn import fused

_SQRT3 = float(np.sqrt(3.0))
_INF = float("inf")


def _deflate_pair(d2, w, norms, slack: float, af, t_s, mask, h: int, trim: bool):
    """Per-pair bound epilogue (``multipair_lockstep.py:76``): Yang et al.
    eq. 10 deflation of exact per-point distances ``d2 [M, Np]`` by
    ``af [M]`` (:func:`~goicp_tpu_torch.geo.rotation.deflation_factor`)
    and the translation corner radius, then weighted sums in XLA's order (:func:`~goicp_tpu_torch.nn.fused.ordered_row_sum`),
    or trimmed sums over the ``h`` smallest terms by the bisection, its sum
    ordered likewise.  Padded points carry weight 0 (untrimmed) or +inf
    (trimmed), so they neither add nor take inlier slots."""
    Np = d2.shape[1]
    wp = torch.nn.functional.pad(w, (0, Np - w.shape[0]))
    norms_p = torch.nn.functional.pad(norms, (0, Np - norms.shape[0]))
    d = fused.sqrt_rn(torch.clamp(d2, min=0.0))
    gamma_t = (_SQRT3 * t_s)[:, None]
    u = d + slack
    u = u * u
    # max(d − slack, 0) − af·‖p‖ as one fused multiply-add, as XLA's CPU
    # build contracts it here
    d_lo = torch.clamp(d - slack, min=0.0)
    c = fused.fma(-af[:, None].expand_as(d_lo), norms_p[None, :].expand_as(d_lo), d_lo)
    c = torch.clamp(c - gamma_t, min=0.0)
    lo = c * c
    if trim:
        pad_inf = torch.where(wp > 0, 0.0, _INF)[None, :]
        ub = fused.trimmed_sum_bisect(u + pad_inf, h, upper=True, ordered=True)
        lb = fused.trimmed_sum_bisect(lo + pad_inf, h, upper=False, ordered=True)
    else:
        ub = fused.ordered_row_sum(u * wp[None, :])
        lb = fused.ordered_row_sum(lo * wp[None, :])
    inf = torch.full_like(ub, _INF)
    return torch.where(mask, ub, inf), torch.where(mask, lb, inf)


def _bounds_one_pair(src, w, norms, tgt, slack, R, ang, t_c, t_s, mask, h, trim: bool):
    """(ub, lb) of ``M`` SE(3) nodes of one pair on the exact expansion
    (``multipair_lockstep.py:49``, ``bnb/se3_eval.py:_exact_min_d2``),
    per-point weights ``w`` (0 = padding).  ``trim``: sums over the ``h``
    smallest per-point terms."""
    tiles, tile_norms = _target_tiles(tgt, 256)
    pts = src[None] @ R.transpose(-1, -2) + t_c[:, None, :]          # [M,N,3]
    d2 = _exact_min_d2(pts, tiles, tile_norms)
    return _deflate_pair(d2, w, norms, slack, deflation_factor(ang), t_s, mask, h, trim)


def _bounds_one_pair_mxu(src, w, norms, tgt, slack, R, ang, t_c, t_s, mask, h, trim: bool,
                         packed=None):
    """The K4 form of :func:`_bounds_one_pair` (``multipair_lockstep.py:102``):
    per-point distances from :func:`~goicp_tpu_torch.nn.fused.min_d2_nodes`
    (K4; its plain version on the CPU), then the same epilogue.
    ``packed``: ``(srcT, wm)`` of ``src`` and ``tgt``, packed once by a
    caller that evaluates the pair every round."""
    srcT, wm = packed or (fused.pack_sources(src), fused.pack_targets(tgt))
    d2 = fused.min_d2_nodes(srcT, wm, fused.pack_params(R, t_c))     # [M, Np]
    return _deflate_pair(d2, w, norms, slack, deflation_factor(ang), t_s, mask, h, trim)


class _PairBatch:
    """One lockstep batch's per-pair data on the device: sources zero-padded
    to ``N`` points ``[P,N,3]``, their weights and norms ``[P,N]`` (the
    norms by numpy on the host, as the JAX package takes them), the distinct
    targets (:class:`~goicp_tpu_torch.multipair.PairTargets`), and K4's
    packed sources and targets."""

    def __init__(self, pairs, N: int, device, normals=None):
        srcs, wts = _pad_sources([s for s, _ in pairs], N)
        self.device = device
        self.P, self.N = len(pairs), N
        self.srcs = to_device(srcs, device)
        self.wts = to_device(wts, device)
        self.norms = to_device(np.linalg.norm(srcs, axis=-1).astype(np.float32), device)
        self.targets = PairTargets([t for _, t in pairs], device, normals)
        self._packed = None

    def tgt(self, b: int):
        return self.targets.tgts[self.targets.group[b]]

    def packed(self, b: int):
        if self._packed is None:
            wm = [fused.pack_targets(t) for t in self.targets.tgts]
            self._packed = [(fused.pack_sources(self.srcs[i]), wm[self.targets.group[i]])
                            for i in range(self.P)]
        return self._packed[b]


def _pairs_bounds(pairs: _PairBatch, slack, R, ang, t_c, t_s, mask, h, *, trim: bool,
                  use_kernel: bool):
    """Bounds of every pair's jobs ``[P, Mb]`` (the first half of
    ``_pairs_round``): host arrays in, ``(ub, lb, R, t_c)`` on the device
    out.  A pair with no live job is not evaluated (+inf, as its mask gives);
    a live one is evaluated up to its last live job, by
    :func:`_bounds_one_pair_mxu` (one K4 launch, ``use_kernel``) or
    :func:`_bounds_one_pair`.  ``h [P]``: inlier counts."""
    dev = pairs.device
    P, Mb = mask.shape
    R_d, t_d = to_device(R, dev), to_device(t_c, dev)
    ang_d, ts_d = to_device(ang, dev), to_device(t_s, dev)
    mask_d = to_device(mask, dev, torch.bool)
    ub = torch.full((P, Mb), _INF, dtype=torch.float32, device=dev)
    lb = torch.full((P, Mb), _INF, dtype=torch.float32, device=dev)
    for b in range(P):
        live = np.flatnonzero(mask[b])
        if not live.size:
            continue
        C = int(live[-1]) + 1
        args = (pairs.srcs[b], pairs.wts[b], pairs.norms[b], pairs.tgt(b), slack, R_d[b, :C],
                ang_d[b, :C], t_d[b, :C], ts_d[b, :C], mask_d[b, :C], int(h[b]), trim)
        ub[b, :C], lb[b, :C] = (_bounds_one_pair_mxu(*args, packed=pairs.packed(b))
                                if use_kernel else _bounds_one_pair(*args))
    return ub, lb, R_d, t_d


def _pairs_refine(pairs: _PairBatch, ub, R, t_c, refine_gate, live, *, refine_k: int,
                  icp_params: IcpParams):
    """The gated top-k refine (the second half of ``_pairs_round``): each
    ``live`` pair's ``refine_k`` best-ub jobs (ties lowest index first, as
    ``lax.top_k``), those below the pair's ``refine_gate [P]`` active, in
    one batched ICP, each against its own source and target.  Returns
    ``(R, t, sse, iters)``, each ``[P, refine_k, ...]`` on the device; a
    pose that does not iterate, and every pose of a pair not live, keeps
    its start, ``sse`` +inf and 0 iterations."""
    dev = pairs.device
    P, k = ub.shape[0], refine_k
    top = torch.sort(ub, dim=1, stable=True).indices[:, :k]              # [P, k]
    ub_top = ub.gather(1, top)
    R_out = torch.take_along_dim(R, top[:, :, None, None], dim=1)
    t_out = torch.take_along_dim(t_c, top[:, :, None], dim=1)
    sse_out = torch.full((P, k), _INF, dtype=torch.float32, device=dev)
    it_out = torch.zeros((P, k), dtype=torch.int32, device=dev)
    gate = to_device(np.asarray(refine_gate, np.float32), dev)
    live = np.asarray(live, np.int64)
    if live.size:
        sel = torch.as_tensor(live, device=dev)
        pose_pair = np.repeat(live, k)
        pp = torch.as_tensor(pose_pair, device=dev)
        T, sse, iters = _icp_pairs_run(
            pairs.srcs.index_select(0, pp), pairs.targets, pairs.wts.index_select(0, pp),
            RigidTransform(R_out[sel].reshape(-1, 3, 3), t_out[sel].reshape(-1, 3)),
            icp_params, pair_of_pose=pose_pair,
            active0=(ub_top[sel] < gate[sel][:, None]).reshape(-1),
        )
        R_out[sel] = T.R.reshape(-1, k, 3, 3)
        t_out[sel] = T.t.reshape(-1, k, 3)
        sse_out[sel] = sse.reshape(-1, k)
        it_out[sel] = iters.reshape(-1, k)
    return R_out, t_out, sse_out, it_out


def _pairs_round(pairs: _PairBatch, slack, R, ang, t_c, t_s, mask, h, refine_gate=None, *,
                 refine_k: int, icp_params: IcpParams, trim: bool = False,
                 use_kernel: bool = False):
    """One lockstep round (``multipair_lockstep.py:123``): the bounds of all
    ``[P, M]`` jobs, then the gated top-k refine of every pair.  ``R [P,M,3,3],
    ang, t_c, t_s, mask [P,M]`` and ``refine_gate [P]`` (None = ungated) are
    host arrays; a pair whose mask is all False is not refined.  Returns
    ``(ub, lb, R_ref, t_ref, sse_ref, it_ref)`` on the device."""
    ub, lb, R_d, t_d = _pairs_bounds(pairs, slack, R, ang, t_c, t_s, mask, h, trim=trim,
                                     use_kernel=use_kernel)
    gate = np.full(mask.shape[0], np.inf, np.float32) if refine_gate is None \
        else refine_gate
    return (ub, lb) + _pairs_refine(pairs, ub, R_d, t_d, gate,
                                    np.flatnonzero(np.asarray(mask).any(axis=1)),
                                    refine_k=refine_k, icp_params=icp_params)


def _fetch(*tensors):
    """Device tensors → numpy arrays in ONE device-to-host copy (their
    values as f32: ub/lb, poses, sse and iteration counts below 2^24)."""
    flat = torch.cat([t.reshape(-1).to(torch.float32) for t in tensors]).cpu().numpy()
    out, o = [], 0
    for t in tensors:
        n = t.numel()
        out.append(flat[o:o + n].reshape(tuple(t.shape)))
        o += n
    return out


def _pair_groups(pairs, N: int, mesh, batch: _PairBatch, normals):
    """``[(lo, hi, batch)]``: the whole batch, or with a pair-axis mesh one
    batch per mesh device over pairs ``lo:hi`` (``multipair_lockstep.py:407``)."""
    P = len(pairs)
    if mesh is None:
        return [(0, P, batch)]
    devs = list(mesh.devices.flat)
    if P % len(devs):
        from goicp_tpu_torch.core.logging import get_logger

        get_logger().warning(
            "pair count %d does not divide over %d mesh devices; running the lockstep "
            "unsharded", P, len(devs))
        return [(0, P, batch)]
    per = P // len(devs)
    return [(g * per, (g + 1) * per,
             _PairBatch(pairs[g * per:(g + 1) * per], N, torch.device(d),
                        None if normals is None else normals[g * per:(g + 1) * per]))
            for g, d in enumerate(devs)]


def _register_pairs_lockstep(
    pairs: Sequence[Tuple[np.ndarray, np.ndarray]], p: BnbParams, mesh=None,
    tgt_normals=None,
    inits: Optional[Sequence[Optional[RigidTransform]]] = None,
    pad_src_to: Optional[int] = None,
    device=None,
    use_kernel: Optional[bool] = None,
) -> List[GoIcpResult]:
    """The lockstep driver (``multipair_lockstep.py:188``), its pairs split
    over ``mesh``'s devices when given (a pair count that does not divide
    warns and runs unsharded): coarse-to-fine
    multistart ICP of every (pair × seed) with the identity and each pair's
    prior pinned, then BnB rounds for all live pairs at once, up to
    ``pipeline_depth`` rounds queued (a round's refine runs when it is
    absorbed; the gap rule is tested only with none queued), until each
    pair converges, ``max_rounds`` or ``max_wall_s``.  ``pad_src_to``: the
    source axis padded to at least this width (the service's shape
    buckets; exact, padded rows weigh 0).  ``use_kernel``: the bounds' K4
    form (None: on a CUDA device; True on the CPU runs K4's plain version,
    which the card's K4 equals bit for bit)."""
    dev = resolve_device(device)
    t_start = time.perf_counter()
    P = len(pairs)
    N = max(s.shape[0] for s, _ in pairs)
    if pad_src_to is not None:
        N = max(N, pad_src_to)
    # inlierNum per pair = n·(1−trim) (≙ jly_goicp.cpp:199-208)
    trim = p.trim_fraction > 0.0
    h = np.array(
        [max(1, int(round(s.shape[0] * (1.0 - p.trim_fraction)))) for s, _ in pairs],
        np.float64,
    )
    sse_thresh = p.mse_threshold * h

    icp_params = IcpParams(
        max_iter=p.icp_max_iter, rel_tol=p.icp_rel_tol,
        trim_fraction=p.trim_fraction, metric=p.icp_metric,
    )
    # in-round refines discover incumbents: capped at refine_max_iter
    icp_params_round = dataclasses.replace(
        icp_params, max_iter=min(p.icp_max_iter, p.refine_max_iter)
    )
    nrm = None
    if p.icp_metric == "plane":
        if tgt_normals is None:
            # once per distinct target object (the serving shape passes one
            # resident array P times)
            uniq: dict = {}
            for _, t in pairs:
                if id(t) not in uniq:
                    uniq[id(t)] = estimate_normals(to_device(t, dev), k=p.normals_k)
            tgt_normals = [uniq[id(t)] for _, t in pairs]
        nrm = _pair_normals(tgt_normals, pairs)
    batch = _PairBatch(pairs, N, dev, nrm)

    has_inits = inits is not None and any(T is not None for T in inits)
    K = max(2 if has_inits else 1, min(p.init_multistart, 32))
    seeds = np.concatenate(
        [np.eye(3, dtype=np.float32)[None],
         random_rotations(K - 1, np.random.default_rng(12345))]
    )                                                      # [K,3,3]
    R0 = np.tile(seeds, (P, 1, 1))                         # [P·K,3,3]
    t0 = np.zeros((P * K, 3), np.float32)
    for b, (s, t) in enumerate(pairs):
        mu_s, mu_t = s.mean(0), t.mean(0)
        t0[b * K:(b + 1) * K] = mu_t[None] - np.einsum("bij,j->bi", R0[b * K:(b + 1) * K], mu_s)
        t0[b * K] = 0.0       # the reference's identity start, exact
        if inits is not None and inits[b] is not None:
            # the pair's prior pinned in slot 1 (≙ fgoicp.cpp:11-18 batched)
            R0[b * K + 1] = np.asarray(inits[b].R, np.float32)
            t0[b * K + 1] = np.asarray(inits[b].t, np.float32)

    # coarse-to-fine: every (pair × seed) first converges on nc-point
    # subsets, then the best few per pair (plus the pinned identity and
    # prior seeds, from their original starts) refine at full resolution
    nc = p.init_coarse_n
    n_min = min(min(s.shape[0] for s, _ in pairs), min(t.shape[0] for _, t in pairs))
    if 0 < nc < n_min // 2 and K > 4:
        crng = np.random.default_rng(424242)
        c_src, c_tgt, c_nrm = [], [], ([] if nrm is not None else None)
        for b, (s, t) in enumerate(pairs):
            sidx = np.sort(crng.choice(s.shape[0], nc, replace=False))
            tidx = np.sort(crng.choice(t.shape[0], nc, replace=False))
            c_src.append(s[sidx])
            c_tgt.append(t[tidx])
            if c_nrm is not None:
                # the full cloud's normals at the subset rows
                c_nrm.append(to_device(nrm[b], dev)[torch.as_tensor(tidx, device=dev)])
        pose_pair = np.repeat(np.arange(P), K)
        srcs_c = to_device(np.stack(c_src)[pose_pair], dev)
        Tc, sse_c, _ = _icp_pairs_run(
            srcs_c, PairTargets(c_tgt, dev, c_nrm), torch.ones(srcs_c.shape[:2], device=dev),
            RigidTransform(to_device(R0, dev), to_device(t0, dev)), icp_params,
            pair_of_pose=pose_pair,
        )
        Rc, tc, sse_c = _fetch(Tc.R, Tc.t, sse_c)          # one fused fetch
        sse_c = np.asarray(sse_c, np.float64).reshape(P, K)
        Rc = Rc.reshape(P, K, 3, 3)
        tc = tc.reshape(P, K, 3)
        keep = min(max(4, p.refine_top_k), K)
        K2 = keep + 2                     # + pinned identity / prior slots
        R0n = np.zeros((P, K2, 3, 3), np.float32)
        t0n = np.zeros((P, K2, 3), np.float32)
        for b in range(P):
            top = np.argsort(sse_c[b])[:keep]
            R0n[b, :keep] = Rc[b, top]
            t0n[b, :keep] = tc[b, top]
            R0n[b, keep] = R0[b * K]      # identity start, exact
            t0n[b, keep] = t0[b * K]
            R0n[b, keep + 1] = R0[b * K + 1]   # prior (or seed 1), exact
            t0n[b, keep + 1] = t0[b * K + 1]
        K = K2
        R0 = R0n.reshape(P * K, 3, 3)
        t0 = t0n.reshape(P * K, 3)

    pose_pair = np.repeat(np.arange(P), K)
    pp = torch.as_tensor(pose_pair, device=dev)
    T0, sse0, _ = _icp_pairs_run(
        batch.srcs.index_select(0, pp), batch.targets, batch.wts.index_select(0, pp),
        RigidTransform(to_device(R0, dev), to_device(t0, dev)), icp_params,
        pair_of_pose=pose_pair,
    )
    T0R, T0t, sse0 = _fetch(T0.R, T0.t, sse0)              # one fused fetch
    sse0 = np.asarray(sse0, np.float64).reshape(P, K)
    jbest = np.argmin(sse0, axis=1)
    best_R = T0R.reshape(P, K, 3, 3)[np.arange(P), jbest]
    best_t = T0t.reshape(P, K, 3)[np.arange(P), jbest]
    best_sse = sse0[np.arange(P), jbest].copy()

    rotparam = _PARAMS[p.rotation_param]
    mean_norm = np.array([np.linalg.norm(s, axis=1).mean() for s, _ in pairs])
    beta = max(p.split_beta, 1e-6)

    def classify(b, pay):
        # the one shared split rule (bnb.split); the lockstep has no span
        # floors, so only the implicit 1e-5 translation resolution applies
        split_rot, _ = classify_split(pay, mean_norm[b], rotparam, beta=beta,
                                      rot_floor=0.0, trans_floor=1e-5)
        return split_rot

    fronts = [make_frontier(8) for _ in range(P)]
    root = np.array([0.0, 0.0, 0.0, rotparam.root_span, *p.trans_center, p.trans_span],
                    np.float32)
    for f in fronts:
        f.push(root[None], np.zeros(1, np.float32), np.full(1, np.inf, np.float32))

    pop_k = max(32, min(512, p.se3_pop or 512))
    M_cap = 8 * pop_k
    converged = best_sse <= sse_thresh
    rounds = 0
    nodes = np.zeros(P, np.int64)
    icp_iters = np.zeros(P, np.int64)
    # the exact bounds' f32-cancellation allowance (≙ GoIcpSolver's
    # _exact_slack), deducted from every lb in conservative mode
    if p.conservative:
        scale = float(max(np.abs(s).max() + np.abs(t).max() for s, t in pairs)
                      + p.trans_span * _SQRT3)
        slack = math.sqrt(8.0 * 1.2e-7) * scale
    else:
        slack = 0.0
    if use_kernel is None:
        use_kernel = dev.type == "cuda"
    groups = _pair_groups(pairs, N, mesh, batch, nrm)

    def dispatch():
        """Pop and expand every live pair's best nodes and queue the round's
        bounds; the refine runs in :func:`absorb`."""
        active = [b for b in range(P) if not converged[b] and len(fronts[b])]
        if not active:
            return None
        childs: dict = {}
        for b in active:
            pay, _, _ = fronts[b].pop_best(pop_k)
            B = pay.shape[0]
            split_rot = classify(b, pay)
            child = np.repeat(pay, 8, axis=0)
            oct8 = np.tile(_OCTANTS, (B, 1))
            sr = np.repeat(split_rot, 8)
            half_r = np.repeat(pay[:, 3], 8) / 2.0
            half_t = np.repeat(pay[:, 7], 8) / 2.0
            child[sr, 0:3] += oct8[sr] * half_r[sr, None]
            child[sr, 3] = half_r[sr]
            child[~sr, 4:7] += oct8[~sr] * half_t[~sr, None]
            child[~sr, 7] = half_t[~sr]
            child = child[rotparam.valid(child[:, 0:3], child[:, 3])]
            nodes[b] += child.shape[0]
            childs[b] = child

        # job-count buckets: few live children dispatch at the nearest
        # power of two instead of the full M_cap
        Cmax = max(childs[b].shape[0] for b in active)
        Mb = 512
        while Mb < min(Cmax, M_cap):
            Mb *= 2
        Mb = min(Mb, M_cap)
        R_all = np.tile(np.eye(3, dtype=np.float32), (P, Mb, 1, 1))
        ang_all = np.zeros((P, Mb), np.float32)
        t_all = np.zeros((P, Mb, 3), np.float32)
        ts_all = np.zeros((P, Mb), np.float32)
        mask_all = np.zeros((P, Mb), bool)
        for b in active:
            child = childs[b]
            C = child.shape[0]
            R_all[b, :C] = rotparam.rotation(child[:, 0:3])
            ang_all[b, :C] = rotparam.max_angle(child[:, 0:3], child[:, 3])
            t_all[b, :C] = child[:, 4:7]
            ts_all[b, :C] = child[:, 7]
            mask_all[b, :C] = True
        parts = []
        for lo, hi, bt in groups:
            with on_device(bt.device):
                parts.append(_pairs_bounds(
                    bt, slack, R_all[lo:hi], ang_all[lo:hi], t_all[lo:hi], ts_all[lo:hi],
                    mask_all[lo:hi], h[lo:hi], trim=trim, use_kernel=use_kernel))
        gate = (p.icp_refine_factor * best_sse).astype(np.float32)
        return {"childs": childs, "R_all": R_all, "active": active, "parts": parts,
                "gate": gate}

    def absorb(work):
        """Refine one queued round, fetch it in one copy; update incumbents,
        prune, push.  Threshold convergence fires here; the gap rule is
        tested only when no round is queued (``settled_gap_check``)."""
        fetched = []
        for (lo, hi, bt), (ub_g, lb_g, R_g, t_g) in zip(groups, work["parts"]):
            with on_device(bt.device):
                live = [b - lo for b in work["active"] if lo <= b < hi]
                refined = _pairs_refine(bt, ub_g, R_g, t_g, work["gate"][lo:hi], live,
                                        refine_k=p.refine_top_k, icp_params=icp_params_round)
                fetched.append(_fetch(ub_g, lb_g, *refined))
        ub, lb, R_ref, t_ref, sse_ref, it_ref = (
            np.concatenate([f[i] for f in fetched]) for i in range(6))
        R_all = work["R_all"]
        for b in work["active"]:
            child = work["childs"][b]
            C = child.shape[0]
            icp_iters[b] += int(it_ref[b].sum())
            j = int(np.argmin(sse_ref[b]))
            if float(sse_ref[b, j]) < best_sse[b]:
                best_sse[b] = float(sse_ref[b, j])
                best_R[b], best_t[b] = R_ref[b, j], t_ref[b, j]
                fronts[b].prune(best_sse[b] - sse_thresh[b])
            jj = int(np.argmin(ub[b, :C]))
            if float(ub[b, jj]) < best_sse[b]:
                best_sse[b] = float(ub[b, jj])
                best_R[b] = R_all[b, jj]
                best_t[b] = child[jj, 4:7]
                fronts[b].prune(best_sse[b] - sse_thresh[b])
            alive = lb[b, :C] < best_sse[b] - sse_thresh[b]
            if alive.any():
                fronts[b].push(child[alive], lb[b, :C][alive], ub[b, :C][alive])
            if best_sse[b] <= sse_thresh[b]:
                converged[b] = True

    def settled_gap_check():
        for b in range(P):
            if not converged[b] and len(fronts[b]):
                if best_sse[b] - fronts[b].min_lb() <= sse_thresh[b]:
                    converged[b] = True

    # up to pipeline_depth rounds queued: round k+d pops disjoint frontier
    # slices before round k is absorbed; staleness only weakens pruning
    inflight: deque = deque()
    depth = max(1, p.pipeline_depth)
    while True:
        if time.perf_counter() - t_start > p.max_wall_s:
            while inflight:
                absorb(inflight.popleft())
            break
        can = rounds < p.max_rounds
        if can and not inflight:
            settled_gap_check()
        if can and len(inflight) < depth:
            work = dispatch()
            if work is not None:
                rounds += 1
                inflight.append(work)
                continue
        if inflight:
            absorb(inflight.popleft())
            continue
        break
    settled_gap_check()

    wall = time.perf_counter() - t_start
    results = []
    for b in range(P):
        done = bool(converged[b]) or not len(fronts[b])
        gap = best_sse[b] - (fronts[b].min_lb() if len(fronts[b]) else best_sse[b])
        results.append(GoIcpResult(
            transform=RigidTransform(best_R[b], best_t[b]),
            sse=float(best_sse[b]),
            mse=float(best_sse[b] / h[b]),
            converged=done,
            gap=float(max(gap, 0.0)),
            rot_nodes=int(nodes[b]),
            trans_nodes=int(nodes[b]),
            icp_iters=int(icp_iters[b]),
            rounds=rounds,
            wall_s=wall,
            metrics=Metrics(),
        ))
    return results
