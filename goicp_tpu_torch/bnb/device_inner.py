"""The nested engine's inner translation BnB (port of the JAX package's
``bnb/device_inner.py``).

For a batch of ``G`` rotation cubes, the whole translation search runs on
the device over fixed ``[G, C]`` frontiers of translation cubes:

- one evaluation feeds all four objectives (ub/lb, each with and without
  the rotation cube's uncertainty), as the JAX package does in place of
  the reference's two inner searches per cube (``fgoicp.cpp:72,93``);
- trimmed sums keep a running top-``drop`` of the terms (``_merge_top``);
- a node dies when it cannot improve its incumbent (or the external cap)
  by more than ``sse_thresh`` (``jly_goicp.cpp:318-321``); nodes stopped
  by the depth floor or dropped for capacity fold their lower bounds into
  the ``unres_*`` minima, so the returned bounds stay ε-sound;
- the last level's children get one final evaluation.

The JAX package's ``lax.while_loop`` is a host loop here that syncs once
per level (on ``valid.any()`` and the valid nodes' indices); only valid
nodes are evaluated, which gives the same values as evaluating the whole
``[G, C]`` frontier and masking.  Distances come from the exact expansion
(:func:`bnb.se3_eval._exact_min_d2`) or the grid lookups (``nn.grid``),
in plain PyTorch: the JAX package reaches no Pallas kernel here either.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from goicp_tpu_torch.bnb.bounds import lookup_sq
from goicp_tpu_torch.bnb.rounds import _OCTANTS
from goicp_tpu_torch.bnb.se3_eval import _exact_min_d2, _target_tiles
from goicp_tpu_torch.geo.rotation import rotation_displacement
from goicp_tpu_torch.nn.fused import fma, ordered_row_sum, sqrt_rn

_SQRT3 = math.sqrt(3.0)
_INF = float("inf")


def _merge_top(top, vals, drop: int):
    """Running top-``drop``: merge ``top [V, drop]`` with ``vals [V, t]``,
    descending, as ``jax.lax.top_k`` returns them (``device_inner.py:71``)."""
    return torch.topk(torch.cat([top, vals], dim=-1), drop, dim=-1, sorted=True).values


def inner_bnb_device(
    src,            # [N,3]
    norms,          # [N]
    grid,           # DistanceGrid ("grid" backend) or None
    tgt,            # [Nt,3] targets (read by the "exact" backend)
    slack: float,
    R_g,            # [G,3,3] rotation-cube center rotations
    angle_g,        # [G] rotation-cube max angles
    cap_ub,         # [G] external prune cap for the ub search
    cap_lb,         # [G] external prune cap for the lb search
    t_root_center,  # [3]
    t_root_span: float,
    sse_thresh: float,
    min_span: float,
    *,
    levels: int = 12,
    C: int = 64,
    h: int = 0,
    lookup: str = "trilinear",
    tile: int = 128,
    backend: str = "grid",
    tgt_tile: int = 256,
):
    """Translation BnB of ``G`` rotation cubes (``device_inner.py:109``).
    Returns ``(inc_ub, inc_lb, best_t, unres_ub, unres_lb, nodes)``: the
    first five ``[G]`` / ``[G,3]`` tensors, ``nodes`` the evaluated count.
    The scalars are f32 values, as the JAX package passes them."""
    G, N = R_g.shape[0], src.shape[0]
    dev = src.device
    K = C // 8
    drop = 0 if h in (0, N) else N - h
    slack, t_root_span, sse_thresh, min_span = (
        float(np.float32(x)) for x in (slack, t_root_span, sse_thresh, min_span)
    )
    if backend == "exact":
        tgt_tiles, tgt_norm_tiles = _target_tiles(tgt, tgt_tile)

    # R·p by a matmul, which adds the K = 3 products as XLA's CPU dot does
    # (tests/test_torch_grid.py checks the bits), [G,N,3]
    pts0 = src[None] @ R_g.transpose(-1, -2)
    gamma_r = rotation_displacement(angle_g, norms)               # [G,N]
    n_tiles = -(-N // tile)
    pad = n_tiles * tile - N
    if pad:
        pts0 = torch.nn.functional.pad(pts0, (0, 0, 0, pad))
        gamma_r = torch.nn.functional.pad(gamma_r, (0, pad))
    pt_mask = (torch.arange(n_tiles * tile, device=dev) < N).to(torch.float32)
    pts0_t = pts0.reshape(G, n_tiles, tile, 3).transpose(0, 1)     # [T,G,tile,3]
    gr_t = gamma_r.reshape(G, n_tiles, tile).transpose(0, 1)       # [T,G,tile]
    pm_t = pt_mask.reshape(n_tiles, tile)                           # [T,tile]

    sqrt3 = torch.tensor(_SQRT3, dtype=torch.float32, device=dev)

    def eval_nodes(centers, spans, valid):
        """The four objectives ``[G,C]`` of the valid nodes, +inf elsewhere."""
        flat = torch.nonzero(valid.reshape(-1)).reshape(-1)
        out = [torch.full((G * C,), _INF, device=dev) for _ in range(4)]
        V = flat.numel()
        if V == 0:
            return tuple(o.reshape(G, C) for o in out)
        g_v = flat // C
        c_v = centers.reshape(-1, 3).index_select(0, flat)          # [V,3]
        span_v = spans.reshape(-1).index_select(0, flat)[:, None]   # [V,1]
        gt = _SQRT3 * span_v
        sums = [torch.zeros(V, device=dev) for _ in range(4)]
        tops = [torch.full((V, drop), -_INF, device=dev) for _ in range(4)] if drop else None
        for k in range(n_tiles):
            pts = pts0_t[k].index_select(0, g_v) + c_v[:, None, :]   # [V,tile,3]
            if backend == "exact":
                d = sqrt_rn(_exact_min_d2(pts, tgt_tiles, tgt_norm_tiles))
                d_lo = torch.clamp(d - slack, min=0.0)
                d_hi = d + slack
            else:
                val, esc = lookup_sq(grid, pts, lookup)
                d = sqrt_rn(torch.clamp(val, min=0.0))
                d_lo = torch.clamp(d - esc - slack, min=0.0)
                d_hi = d + esc + slack
            gr = gr_t[k].index_select(0, g_v)                       # [V,tile]
            m = pm_t[k]
            c = torch.clamp(d_lo - gt, min=0.0)
            r = torch.clamp(d_lo - gr, min=0.0)
            b = torch.clamp(d_lo - gr - gt, min=0.0)
            objs = ((d_hi * d_hi) * m, (c * c) * m, (r * r) * m, (b * b) * m)
            sums = [s + ordered_row_sum(o) for s, o in zip(sums, objs)]
            if drop:
                cand = objs
                if n_tiles == 1:
                    # with one point tile XLA's CPU build inlines the scan
                    # and contracts d − √3·span into a fused multiply-add
                    # where the lb terms feed the top-k (not where they
                    # feed the sums); the dropped terms round the same way
                    c_k = torch.clamp(fma(-span_v, sqrt3, d_lo), min=0.0)
                    b_k = torch.clamp(fma(-span_v, sqrt3, d_lo - gr), min=0.0)
                    cand = (objs[0], (c_k * c_k) * m, objs[2], (b_k * b_k) * m)
                tops = [_merge_top(t, o, drop) for t, o in zip(tops, cand)]
        if drop:
            sums = [s - ordered_row_sum(torch.clamp(t, min=0.0)) for s, t in zip(sums, tops)]
        for o, s in zip(out, sums):
            o[flat] = s
        return tuple(o.reshape(G, C) for o in out)

    ar = torch.arange(G, device=dev)

    def update(centers, cv_fix, cv_rot, inc_ub, inc_lb, best_t):
        """Incumbents from one evaluation (≙ fgoicp.cpp:144-150)."""
        i = torch.argmin(cv_fix, dim=1)
        cand_ub = cv_fix[ar, i]
        better = cand_ub < inc_ub
        best_t = torch.where(better[:, None], centers[ar, i], best_t)
        return (torch.minimum(inc_ub, cand_ub),
                torch.minimum(inc_lb, cv_rot.amin(dim=1)), best_t)

    def fold(unres, mask, vals):
        return torch.minimum(unres, torch.where(mask, vals, _INF).amin(dim=1))

    t_root = t_root_center.to(torch.float32)
    centers = torch.zeros((G, C, 3), device=dev)
    centers[:, 0, :] = t_root
    spans = torch.zeros((G, C), device=dev)
    spans[:, 0] = t_root_span
    valid = torch.zeros((G, C), dtype=torch.bool, device=dev)
    valid[:, 0] = True
    inc_ub = torch.full((G,), _INF, device=dev)
    inc_lb = torch.full((G,), _INF, device=dev)
    best_t = t_root[None].expand(G, 3).clone()
    unres_ub = torch.full((G,), _INF, device=dev)
    unres_lb = torch.full((G,), _INF, device=dev)
    oct8 = torch.as_tensor(_OCTANTS, device=dev)   # child offsets (≙ fgoicp.cpp:160-173)
    nodes = 0
    level = 0
    while level < levels and bool(valid.any()):
        cv_fix, lb_fix, cv_rot, lb_rot = eval_nodes(centers, spans, valid)
        nodes += int(valid.sum())
        inc_ub, inc_lb, best_t = update(centers, cv_fix, cv_rot, inc_ub, inc_lb, best_t)

        # ε-prune against incumbents and external caps (jly_goicp.cpp:318-321)
        lim_ub = (torch.minimum(inc_ub, cap_ub) - sse_thresh)[:, None]
        lim_lb = (torch.minimum(inc_lb, cap_lb) - sse_thresh)[:, None]
        alive = valid & ((lb_fix < lim_ub) | (lb_rot < lim_lb))

        # depth floor (≙ fgoicp.cpp:160): stuck nodes become unresolved
        can_div = spans / 2.0 >= min_span
        stuck = alive & ~can_div
        unres_ub, unres_lb = fold(unres_ub, stuck, lb_fix), fold(unres_lb, stuck, lb_rot)

        # the K best expandables; capacity-dropped ones become unresolved.
        # jax.lax.top_k(-prio, K) returns ties lowest index first, as a
        # stable ascending sort does (torch.topk promises no tie order)
        expand = alive & can_div
        prio = torch.where(expand, torch.minimum(lb_fix, lb_rot), _INF)
        sel = torch.sort(prio, dim=1, stable=True).indices[:, :K]     # [G,K]
        sel_ok = prio.gather(1, sel) < _INF
        sel_mask = torch.zeros((G, C), dtype=torch.bool, device=dev)
        sel_mask.scatter_(1, sel, sel_ok)
        dropped = expand & ~sel_mask
        unres_ub, unres_lb = fold(unres_ub, dropped, lb_fix), fold(unres_lb, dropped, lb_rot)

        # 8-way children fill the frontier exactly
        c_sel = centers.gather(1, sel[..., None].expand(G, K, 3))     # [G,K,3]
        s_sel = spans.gather(1, sel)                                  # [G,K]
        half = (s_sel / 2.0)[..., None]
        centers = (c_sel[:, :, None, :] + oct8[None, None] * half[..., None]).reshape(G, C, 3)
        spans = torch.repeat_interleave(s_sel / 2.0, 8, dim=1)
        valid = torch.repeat_interleave(sel_ok, 8, dim=1)
        level += 1

    # children spawned on the last level were never evaluated: fold their
    # (parent-monotone) information in through one more evaluation
    if bool(valid.any()):
        cv_fix, lb_fix, cv_rot, lb_rot = eval_nodes(centers, spans, valid)
        nodes += int(valid.sum())
        inc_ub, inc_lb, best_t = update(centers, cv_fix, cv_rot, inc_ub, inc_lb, best_t)
        unres_ub, unres_lb = fold(unres_ub, valid, lb_fix), fold(unres_lb, valid, lb_rot)
    return inc_ub, inc_lb, best_t, unres_ub, unres_lb, nodes
