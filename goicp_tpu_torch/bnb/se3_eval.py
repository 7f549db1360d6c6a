"""SE(3) bound evaluation and the fused round (port of the JAX package's
``bnb/se3_eval.py``).

A round evaluates the bounds of a flat batch of nodes and then ICP-refines
the ``refine_k`` best-ub nodes (``_refine_tail``), on exact or grid
correspondences.  The bound backends:

- R-rounds (singleton nodes, :func:`se3_round`): "screen" runs the screened
  kernel K2, or K5 when trimmed; "mxu" runs K4's per-point distances and
  the deflation epilogue, with trimmed sums by bisection when trimmed.
- T-rounds (8 translation siblings per rotation, :func:`se3_round_grouped`):
  the grouped kernel K3 and the epilogue, on both backends; trimmed
  "screen" T-rounds run K6 instead.
- "exact" and "grid" (:func:`evaluate_se3_nodes`, both round kinds, the
  grouped one flattened to nodes): plain PyTorch over point tiles, with
  exact distances by the ``|p|² − 2p·t + |t|²`` expansion over target tiles,
  or distance-grid lookups with their escape term.

Everything stays queued on the device; the round driver (``bnb.rounds``)
runs the refine tail when it absorbs the round.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from goicp_tpu_torch.bnb.bounds import lookup_sq
from goicp_tpu_torch.core.types import RigidTransform
from goicp_tpu_torch.geo.rotation import (
    axis_angle_cube_max_angle,
    deflation_factor,
    rotation_displacement,
)
from goicp_tpu_torch.nn import fused
from goicp_tpu_torch.nn.fused import trimmed_sum_bisect as _trimmed_sum_bisect

_SQRT3 = math.sqrt(3.0)
_INF = float("inf")


def _drop(h: int, N: int) -> int:
    """Points trimmed away; 0 for an untrimmed evaluation (``h`` 0 or N)."""
    return 0 if h in (0, N) else N - h


def _masked(mask, ub, lb):
    inf = torch.full_like(ub, _INF)
    return torch.where(mask, ub, inf), torch.where(mask, lb, inf)


def _deflate_and_reduce(d2, norms, slack, max_angle, t_span, mask, *,
                        h: int, N: int):
    """Bound epilogue over per-node exact distances ``d2 [M, Np]``: Yang et
    al. eq. 10 deflation by the per-point rotation radius and the
    translation corner radius, then (trimmed) sums (``se3_eval.py:60``)."""
    Np = d2.shape[1]
    drop = _drop(h, N)
    pmask = (torch.arange(Np, device=d2.device) < N).to(torch.float32)[None, :]
    ub_c, lb_c = deflate_terms(d2, torch.nn.functional.pad(norms, (0, Np - N)), slack,
                               max_angle, t_span, pmask, drop)
    if drop:
        s_ub = _trimmed_sum_bisect(ub_c, h, upper=True)
        s_lb = _trimmed_sum_bisect(lb_c, h, upper=False)
    else:
        s_ub = ub_c.sum(-1)
        s_lb = lb_c.sum(-1)
    return _masked(mask, s_ub, s_lb)


def deflate_terms(d2, norms, slack, max_angle, t_span, pmask, drop: int):
    """The epilogue's per-point terms ``(ub, lb) [M, Np]``: ``d_hi²`` and
    ``max(d_lo − γr − γt, 0)²`` times ``pmask [1, Np]`` (0 on padded
    points, whose ``norms`` are 0), and padded points at 1e30 when ``drop``
    trims, so they never take an inlier slot."""
    d = fused.sqrt_rn(torch.clamp(d2, min=0.0))
    d_lo = torch.clamp(d - slack, min=0.0)
    d_hi = d + slack
    gamma_r = rotation_displacement(max_angle, norms)     # [M, Np]
    gamma_t = (_SQRT3 * t_span)[:, None]
    ub_c = (d_hi * d_hi) * pmask
    c = torch.clamp(d_lo - gamma_r - gamma_t, min=0.0)
    lb_c = (c * c) * pmask
    if drop:
        inf_pad = (1.0 - pmask) * 1e30
        ub_c = ub_c + inf_pad
        lb_c = lb_c + inf_pad
    return ub_c, lb_c


def evaluate_se3_nodes_mxu(src, norms, tgt, slack, R, max_angle, t_c, t_span,
                           mask, *, h: int):
    """Unscreened bounds of singleton nodes: K4's per-point distances, then
    the epilogue (``se3_eval.py:89``)."""
    N = src.shape[0]
    d2 = fused.min_d2_nodes(
        fused.pack_sources(src), fused.pack_targets(tgt), fused.pack_params(R, t_c),
    )
    return _deflate_and_reduce(d2, norms, slack, max_angle, t_span, mask, h=h, N=N)


def evaluate_se3_groups_mxu(src, norms, tgt, slack, R, max_angle, t8, t_span8,
                            mask, *, h: int):
    """Grouped bounds for 8 translation siblings per rotation: ``R [G,3,3]``,
    ``max_angle [G]``, ``t8 [G,8,3]``, ``t_span8 [G,8]``, ``mask [8G]`` →
    ``(ub, lb) [8G]`` in group-major order (``se3_eval.py:113``)."""
    N = src.shape[0]
    d2 = fused.min_d2_groups(
        fused.pack_sources(src), fused.pack_targets(tgt),
        fused.pack_group_params(R, t8),
    )
    return _deflate_and_reduce(
        d2, norms, slack, torch.repeat_interleave(max_angle, 8),
        t_span8.reshape(-1), mask, h=h, N=N,
    )


def _trim_screen(thresh, h: int, drop: int):
    """The trimmed screen's clamp level τ = 2·max(thresh, 0)/h and its
    threshold thresh' = thresh + drop·τ, in f32 as the JAX package computes
    them (``se3_eval.py:257``)."""
    th = np.float32(thresh)
    tau = np.float32(2.0) * np.maximum(th, np.float32(0.0)) / np.float32(h)
    return th + np.float32(drop) * tau, tau


def evaluate_se3_nodes_screened(src, norms, tgt, slack, thresh, R, max_angle,
                                t_c, t_span, mask, *, h: int):
    """Screened bounds of singleton nodes (``se3_eval.py:237``): K2, or K5
    with its clamped-sum screen when trimmed (``0 < h < N``).  Masked
    (padding) rows get threshold −inf, so the kernel skips them at once;
    their outputs are replaced by +inf either way."""
    N = src.shape[0]
    drop = _drop(h, N)
    af = deflation_factor(max_angle)
    gt = _SQRT3 * t_span
    srcT, wm = fused.pack_sources_ext(src, norms), fused.pack_targets(tgt)
    if drop:
        params = fused.pack_params_bounds_trimmed(R, t_c, af, gt, slack,
                                                  *_trim_screen(thresh, h, drop))
    else:
        params = fused.pack_params_bounds(R, t_c, af, gt, slack, thresh)
    params[:, 15] = torch.where(mask, params[:, 15], -_INF)   # thresh (K2), thresh' (K5)
    if drop:
        ub, lb = fused.bounds_nodes_trimmed(srcT, wm, params, h=h, drop=drop)
    else:
        ub, lb = fused.bounds_nodes(srcT, wm, params)
    return _masked(mask, ub, lb)


def evaluate_se3_groups_screened(src, norms, tgt, slack, thresh, R, max_angle,
                                 t8, t_span8, mask, *, h: int):
    """Screened TRIMMED bounds for 8-sibling groups through K6
    (``se3_eval.py:269``); only for ``0 < h < N``.  Groups whose 8 nodes
    are all masked get threshold −inf and are skipped at once."""
    N = src.shape[0]
    drop = N - h
    af = deflation_factor(max_angle)                                # [G]
    gt8 = _SQRT3 * t_span8                                          # [G,8]
    params = fused.pack_group_params_bounds_trimmed(R, t8, af, gt8, slack,
                                                    *_trim_screen(thresh, h, drop))
    live = mask.reshape(-1, 8).any(dim=1)
    params[:, 51] = torch.where(live, params[:, 51], -_INF)
    ub, lb = fused.bounds_groups_trimmed(
        fused.pack_sources_ext(src, norms), fused.pack_targets(tgt), params,
        h=h, drop=drop,
    )
    return _masked(mask, ub, lb)


def _target_tiles(tgt, tgt_tile: int):
    """Targets padded at 1e15 to whole ``tgt_tile`` tiles, ``[Tt, tile_t,
    3]``, and their ``|t|²`` tiles, summed as the JAX package's jitted code
    sums them (``se3_eval.py:178``, ``device_inner.py:144``)."""
    padt = (-tgt.shape[0]) % tgt_tile
    if padt:
        tgt = torch.cat([tgt, torch.full((padt, 3), 1e15, dtype=tgt.dtype,
                                         device=tgt.device)])
    tiles = tgt.reshape(-1, tgt_tile, 3)
    return tiles, fused._sq3_fma(tiles)


# query rows of one ``[X, targets]`` block of the exact expansion
_EXACT_ROWS = 1 << 14
# nearest candidates per query whose d² is rounded as XLA rounds it
_EXACT_CANDIDATES = 8
_U32 = 2.0 ** -24


def _exact_min_d2(pts, tgt_tiles, tgt_norm_tiles):
    """Exact min squared distance of ``pts [..., 3]`` over target tiles
    ``[Tt, tile_t, 3]`` (padded at 1e15) by the ``|p|² − 2p·t + |t|²``
    expansion (``device_inner.py:62``), every term rounded as the jitted
    JAX function rounds it: the K = 3 product and ``|p|²`` with the single
    roundings of XLA's CPU dot and reduce (:func:`~goicp_tpu_torch.nn.fused.fma`),
    so the result is bit-equal to it.

    Only the min over targets is returned, so the exact rounding is paid on
    a few candidates: an f32 matmul gives every ``|t|² − 2p·t`` to within
    δ = 32·2⁻²⁴·(|p|·max|t| + max|t|²) of its XLA-rounded value, so the
    minimum lies among the targets within 2δ of the matmul's minimum.  The
    ``_EXACT_CANDIDATES`` smallest are rounded exactly; a query with more
    targets inside 2δ (near-equidistant targets) is done over all of them."""
    shape = pts.shape[:-1]
    flat = pts.reshape(-1, 3)
    tgt = tgt_tiles.reshape(-1, 3)
    tn = tgt_norm_tiles.reshape(-1)
    real = tn < 1e29                                 # not the 1e15 padding
    r_max = float(torch.sqrt(tn[real].max())) if bool(real.any()) else 0.0
    k = min(_EXACT_CANDIDATES, tgt.shape[0])
    out = torch.empty(flat.shape[0], dtype=flat.dtype, device=flat.device)
    for r0 in range(0, flat.shape[0], _EXACT_ROWS):
        q = flat[r0:r0 + _EXACT_ROWS]
        approx = tn[None, :] - 2.0 * (q @ tgt.T)                       # [X, Mt]
        vals, cand = torch.topk(approx, k, dim=1, largest=False, sorted=True)
        qn = torch.sqrt(fused._sq3(q))
        margin = 64.0 * _U32 * (qn * r_max + r_max * r_max)
        d2 = tn[cand] - 2.0 * fused._dot3_fma(q[:, None, :], tgt[cand])
        best = d2.amin(dim=1)
        if k < tgt.shape[0]:
            crowded = torch.nonzero(vals[:, -1] <= vals[:, 0] + margin).reshape(-1)
            if crowded.numel():
                full = tn[None, :] - 2.0 * fused._dot3_fma(q[crowded][:, None, :], tgt[None])
                best[crowded] = full.amin(dim=1)
        out[r0:r0 + q.shape[0]] = torch.clamp(best + fused._sq3_fma(q), min=0.0)
    return out.reshape(shape)


def evaluate_se3_nodes(src, norms, grid, tgt, slack, R, max_angle, t_c, t_span,
                       mask, *, h: int = 0, lookup: str = "trilinear",
                       backend: str = "exact", tile: int = 128,
                       tgt_tile: int = 256):
    """(ub, lb) of a flat batch of SE(3) nodes on the "exact" or "grid"
    backend (``se3_eval.py:144``).  Points go through ``tile``-point tiles,
    so no ``[M, N, 3]`` tensor is made whole; the ``[M, Np]`` terms are
    kept for the sums.  The sums add in the JAX package's jitted CPU order
    (:func:`~goicp_tpu_torch.nn.fused.ordered_row_sum` per tile, the tiles
    in sequence; trimmed sums by the bisection with ``ordered=True``), so
    node counts do not move with the summation order.
    ``tgt`` is read by "exact" only; ``grid`` by "grid" only."""
    drop = _drop(h, src.shape[0])
    ub_t, lb_t = node_tile_terms(
        src, norms, grid, tgt, slack, R, max_angle, t_c, t_span, drop=drop,
        lookup=lookup, backend=backend, tile=tile, tgt_tile=tgt_tile,
    )
    if drop:
        s_ub = _trimmed_sum_bisect(torch.cat(ub_t, dim=1), h, upper=True, ordered=True)
        s_lb = _trimmed_sum_bisect(torch.cat(lb_t, dim=1), h, upper=False, ordered=True)
    else:
        s_ub, s_lb = (tile_sums(torch.stack(s, dim=1)) for s in (ub_t, lb_t))
    return _masked(mask, s_ub, s_lb)


def node_tile_terms(src, norms, grid, tgt, slack, R, max_angle, t_c, t_span, *,
                    drop: int, lookup: str, backend: str, tile: int, tgt_tile: int):
    """The per-point ub and lb terms of :func:`evaluate_se3_nodes`, one
    ``[M, tile]`` pair per point tile (the last tile zero-padded: its
    padded terms are 0, or 1e30 when ``drop`` trims, so they never take an
    inlier slot).  Returns ``(ub_tiles, lb_tiles)``."""
    N = src.shape[0]
    dev = src.device
    if backend == "exact":
        tgt_tiles, tgt_norm_tiles = _target_tiles(tgt, tgt_tile)

    gamma_r = rotation_displacement(max_angle, norms)          # [M,N]
    gamma_t = (_SQRT3 * t_span)[:, None]                        # [M,1]
    Rt = R.transpose(-1, -2)
    stored_ub, stored_lb = [], []
    for p0 in range(0, N, tile):
        s_tile = src[p0:p0 + tile]
        g_tile = gamma_r[:, p0:p0 + tile]
        n_real = s_tile.shape[0]
        if n_real < tile:                                       # zero-padded last tile
            s_tile = torch.nn.functional.pad(s_tile, (0, 0, 0, tile - n_real))
            g_tile = torch.nn.functional.pad(g_tile, (0, tile - n_real))
        m_tile = (torch.arange(tile, device=dev) < n_real).to(torch.float32)
        # R·p by a matmul, which adds the K = 3 products as XLA's CPU dot
        # does (fused._dot3_fma: tests/test_torch_grid.py checks the bits)
        pts = s_tile[None] @ Rt + t_c[:, None, :]                # [M,tile,3]
        if backend == "exact":
            d = fused.sqrt_rn(_exact_min_d2(pts, tgt_tiles, tgt_norm_tiles))
            # slack: the f32-cancellation allowance of the expansion
            d_lo = torch.clamp(d - slack, min=0.0)
            d_hi = d + slack
        else:
            val, esc = lookup_sq(grid, pts, lookup)
            d = fused.sqrt_rn(torch.clamp(val, min=0.0))
            d_lo = torch.clamp(d - esc - slack, min=0.0)
            d_hi = d + esc + slack
        ub_c = (d_hi * d_hi) * m_tile
        c = torch.clamp(d_lo - g_tile - gamma_t, min=0.0)
        lb_c = (c * c) * m_tile
        if drop:
            # padding must never occupy inlier slots of the trimmed sums
            inf_pad = (1.0 - m_tile) * 1e30
            ub_c = ub_c + inf_pad
            lb_c = lb_c + inf_pad
        stored_ub.append(ub_c)
        stored_lb.append(lb_c)
    return stored_ub, stored_lb


def tile_sums(terms):
    """``[M, T, tile] → [M]``: each tile's sum, then the tiles in sequence
    (the JAX package's scan carry)."""
    per_tile = fused.ordered_row_sum(terms)
    acc = per_tile[:, 0]
    for k in range(1, per_tile.shape[1]):
        acc = acc + per_tile[:, k]
    return acc


def _angles(max_angle):
    """``max_angle`` is the per-node angles or a ``(centers, spans)`` tuple,
    whose center-aware bound is computed here, on the device."""
    if isinstance(max_angle, tuple):
        return axis_angle_cube_max_angle(*max_angle)
    return max_angle


def se3_round_bounds(src, norms, tgt, slack, thresh, R, max_angle, t_c,
                     t_span, mask, *, h: int, backend: str, grid=None,
                     lookup: str = "nearest", tile: int = 128, tgt_tile: int = 256):
    """The bound half of :func:`se3_round` (singleton nodes)."""
    ang = _angles(max_angle)
    if backend == "screen":
        return evaluate_se3_nodes_screened(
            src, norms, tgt, slack, thresh, R, ang, t_c, t_span, mask, h=h,
        )
    if backend == "mxu":
        return evaluate_se3_nodes_mxu(
            src, norms, tgt, slack, R, ang, t_c, t_span, mask, h=h,
        )
    return evaluate_se3_nodes(
        src, norms, grid, tgt, slack, R, ang, t_c, t_span, mask, h=h,
        lookup=lookup, backend=backend, tile=tile, tgt_tile=tgt_tile,
    )


def se3_round_grouped_bounds(src, norms, tgt, slack, thresh, R, max_angle, t8,
                             t_span8, mask, *, h: int, backend: str, grid=None,
                             lookup: str = "nearest", tile: int = 128,
                             tgt_tile: int = 256):
    """The bound half of :func:`se3_round_grouped`; also returns the
    flattened per-node poses ``(R_flat [8G,3,3], t_flat [8G,3])``.
    Untrimmed T-rounds stay on K3 even when screening, as in the JAX
    package (``se3_eval.py:436``); ``thresh`` is read only by K6.  The
    "exact" and "grid" backends evaluate the flattened nodes."""
    G = R.shape[0]
    ang = _angles(max_angle)
    R_flat = torch.repeat_interleave(R, 8, dim=0)
    t_flat = t8.reshape(8 * G, 3)
    if backend == "screen" and _drop(h, src.shape[0]):
        ub, lb = evaluate_se3_groups_screened(
            src, norms, tgt, slack, thresh, R, ang, t8, t_span8, mask, h=h,
        )
    elif backend in ("mxu", "screen"):
        ub, lb = evaluate_se3_groups_mxu(
            src, norms, tgt, slack, R, ang, t8, t_span8, mask, h=h,
        )
    else:
        ub, lb = evaluate_se3_nodes(
            src, norms, grid, tgt, slack, R_flat, torch.repeat_interleave(ang, 8),
            t_flat, t_span8.reshape(-1), mask, h=h, lookup=lookup, backend=backend,
            tile=tile, tgt_tile=tgt_tile,
        )
    return ub, lb, R_flat, t_flat


def _refine_tail(ub, lb, R, t_c, src, tgt, refine_k, icp_params,
                 refine_gate=None, *, grid=None, tgt_normals=None,
                 icp_backend: str = "exact"):
    """Batched ICP on the ``refine_k`` best-ub nodes (``se3_eval.py:365``),
    on exact or grid correspondences; ``tgt_normals`` (or None) serve the
    plane metric, whose reported sse stays point-to-point.

    ``jax.lax.top_k(-ub, k)`` returns ties lowest index first; a stable
    ascending sort gives the same order (``torch.topk`` promises none).
    Candidates at or above ``refine_gate`` start inactive."""
    from goicp_tpu_torch.icp import exact_correspondence, grid_correspondence, run_icp

    top = torch.sort(ub, stable=True).indices[:refine_k]
    R0 = R.index_select(0, top)
    t0 = t_c.index_select(0, top)
    active0 = None if refine_gate is None else ub.index_select(0, top) < refine_gate
    corr = (
        exact_correspondence(tgt, normals=tgt_normals)
        if icp_backend == "exact"
        else grid_correspondence(grid, tgt, normals=tgt_normals)
    )
    res = run_icp(src, corr, RigidTransform(R0, t0), icp_params, active0=active0)
    return ub, lb, res.transform.R, res.transform.t, res.sse, res.iters


def se3_round(src, norms, tgt, slack, thresh, R, max_angle, t_c, t_span, mask,
              *, h: int, backend: str, refine_k: int, icp_params,
              refine_gate=None, grid=None, tgt_normals=None, lookup: str = "nearest",
              tile: int = 128, tgt_tile: int = 256, icp_backend: str = "exact"):
    """One BnB round over singleton nodes: bounds, then the gated top-k
    refine (``se3_eval.py:302``).  Returns ``(ub, lb, R_ref, t_ref,
    sse_ref, iters_ref)``."""
    ub, lb = se3_round_bounds(
        src, norms, tgt, slack, thresh, R, max_angle, t_c, t_span, mask, h=h,
        backend=backend, grid=grid, lookup=lookup, tile=tile, tgt_tile=tgt_tile,
    )
    return _refine_tail(ub, lb, R, t_c, src, tgt, refine_k, icp_params,
                        refine_gate, grid=grid, tgt_normals=tgt_normals,
                        icp_backend=icp_backend)


def se3_round_grouped(src, norms, tgt, slack, thresh, R, max_angle, t8,
                      t_span8, mask, *, h: int, backend: str, refine_k: int,
                      icp_params, refine_gate=None, grid=None, tgt_normals=None,
                      lookup: str = "nearest", tile: int = 128, tgt_tile: int = 256,
                      icp_backend: str = "exact"):
    """One BnB round over translation-split groups (``se3_eval.py:400``)."""
    ub, lb, R_flat, t_flat = se3_round_grouped_bounds(
        src, norms, tgt, slack, thresh, R, max_angle, t8, t_span8, mask, h=h,
        backend=backend, grid=grid, lookup=lookup, tile=tile, tgt_tile=tgt_tile,
    )
    return _refine_tail(ub, lb, R_flat, t_flat, src, tgt, refine_k,
                        icp_params, refine_gate, grid=grid,
                        tgt_normals=tgt_normals, icp_backend=icp_backend)
