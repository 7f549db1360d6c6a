"""SE(3) bound evaluation and the fused round (port of the JAX package's
``bnb/se3_eval.py`` on the fused kernels).

A round evaluates the bounds of a flat batch of nodes and then ICP-refines
the ``refine_k`` best-ub nodes (``_refine_tail``).  The bound backends:

- R-rounds (singleton nodes, :func:`se3_round`): "screen" runs the screened
  kernel K2, or K5 when trimmed; "mxu" runs K4's per-point distances and
  the deflation epilogue, with trimmed sums by bisection when trimmed.
- T-rounds (8 translation siblings per rotation, :func:`se3_round_grouped`):
  the grouped kernel K3 and the epilogue, on both backends; trimmed
  "screen" T-rounds run K6 instead.

Everything stays queued on the device; the round driver (``bnb.rounds``)
runs the refine tail when it absorbs the round.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from goicp_tpu_torch.core.types import RigidTransform
from goicp_tpu_torch.geo.rotation import (
    axis_angle_cube_max_angle,
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
    M, Np = d2.shape
    drop = _drop(h, N)
    d = torch.sqrt(torch.clamp(d2, min=0.0))
    d_lo = torch.clamp(d - slack, min=0.0)
    d_hi = d + slack
    gamma_r = rotation_displacement(max_angle, norms)     # [M, N]
    if Np > N:
        gamma_r = torch.nn.functional.pad(gamma_r, (0, Np - N))
    gamma_t = (_SQRT3 * t_span)[:, None]
    pmask = (torch.arange(Np, device=d2.device) < N).to(torch.float32)[None, :]
    ub_c = (d_hi * d_hi) * pmask
    c = torch.clamp(d_lo - gamma_r - gamma_t, min=0.0)
    lb_c = (c * c) * pmask
    if drop:
        inf_pad = (1.0 - pmask) * 1e30
        s_ub = _trimmed_sum_bisect(ub_c + inf_pad, h, upper=True)
        s_lb = _trimmed_sum_bisect(lb_c + inf_pad, h, upper=False)
    else:
        s_ub = ub_c.sum(-1)
        s_lb = lb_c.sum(-1)
    return _masked(mask, s_ub, s_lb)


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
    af = 2.0 * torch.sin(torch.clamp(max_angle, max=math.pi) / 2.0)
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
    af = 2.0 * torch.sin(torch.clamp(max_angle, max=math.pi) / 2.0)   # [G]
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


def _angles(max_angle):
    """``max_angle`` is the per-node angles or a ``(centers, spans)`` tuple,
    whose center-aware bound is computed here, on the device."""
    if isinstance(max_angle, tuple):
        return axis_angle_cube_max_angle(*max_angle)
    return max_angle


def _backend_ported(backend: str, kind: str):
    if backend not in ("mxu", "screen"):
        raise NotImplementedError(
            f"{kind} on backend {backend!r} are not ported yet (ROADMAP queue 1, "
            "'The grid backend')"
        )


def se3_round_bounds(src, norms, tgt, slack, thresh, R, max_angle, t_c,
                     t_span, mask, *, h: int, backend: str):
    """The bound half of :func:`se3_round` (singleton nodes)."""
    _backend_ported(backend, "R-rounds")
    ang = _angles(max_angle)
    if backend == "screen":
        return evaluate_se3_nodes_screened(
            src, norms, tgt, slack, thresh, R, ang, t_c, t_span, mask, h=h,
        )
    return evaluate_se3_nodes_mxu(
        src, norms, tgt, slack, R, ang, t_c, t_span, mask, h=h,
    )


def se3_round_grouped_bounds(src, norms, tgt, slack, thresh, R, max_angle, t8,
                             t_span8, mask, *, h: int, backend: str):
    """The bound half of :func:`se3_round_grouped`; also returns the
    flattened per-node poses ``(R_flat [8G,3,3], t_flat [8G,3])``.
    Untrimmed T-rounds stay on K3 even when screening, as in the JAX
    package (``se3_eval.py:436``); ``thresh`` is read only by K6."""
    _backend_ported(backend, "T-rounds")
    G = R.shape[0]
    ang = _angles(max_angle)
    if backend == "screen" and _drop(h, src.shape[0]):
        ub, lb = evaluate_se3_groups_screened(
            src, norms, tgt, slack, thresh, R, ang, t8, t_span8, mask, h=h,
        )
    else:
        ub, lb = evaluate_se3_groups_mxu(
            src, norms, tgt, slack, R, ang, t8, t_span8, mask, h=h,
        )
    return ub, lb, torch.repeat_interleave(R, 8, dim=0), t8.reshape(8 * G, 3)


def _refine_tail(ub, lb, R, t_c, src, tgt, refine_k, icp_params,
                 refine_gate=None):
    """Batched ICP on the ``refine_k`` best-ub nodes (``se3_eval.py:365``).

    ``jax.lax.top_k(-ub, k)`` returns ties lowest index first; a stable
    ascending sort gives the same order (``torch.topk`` promises none).
    Candidates at or above ``refine_gate`` start inactive."""
    from goicp_tpu_torch.icp import exact_correspondence, run_icp

    top = torch.sort(ub, stable=True).indices[:refine_k]
    R0 = R.index_select(0, top)
    t0 = t_c.index_select(0, top)
    active0 = None if refine_gate is None else ub.index_select(0, top) < refine_gate
    res = run_icp(
        src, exact_correspondence(tgt), RigidTransform(R0, t0), icp_params,
        active0=active0,
    )
    return ub, lb, res.transform.R, res.transform.t, res.sse, res.iters


def se3_round(src, norms, tgt, slack, thresh, R, max_angle, t_c, t_span, mask,
              *, h: int, backend: str, refine_k: int, icp_params,
              refine_gate=None):
    """One BnB round over singleton nodes: bounds, then the gated top-k
    refine (``se3_eval.py:302``).  Returns ``(ub, lb, R_ref, t_ref,
    sse_ref, iters_ref)``."""
    ub, lb = se3_round_bounds(
        src, norms, tgt, slack, thresh, R, max_angle, t_c, t_span, mask, h=h,
        backend=backend,
    )
    return _refine_tail(ub, lb, R, t_c, src, tgt, refine_k, icp_params,
                        refine_gate)


def se3_round_grouped(src, norms, tgt, slack, thresh, R, max_angle, t8,
                      t_span8, mask, *, h: int, backend: str, refine_k: int,
                      icp_params, refine_gate=None):
    """One BnB round over translation-split groups (``se3_eval.py:400``)."""
    ub, lb, R_flat, t_flat = se3_round_grouped_bounds(
        src, norms, tgt, slack, thresh, R, max_angle, t8, t_span8, mask, h=h,
        backend=backend,
    )
    return _refine_tail(ub, lb, R_flat, t_flat, src, tgt, refine_k,
                        icp_params, refine_gate)
