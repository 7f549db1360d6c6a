"""SE(3) bound evaluation and the fused round (port of the JAX package's
``bnb/se3_eval.py``, untrimmed, on the fused kernels).

A round evaluates the bounds of a flat batch of nodes — singleton nodes
through the screened kernel K2 (``se3_round``), or 8 translation siblings
per rotation through the grouped kernel K3 plus the deflation epilogue
(``se3_round_grouped``) — and then ICP-refines the ``refine_k`` best-ub
nodes (``_refine_tail``).  Everything stays queued on the device; the round
driver (``bnb.rounds``) runs the refine tail when it absorbs the round.
"""

from __future__ import annotations

import math

import torch

from goicp_tpu_torch.core.types import RigidTransform
from goicp_tpu_torch.geo.rotation import (
    axis_angle_cube_max_angle,
    rotation_displacement,
)
from goicp_tpu_torch.nn import fused

_SQRT3 = math.sqrt(3.0)
_INF = float("inf")


def _untrimmed(h: int, N: int):
    if h not in (0, N):
        raise NotImplementedError(
            "trimmed bounds are not ported yet (ROADMAP queue 1, 'The trimmed "
            "path': kernels K4-K6)"
        )


def _deflate_and_reduce(d2, norms, slack, max_angle, t_span, mask, *,
                        h: int, N: int):
    """Bound epilogue over per-node exact distances ``d2 [M, Np]``: Yang et
    al. eq. 10 deflation by the per-point rotation radius and the
    translation corner radius, then sums (``se3_eval.py:60``, untrimmed)."""
    _untrimmed(h, N)
    M, Np = d2.shape
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
    s_ub = ub_c.sum(-1)
    s_lb = lb_c.sum(-1)
    inf = torch.full_like(s_ub, _INF)
    return torch.where(mask, s_ub, inf), torch.where(mask, s_lb, inf)


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


def evaluate_se3_nodes_screened(src, norms, tgt, slack, thresh, R, max_angle,
                                t_c, t_span, mask, *, h: int):
    """Screened bounds of singleton nodes through K2 (``se3_eval.py:237``,
    untrimmed).  Masked (padding) rows get threshold −inf, so the kernel
    skips them at once; their outputs are replaced by +inf either way."""
    N = src.shape[0]
    _untrimmed(h, N)
    af = 2.0 * torch.sin(torch.clamp(max_angle, max=math.pi) / 2.0)
    gt = _SQRT3 * t_span
    params = fused.pack_params_bounds(R, t_c, af, gt, slack, thresh)
    params[:, 15] = torch.where(mask, params[:, 15], -_INF)
    ub, lb = fused.bounds_nodes(
        fused.pack_sources_ext(src, norms), fused.pack_targets(tgt), params
    )
    inf = torch.full_like(ub, _INF)
    return torch.where(mask, ub, inf), torch.where(mask, lb, inf)


def _angles(max_angle):
    """``max_angle`` is the per-node angles or a ``(centers, spans)`` tuple,
    whose center-aware bound is computed here, on the device."""
    if isinstance(max_angle, tuple):
        return axis_angle_cube_max_angle(*max_angle)
    return max_angle


def se3_round_bounds(src, norms, tgt, slack, thresh, R, max_angle, t_c,
                     t_span, mask, *, h: int):
    """The bound half of :func:`se3_round` (screened singleton nodes)."""
    return evaluate_se3_nodes_screened(
        src, norms, tgt, slack, thresh, R, _angles(max_angle), t_c, t_span,
        mask, h=h,
    )


def se3_round_grouped_bounds(src, norms, tgt, slack, R, max_angle, t8,
                             t_span8, mask, *, h: int):
    """The bound half of :func:`se3_round_grouped`; also returns the
    flattened per-node poses ``(R_flat [8G,3,3], t_flat [8G,3])``."""
    G = R.shape[0]
    ub, lb = evaluate_se3_groups_mxu(
        src, norms, tgt, slack, R, _angles(max_angle), t8, t_span8, mask, h=h,
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
    sse_ref, iters_ref)``.  ``backend`` must be "screen" (the fused
    unscreened "mxu" R-round runs K4, not ported yet)."""
    if backend != "screen":
        raise NotImplementedError(
            f"R-rounds on backend {backend!r} are not ported yet: 'mxu' without "
            "the screen needs kernel K4 (ROADMAP queue 2), 'exact'/'grid' the "
            "XLA and grid backends (ROADMAP queue 1)"
        )
    ub, lb = se3_round_bounds(
        src, norms, tgt, slack, thresh, R, max_angle, t_c, t_span, mask, h=h,
    )
    return _refine_tail(ub, lb, R, t_c, src, tgt, refine_k, icp_params,
                        refine_gate)


def se3_round_grouped(src, norms, tgt, slack, thresh, R, max_angle, t8,
                      t_span8, mask, *, h: int, backend: str, refine_k: int,
                      icp_params, refine_gate=None):
    """One BnB round over translation-split groups (``se3_eval.py:400``):
    untrimmed T-rounds run the unscreened grouped kernel K3 on both the
    "mxu" and "screen" backends, as in the JAX package."""
    del thresh  # untrimmed T-rounds are never screened
    if backend not in ("mxu", "screen"):
        raise NotImplementedError(
            f"T-rounds on backend {backend!r} are not ported yet (ROADMAP "
            "queue 1, 'The grid backend')"
        )
    ub, lb, R_flat, t_flat = se3_round_grouped_bounds(
        src, norms, tgt, slack, R, max_angle, t8, t_span8, mask, h=h,
    )
    return _refine_tail(ub, lb, R_flat, t_flat, src, tgt, refine_k,
                        icp_params, refine_gate)
