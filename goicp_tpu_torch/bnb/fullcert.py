"""Full-cloud ε-certification by adaptive subset refinement (port of the JAX
package's ``bnb/fullcert.py``).

``bound_points`` caps the BnB to a subset, and the subset-⊆-full transfer
(``GoIcpResult`` field docs) turns the subset certificate into a finite
full-cloud gap.  :func:`register_full_cert` closes it to ε: solve the
subset, transfer the gap, and while ``gap_full`` exceeds the target, grow
the subset with the worst-covered full points and solve again from the
incumbent pose.  A pruned region of one subset objective says nothing about
a grown subset's, so each refinement is a new solve, warm-started.

**Trimmed transfer**: with ``h_s = N_s − (N_f − h_f)`` (the subset solve
drops as many points as the full objective does, out of fewer), every pose
satisfies ``trimmed_full_{h_f}(T) ≥ trimmed_sub_{h_s}(T)``, so the subset
certificate transfers as in the untrimmed case:
``gap_full = trimmed_full(best) − (best_sub − max(gap, ε_s) − 0.01·ε_s)``.
It needs ``N_s > N_f − h_f``; the starting subset holds at least twice the
full drop count.

The coverage order asks K1 for each full point's nearest subset point
(``nn.fused.nearest_neighbor_mxu``; its plain version on the CPU) and
recomputes that distance in f64 on the host, as the JAX package's
``cKDTree`` query reports it.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from goicp_tpu_torch.bnb.params import BnbParams, GoIcpResult
from goicp_tpu_torch.bnb.solver import make_solver
from goicp_tpu_torch.core.device import resolve_device
from goicp_tpu_torch.core.logging import get_logger
from goicp_tpu_torch.nn import fused


def _coverage_order(full: np.ndarray, sub: np.ndarray, device) -> np.ndarray:
    """Indices of ``full`` sorted worst-covered first: descending distance
    to the nearest ``sub`` point, ties in index order (``fullcert.py:58``).
    The nearest index comes from K1 on ``device``, the distance from f64
    on the host."""
    dev = resolve_device(device)
    q = torch.as_tensor(np.asarray(full, np.float32), device=dev)
    t = torch.as_tensor(np.asarray(sub, np.float32), device=dev)
    _, idx = fused.nearest_neighbor_mxu(q, t)
    diff = np.asarray(full, np.float64) - np.asarray(sub, np.float64)[idx.cpu().numpy()]
    d = np.sqrt((diff[:, 0] * diff[:, 0] + diff[:, 1] * diff[:, 1]) + diff[:, 2] * diff[:, 2])
    return np.argsort(-d, kind="stable")


def _subset_sizes(n0: int, N: int, grow: float, max_refinements: int):
    """The subset size of every solve the refinement loop may run."""
    sizes = [n0]
    while sizes[-1] < N and len(sizes) <= max_refinements:
        n = sizes[-1]
        sizes.append(n + min(N - n, max(1, int(round(n * (grow - 1.0))))))
    return sizes


def register_full_cert(
    src,
    tgt,
    params: BnbParams = BnbParams(),
    *,
    target_gap_mse: Optional[float] = None,
    max_refinements: int = 4,
    grow: float = 2.0,
    progress=None,
    grid=None,
    normals=None,
    device=None,
) -> GoIcpResult:
    """Globally-optimal registration whose ε-certificate covers the FULL
    source cloud (``fullcert.py:74``): ``gap_full ≤ target_gap_mse · h_full``
    on exit, or the refinement budget is spent (check ``res.gap_full``).

    ``target_gap_mse`` defaults to ``params.mse_threshold``.  Each
    refinement grows the solve subset ``grow``-fold with the worst-covered
    full points.  The result's ``sse/mse/gap`` describe the last subset
    solve, ``sse_full/mse_full/gap_full`` the full cloud.  Metrics:
    ``fullcert_refinements``, ``fullcert_subset``.  ``device=None`` means
    CUDA."""
    log = get_logger()
    dev = resolve_device(device)
    src = np.asarray(src, np.float32)
    N = src.shape[0]
    trim = params.trim_fraction
    h_f = max(1, int(round(N * (1.0 - trim))))
    drop_f = N - h_f
    eps_target = (params.mse_threshold if target_gap_mse is None else target_gap_mse) * h_f

    n0 = min(params.bound_points, N)
    if trim > 0.0:
        # the over-trimmed subset objective needs a usefully large h_s:
        # start with at least twice the full drop count
        n0 = min(N, max(n0, 2 * drop_f))
    idx = np.sort(np.random.default_rng(777).choice(N, n0, replace=False))

    prior = None
    res = None
    refinements = 0
    while True:
        sub_n = idx.shape[0]
        h_s_plan = sub_n - drop_f if (trim > 0.0 and sub_n < N) else (
            max(1, int(round(sub_n * (1.0 - trim))))
        )
        # the subset solve's own ε rides into the transferred gap, so ε_sub
        # is capped at half the full-cloud budget (fullcert.py:126-134)
        mse_sub = params.mse_threshold
        if mse_sub * h_s_plan > 0.5 * eps_target:
            mse_sub = 0.5 * eps_target / h_s_plan
        if trim > 0.0 and sub_n < N:
            # h_s = N_s − (N_f − h_f): the full objective's drop count
            p_sub = dataclasses.replace(
                params, trim_fraction=drop_f / sub_n, mse_threshold=mse_sub,
                bound_points=1 << 30,
            )
        else:
            p_sub = dataclasses.replace(params, mse_threshold=mse_sub, bound_points=1 << 30)
        solver = make_solver(
            src, tgt, p_sub, progress, device=dev, grid=grid, normals=normals,
            bound_idx=None if sub_n == N else idx,
        )
        if grid is None:
            # the target is the same every refinement: keep the first
            # solver's distance grid (None when no backend reads one)
            grid = solver.grid
        res = solver.run(prior)
        prior = res.transform

        if sub_n == N:
            # the solve was the full cloud: the certificate is direct
            res = dataclasses.replace(
                res, sse_full=res.sse, mse_full=res.mse, gap_full=float(max(res.gap, 0.0))
            )
        elif trim > 0.0:
            # the trimmed transfer; untrimmed solves get gap_full from
            # GoIcpSolver._full_cert.  The slack follows the termination
            # rule, as there; a zero gap may be an emptied frontier, which
            # only guarantees opt ≥ best − ε_s (fullcert.py:166-178)
            eps_s = solver.sse_thresh
            g = max(res.gap, 0.0)
            if res.sse <= eps_s:
                slack_g = min(g, eps_s)
            elif g == 0.0:
                slack_g = eps_s
            else:
                slack_g = g
            sub_opt_lb = res.sse - slack_g - 0.01 * eps_s
            sse_full = solver.score_full(res.transform.R, res.transform.t, trim)
            res = dataclasses.replace(
                res, sse_full=sse_full, mse_full=sse_full / h_f,
                gap_full=float(max(sse_full - max(sub_opt_lb, 0.0), 0.0)),
            )
            log.info("fullcert: trimmed transfer h_s=%d (of %d) → gap_full=%.4g",
                     solver.ev.h, sub_n, res.gap_full)
        res.metrics.counters["fullcert_refinements"] = refinements
        res.metrics.counters["fullcert_subset"] = sub_n

        if (
            (res.gap_full is not None and res.gap_full <= eps_target)
            or sub_n == N or refinements >= max_refinements
        ):
            if res.gap_full is not None and res.gap_full > eps_target:
                log.warning(
                    "fullcert: budget spent at subset %d/%d — gap_full %.4g > target %.4g",
                    sub_n, N, res.gap_full, eps_target,
                )
            return res

        # grow with the worst-covered full points: the coverage radius is
        # what loosens the transfer
        refinements += 1
        k = min(N - sub_n, max(1, int(round(sub_n * (grow - 1.0)))))
        mask = np.zeros(N, bool)
        mask[idx] = True
        order = _coverage_order(src, src[idx], dev)
        new = order[~mask[order]][:k]
        idx = np.sort(np.concatenate([idx, new]))
        log.info(
            "fullcert: gap_full %.4g > target %.4g — refining subset %d → %d points",
            res.gap_full, eps_target, sub_n, idx.shape[0],
        )
