"""Go-ICP solver set-up, ICP refinement, scoring, checkpoint files and the
entry points (port of the JAX package's ``bnb/solver.py``).

:func:`register` / :func:`make_solver` build a :class:`GoIcpSolverSE3`
(``bnb/se3.py``, the flat product-space engine) or, for
``engine="nested"``, a :class:`GoIcpSolverNested` (``bnb/nested.py``).
Set-up picks the bound backend (``auto_backend``: the fused kernels up to
``mxu_max`` targets, the distance grid above) and the ICP backend (exact
correspondences up to ``icp_exact_max`` targets, the grid's index field
above), builds the distance grid when either needs it (or reuses a
caller's ``grid=``), and estimates target normals for
``icp_metric="plane"`` (or takes a caller's ``normals=``).  ``bound_idx``
pins the solve subset (full-cloud certification, ``bnb/fullcert.py``).
``mesh_cubes``/``mesh_points`` shard the SE(3) engine's rounds over a
device mesh of this process (``dist/se3.py``); under an initialised
``torch.distributed`` group of more than one process :func:`make_solver`
builds the frontier-sharded multi-process engine (``dist/multihost.py``).
"""

from __future__ import annotations

import dataclasses
import math
import os
from typing import Optional

import numpy as np
import torch

from goicp_tpu_torch.bnb.bounds import BoundsEvaluator
from goicp_tpu_torch.bnb.params import BnbParams, GoIcpResult, auto_backend
from goicp_tpu_torch.bnb.rotparam import _PARAMS
from goicp_tpu_torch.core.device import resolve_device
from goicp_tpu_torch.core.logging import get_logger
from goicp_tpu_torch.core.metrics import Metrics
from goicp_tpu_torch.core.progress import ProgressBus
from goicp_tpu_torch.core.types import RigidTransform
from goicp_tpu_torch.geo.normals import estimate_normals
from goicp_tpu_torch.icp import (
    IcpParams,
    exact_correspondence,
    grid_correspondence,
    run_icp,
)
from goicp_tpu_torch.nn.grid import build_distance_grid

_SQRT3 = math.sqrt(3.0)

__all__ = ["BnbParams", "GoIcpResult", "GoIcpSolver", "make_solver", "register"]

_CHECKPOINT_KEYS = ("payload", "lb", "ub", "best_R", "best_t", "best_sse", "leaf_lb",
                    "rounds", "nodes")


def _check_params(params: BnbParams):
    """Enum checks as in the JAX package."""
    if params.icp_metric not in ("point", "plane"):
        raise ValueError(f"icp_metric must be 'point' or 'plane', got {params.icp_metric!r}")
    if params.engine not in ("se3", "nested"):
        raise ValueError(f"engine must be 'se3' or 'nested', got {params.engine!r}")
    if params.bound_backend not in ("auto", "mxu", "exact", "grid", "screen"):
        raise ValueError(
            "bound_backend must be one of auto/mxu/exact/grid/screen, "
            f"got {params.bound_backend!r}"
        )
    if params.lookup not in ("nearest", "trilinear"):
        raise ValueError(f"lookup must be 'nearest' or 'trilinear', got {params.lookup!r}")
    if params.rotation_param not in _PARAMS:
        raise ValueError(
            f"rotation_param must be one of {sorted(_PARAMS)}, got {params.rotation_param!r}"
        )


def save_checkpoint(path: str, payload, lb, ub, best_R, best_t, best_sse: float,
                    leaf_lb: float, rounds: int, nodes: int):
    """Write a BnB snapshot in the JAX package's ``np.savez`` format
    (``se3.py:170``, ``solver.py:587``), through a temporary file and an
    atomic rename, so either package resumes the other's."""
    tmp = path + ".tmp.npz"
    np.savez(
        tmp, payload=payload, lb=lb, ub=ub,
        best_R=np.asarray(best_R), best_t=np.asarray(best_t),
        best_sse=np.float32(best_sse), leaf_lb=np.float32(leaf_lb),
        rounds=np.int64(rounds), nodes=np.int64(nodes),
    )
    os.replace(tmp, path)


def load_checkpoint(path: str) -> dict:
    """A snapshot written by :func:`save_checkpoint` (or the JAX package)."""
    with np.load(path) as ck:
        return {k: ck[k] for k in _CHECKPOINT_KEYS}


class GoIcpSolver:
    """Globally-optimal registration of ``src`` onto ``tgt`` on one device:
    the clouds on the device, the distance grid and target normals where
    needed, the bound constants and the batched ICP refiner
    (``bnb/solver.py:96``).  ``device=None`` means CUDA.  ``grid`` and
    ``normals`` are a caller's distance grid and target normals, reused
    when they serve this solve; ``bound_idx`` is an explicit solve subset
    of ``src``."""

    def __init__(
        self,
        src: np.ndarray,
        tgt: np.ndarray,
        params: BnbParams = BnbParams(),
        progress: Optional[ProgressBus] = None,
        device=None,
        grid=None,
        normals=None,
        bound_idx=None,
    ):
        _check_params(params)
        self.device = resolve_device(device)
        self.src_full = np.asarray(src, np.float32)
        self.src = self.src_full
        self.tgt = np.asarray(tgt, np.float32)
        self.p = params
        self.progress = progress or ProgressBus()
        self.metrics = Metrics()
        self.log = get_logger()
        if bound_idx is not None:
            # explicit solve subset (bnb.fullcert grows it between
            # refinements with the worst-covered points)
            self.src = self.src_full[np.sort(np.asarray(bound_idx))]
            self.log.info(
                "BnB solves on an explicit %d-point subset of %d",
                self.src.shape[0], self.src_full.shape[0],
            )
        elif self.src.shape[0] > params.bound_points:
            # deterministic thinning for the solve; the full cloud is kept
            # for the final polish
            idx = np.random.default_rng(777).choice(
                self.src.shape[0], params.bound_points, replace=False
            )
            self.src = self.src_full[np.sort(idx)]
            self.log.info(
                "BnB solves on %d of %d source points (bound_points cap)",
                self.src.shape[0], self.src_full.shape[0],
            )

        n_tgt = self.tgt.shape[0]
        if params.bound_backend == "auto":
            self._backend = auto_backend(params, n_tgt)
        else:
            self._backend = params.bound_backend
        # the screened kernel K2 carries untrimmed R-rounds; trimmed solves
        # and screen=False stay on "mxu" (K4 + epilogue), as the JAX package
        # chooses (bnb/solver.py:188-193); bound_backend="screen" opts a
        # trimmed solve in to K5/K6
        if self._backend == "mxu" and params.screen and params.trim_fraction == 0.0:
            self._backend = "screen"
        # exact NN ICP while it stays cheap (true SSE, tighter incumbents),
        # the grid's index field for large targets
        self._icp_backend = "exact" if n_tgt <= params.icp_exact_max else "grid"

        self._src_dev = torch.as_tensor(self.src, device=self.device)
        self._tgt_dev = torch.as_tensor(self.tgt, device=self.device)
        self.grid = self._grid(grid)
        self.ev = BoundsEvaluator(
            self._src_dev, self.grid, trim_fraction=params.trim_fraction,
            lookup=params.lookup, conservative=params.conservative,
        )
        self.rotparam = _PARAMS[params.rotation_param]
        # SSEThresh = MSEThresh * inlierNum (jly_goicp.cpp:199-208)
        self.sse_thresh = params.mse_threshold * self.ev.h
        self._icp_params = IcpParams(
            max_iter=params.icp_max_iter,
            rel_tol=params.icp_rel_tol,
            trim_fraction=params.trim_fraction,
            metric=params.icp_metric,
        )
        # in-round refines discover incumbents, capped at refine_max_iter;
        # the multistart and the final polish keep icp_max_iter
        self._icp_params_round = dataclasses.replace(
            self._icp_params,
            max_iter=min(params.icp_max_iter, params.refine_max_iter),
        )
        # a mesh round refines on the point metric (no normals on its
        # path, solver.py:261); both refine directions are sound, since the
        # reported sse is point-to-point either way
        self._icp_params_round_mesh = dataclasses.replace(
            self._icp_params_round, metric="point"
        )
        # plane-metric refinement descends the point-to-plane objective, but
        # incumbents are always the point-SSE best pose, so pruning and the
        # ε-certificate do not depend on the metric (solver.py:266-279)
        self._nrm_dev = None
        if params.icp_metric == "plane":
            self._nrm_dev = (
                torch.as_tensor(normals, dtype=torch.float32, device=self.device)
                if normals is not None
                else estimate_normals(self._tgt_dev, k=params.normals_k)
            )
        # certified-mode numerical slack deducted from lower bounds
        # (bnb/solver.py:285-291); 0 in reference-parity mode
        scale = float(
            np.abs(self.src).max() + np.abs(self.tgt).max()
            + params.trans_span * _SQRT3
        )
        self._exact_slack = (
            math.sqrt(8.0 * 1.2e-7) * scale if params.conservative else 0.0
        )

    def _grid(self, grid=None):
        """The distance grid the backends need (``solver.py:201-231``): the
        bounds read it on "grid", the ICP reads its index field on the
        "grid" ICP backend.  A caller's ``grid`` of at least
        ``grid_resolution`` cells a side, with an index field where the ICP
        needs one, is reused; otherwise one is built (phase
        ``grid_build``).  With neither backend on the grid there is none:
        the JAX package's vestigial 8³ grid has no reader here."""
        p = self.p
        need_bounds = self._backend == "grid"
        need_index = self._icp_backend == "grid"
        if not (need_bounds or need_index):
            return None
        if (grid is not None and grid.n >= p.grid_resolution
                and (grid.indices is not None or not need_index)):
            return grid
        with self.metrics.phase("grid_build"):
            g = build_distance_grid(
                self._tgt_dev, n=p.grid_resolution, expand=p.grid_expand,
                method=p.grid_method, with_index=need_index,
            )
            if self.device.type == "cuda":
                torch.cuda.synchronize(self.device)
        return g

    # -- batched ICP ---------------------------------------------------------

    def _icp(self, src_dev, R, t, params: IcpParams, normals=None, tgt_dev=None,
             backend: Optional[str] = None):
        """ICP of a pose batch on the solver's ICP backend (``_exact_icp`` /
        ``_grid_icp``), or on ``backend``; ``tgt_dev`` replaces the target
        cloud of an exact correspondence (the coarse multistart's subset)."""
        tgt = self._tgt_dev if tgt_dev is None else tgt_dev
        if (backend or self._icp_backend) == "exact":
            corr = exact_correspondence(tgt, normals=normals)
        else:
            corr = grid_correspondence(self.grid, tgt, normals=normals)
        return run_icp(src_dev, corr, RigidTransform(self._to(R), self._to(t)), params)

    def _to(self, x):
        return torch.as_tensor(np.asarray(x, np.float32), device=self.device)

    def _refine(self, R: np.ndarray, t: np.ndarray):
        """ICP of ``[B]`` poses in chunks padded to ``icp_cap``."""
        B = R.shape[0]
        cap = self.p.icp_cap
        outs = []
        for s in range(0, B, cap):
            e = min(s + cap, B)
            pad = cap - (e - s)
            Rb = np.concatenate([R[s:e], np.tile(np.eye(3, dtype=np.float32), (pad, 1, 1))])
            tb = np.concatenate([t[s:e], np.zeros((pad, 3), np.float32)])
            res = self._icp(self._src_dev, Rb, tb, self._icp_params, normals=self._nrm_dev)
            outs.append([
                x.cpu().numpy()[: e - s]
                for x in (res.transform.R, res.transform.t, res.sse, res.iters)
            ])
        return tuple(np.concatenate([o[i] for o in outs]) for i in range(4))

    # -- scoring & full-resolution polish -------------------------------------

    def _score(self, R, t):
        """Solve-objective SSE at exact poses ``[B]`` (``solver.py:339``)."""
        params = IcpParams(max_iter=0, rel_tol=0.0, trim_fraction=self.p.trim_fraction)
        return self._icp(self._src_dev, R, t, params).sse.cpu().numpy()

    def _full_polish(self, best_R, best_t, best_sse):
        """Full-resolution ICP polish when the BnB solved on a
        ``bound_points`` subset; accepted only when the re-scored pose does
        not regress beyond ε/100 (``solver.py:357``)."""
        if self.src_full.shape[0] <= self.src.shape[0]:
            return best_R, best_t, best_sse
        with self.metrics.phase("icp"):
            pres = self._icp(
                self._to(self.src_full), best_R[None], best_t[None], self._icp_params,
                normals=self._nrm_dev,
            )
            R_p = pres.transform.R[0].cpu().numpy()
            t_p = pres.transform.t[0].cpu().numpy()
            self.metrics.counters["full_polish_sse"] = float(pres.sse[0])
            self.metrics.count("icp_iters", int(pres.iters[0]))
            sse_p = float(self._score(R_p[None], t_p[None])[0])
        if sse_p <= best_sse + 0.01 * self.sse_thresh:
            return R_p, t_p, sse_p
        return best_R, best_t, best_sse

    def score_full(self, R, t, trim_fraction: Optional[float] = None):
        """(Trimmed) SSE of the FULL source cloud at one pose, at the solve's
        trim fraction or ``trim_fraction`` (``solver.py:389``)."""
        trim = self.p.trim_fraction if trim_fraction is None else trim_fraction
        params = IcpParams(max_iter=0, rel_tol=0.0, trim_fraction=trim)
        res = self._icp(
            self._to(self.src_full),
            np.asarray(R, np.float32)[None], np.asarray(t, np.float32)[None], params,
        )
        return float(res.sse[0])

    def _full_cert(self, best_R, best_t, best_sse, gap):
        """Full-cloud certificate under ``bound_points``: ``(sse_full,
        mse_full, gap_full)``, all None when the BnB solved the whole cloud,
        ``gap_full`` None when trimmed (``solver.py:410``; the derivation
        of the slack is there)."""
        n_full = self.src_full.shape[0]
        if n_full <= self.src.shape[0]:
            return None, None, None
        sse_full = self.score_full(best_R, best_t)
        h_full = max(1, int(round(n_full * (1.0 - self.p.trim_fraction))))
        mse_full = sse_full / h_full
        if self.p.trim_fraction > 0.0:
            # no gap at equal trim fractions: the h_full smallest full-cloud
            # terms need not contain the h_sub smallest subset terms, so the
            # subset-⊆-full inequality fails between trimmed sums
            # (solver.py:423-431; the sound transfer is register_full_cert)
            return sse_full, mse_full, None
        if not math.isfinite(gap):
            slack_g = self.sse_thresh
        else:
            g = max(gap, 0.0)
            slack_g = min(g, self.sse_thresh) if best_sse <= self.sse_thresh else g
        sub_opt_lb = best_sse - slack_g - 0.01 * self.sse_thresh
        return sse_full, mse_full, float(max(sse_full - max(sub_opt_lb, 0.0), 0.0))

    # -- initial incumbent ----------------------------------------------------

    def _initial_icp(self, init: Optional[RigidTransform] = None):
        """Batched coarse-to-fine multistart ICP (``solver.py:462``): identity
        + deterministic random rotations with centroid-matching translations,
        first on ``init_coarse_n``-point subsets, then the best few at full
        resolution."""
        p, m = self.p, self.metrics
        with m.phase("icp"):
            seeds = [np.eye(3, dtype=np.float32)]
            if init is not None:
                seeds.append(np.asarray(init.R, np.float32))
            k = max(0, p.init_multistart - len(seeds))
            if k:
                from goicp_tpu_torch.geo.rotation import random_rotations

                seeds.append(random_rotations(k, np.random.default_rng(12345)))
            R0 = np.concatenate([s.reshape(-1, 3, 3) for s in seeds])
            mu_s, mu_t = self.src.mean(0), self.tgt.mean(0)
            t0 = mu_t[None, :] - np.einsum("bij,j->bi", R0, mu_s)
            if init is not None:
                t0[1] = np.asarray(init.t, np.float32)
            t0[0] = 0.0  # keep the reference's identity start exact
            t0 = t0.astype(np.float32)

            nc = p.init_coarse_n
            if 0 < nc < min(self.src.shape[0], self.tgt.shape[0]) // 2 \
                    and R0.shape[0] > 4:
                crng = np.random.default_rng(424242)
                src_c = self.src[
                    np.sort(crng.choice(self.src.shape[0], nc, replace=False))
                ]
                tidx = np.sort(crng.choice(self.tgt.shape[0], nc, replace=False))
                tgt_c = self.tgt[tidx]
                # the full cloud's normals at the subset rows (solver.py:504)
                nrm_c = (
                    None if self._nrm_dev is None
                    else self._nrm_dev.index_select(0, torch.as_tensor(tidx, device=self.device))
                )
                cres = self._icp(self._to(src_c), R0, t0, self._icp_params, normals=nrm_c,
                                 tgt_dev=self._to(tgt_c), backend="exact")
                cR, ct, c_sse, c_it = (
                    x.cpu().numpy()
                    for x in (cres.transform.R, cres.transform.t, cres.sse, cres.iters)
                )
                m.count("icp_iters", int(c_it.sum()))
                keep = max(16, p.refine_top_k)
                top = np.argsort(c_sse)[:keep]
                pinned = [0] + ([1] if init is not None else [])
                sel = np.unique(np.concatenate([np.asarray(pinned), top]))
                # warm full-res starts from the coarse-converged poses
                # (pinned seeds keep their original exact starts)
                R0w = cR[sel]
                t0w = ct[sel]
                for j, s in enumerate(sel):
                    if s in pinned:
                        R0w[j], t0w[j] = R0[s], t0[s]
                R0, t0 = R0w.astype(np.float32), t0w.astype(np.float32)

            Rs, ts, sses, iters = self._refine(R0, t0)
            m.count("icp_iters", int(iters.sum()))
            j = int(np.argmin(sses))
            return Rs[j], ts[j], float(sses[j])


def make_solver(
    src,
    tgt,
    params: BnbParams = BnbParams(),
    progress: Optional[ProgressBus] = None,
    device=None,
    grid=None,
    normals=None,
    bound_idx=None,
    local: bool = False,
) -> GoIcpSolver:
    """Engine dispatch (``solver.py:810``): the flat SE(3) engine ("se3",
    the default) or the nested one ("nested").  Under an initialised
    ``torch.distributed`` group of more than one process the SE(3) engine
    is the frontier-sharded :class:`~goicp_tpu_torch.dist.multihost.GoIcpSolverMultiHost`
    (every process calls this with the same clouds and params), unless
    ``local``: the collective-free engine, for work already split between
    processes (``register_pairs_distributed``)."""
    kw = dict(device=device, grid=grid, normals=normals, bound_idx=bound_idx)
    if params.engine == "nested":
        from goicp_tpu_torch.bnb.nested import GoIcpSolverNested

        return GoIcpSolverNested(src, tgt, params, progress, **kw)
    if not local and _world_size() > 1:
        from goicp_tpu_torch.dist.multihost import GoIcpSolverMultiHost

        return GoIcpSolverMultiHost(src, tgt, params, progress, **kw)
    from goicp_tpu_torch.bnb.se3 import GoIcpSolverSE3

    return GoIcpSolverSE3(src, tgt, params, progress, **kw)


def _world_size() -> int:
    """Processes in the initialised default ``torch.distributed`` group
    (1 without one)."""
    import torch.distributed as dist

    return dist.get_world_size() if dist.is_available() and dist.is_initialized() else 1


def register(
    src,
    tgt,
    params: BnbParams = BnbParams(),
    progress: Optional[ProgressBus] = None,
    device=None,
    grid=None,
    normals=None,
) -> GoIcpResult:
    """One-call globally-optimal registration (``solver.py:848``)."""
    return make_solver(src, tgt, params, progress, device=device, grid=grid,
                       normals=normals).run()
