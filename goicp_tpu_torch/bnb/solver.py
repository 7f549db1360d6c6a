"""Go-ICP solver set-up, ICP refinement, scoring and the entry points (port
of the parts of the JAX package's ``bnb/solver.py`` that the flat SE(3)
engine uses).

:func:`register` / :func:`make_solver` build a :class:`GoIcpSolverSE3`
(``bnb/se3.py``).  Options this port does not run yet raise
``NotImplementedError`` naming the ROADMAP item that adds them.
"""

from __future__ import annotations

import dataclasses
import math
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
from goicp_tpu_torch.icp import IcpParams, exact_correspondence, run_icp

_SQRT3 = math.sqrt(3.0)

__all__ = ["BnbParams", "GoIcpResult", "GoIcpSolver", "make_solver", "register"]


def _not_ported(what: str, item: str):
    raise NotImplementedError(f"{what} is not ported yet (ROADMAP queue 1, {item!r})")


def _check_params(params: BnbParams):
    """Enum checks as in the JAX package, then the options outside this
    port's slice."""
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
    if params.engine == "nested":
        _not_ported("engine='nested'", "The nested engine")
    if params.icp_metric == "plane":
        _not_ported("icp_metric='plane'", "geo/normals.py and the plane metric")
    if params.bound_backend in ("exact", "grid"):
        _not_ported(f"bound_backend={params.bound_backend!r}", "The grid backend")
    if max(params.mesh_cubes, params.mesh_points) > 1:
        _not_ported("mesh_cubes/mesh_points > 1", "Distribution")
    if params.checkpoint_path:
        _not_ported("checkpoint_path", "Checkpoint and resume")


class GoIcpSolver:
    """Globally-optimal registration of ``src`` onto ``tgt`` on one device:
    the clouds on the device, the bound constants and the batched ICP
    refiner (``bnb/solver.py:96``).  ``device=None`` means CUDA."""

    def __init__(
        self,
        src: np.ndarray,
        tgt: np.ndarray,
        params: BnbParams = BnbParams(),
        progress: Optional[ProgressBus] = None,
        device=None,
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
        if self.src.shape[0] > params.bound_points:
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
            if n_tgt > params.mxu_max:
                _not_ported(f"{n_tgt} targets (> mxu_max)", "The grid backend")
        # the screened kernel K2 carries untrimmed R-rounds; trimmed solves
        # and screen=False stay on "mxu" (K4 + epilogue), as the JAX package
        # chooses (bnb/solver.py:188-193); bound_backend="screen" opts a
        # trimmed solve in to K5/K6
        if self._backend == "mxu" and params.screen and params.trim_fraction == 0.0:
            self._backend = "screen"
        if n_tgt > params.icp_exact_max:
            _not_ported(f"ICP against {n_tgt} targets (> icp_exact_max)", "The grid backend")
        self._icp_backend = "exact"
        self.grid = None

        self._src_dev = torch.as_tensor(self.src, device=self.device)
        self._tgt_dev = torch.as_tensor(self.tgt, device=self.device)
        self.ev = BoundsEvaluator(self._src_dev, trim_fraction=params.trim_fraction)
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
        # certified-mode numerical slack deducted from lower bounds
        # (bnb/solver.py:285-291); 0 in reference-parity mode
        scale = float(
            np.abs(self.src).max() + np.abs(self.tgt).max()
            + params.trans_span * _SQRT3
        )
        self._exact_slack = (
            math.sqrt(8.0 * 1.2e-7) * scale if params.conservative else 0.0
        )

    # -- batched ICP ---------------------------------------------------------

    def _icp(self, src_dev, tgt_dev, R, t, params: IcpParams):
        """Exact-correspondence ICP of a pose batch (``_exact_icp``)."""
        return run_icp(
            src_dev, exact_correspondence(tgt_dev),
            RigidTransform(self._to(R), self._to(t)), params,
        )

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
            res = self._icp(self._src_dev, self._tgt_dev, Rb, tb, self._icp_params)
            outs.append([
                x.cpu().numpy()[: e - s]
                for x in (res.transform.R, res.transform.t, res.sse, res.iters)
            ])
        return tuple(np.concatenate([o[i] for o in outs]) for i in range(4))

    # -- scoring & full-resolution polish -------------------------------------

    def _score(self, R, t):
        """Solve-objective SSE at exact poses ``[B]`` (``solver.py:339``)."""
        params = IcpParams(max_iter=0, rel_tol=0.0, trim_fraction=self.p.trim_fraction)
        res = self._icp(self._src_dev, self._tgt_dev, R, t, params)
        return res.sse.cpu().numpy()

    def _full_polish(self, best_R, best_t, best_sse):
        """Full-resolution ICP polish when the BnB solved on a
        ``bound_points`` subset; accepted only when the re-scored pose does
        not regress beyond ε/100 (``solver.py:357``)."""
        if self.src_full.shape[0] <= self.src.shape[0]:
            return best_R, best_t, best_sse
        with self.metrics.phase("icp"):
            pres = self._icp(
                self._to(self.src_full), self._tgt_dev,
                best_R[None], best_t[None], self._icp_params,
            )
            R_p = pres.transform.R[0].cpu().numpy()
            t_p = pres.transform.t[0].cpu().numpy()
            self.metrics.counters["full_polish_sse"] = float(pres.sse[0])
            self.metrics.count("icp_iters", int(pres.iters[0]))
            sse_p = float(self._score(R_p[None], t_p[None])[0])
        if sse_p <= best_sse + 0.01 * self.sse_thresh:
            return R_p, t_p, sse_p
        return best_R, best_t, best_sse

    def score_full(self, R, t):
        """(Trimmed) SSE of the FULL source cloud at one pose
        (``solver.py:389``)."""
        params = IcpParams(max_iter=0, rel_tol=0.0, trim_fraction=self.p.trim_fraction)
        res = self._icp(
            self._to(self.src_full), self._tgt_dev,
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
                cres = self._icp(self._to(src_c), self._to(tgt_c), R0, t0, self._icp_params)
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
) -> GoIcpSolver:
    """The flat SE(3) engine on one device (``solver.py:810``, se3 only)."""
    from goicp_tpu_torch.bnb.se3 import GoIcpSolverSE3

    return GoIcpSolverSE3(src, tgt, params, progress, device=device)


def register(
    src,
    tgt,
    params: BnbParams = BnbParams(),
    progress: Optional[ProgressBus] = None,
    device=None,
) -> GoIcpResult:
    """One-call globally-optimal registration (``solver.py:848``)."""
    return make_solver(src, tgt, params, progress, device=device).run()
