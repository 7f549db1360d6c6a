"""Resident-target registration services (port of the JAX package's
``serving/service.py``).

A service keeps what is expensive resident between queries — the target on
the device, its distance grid, target normals and the tracking path's ICP
closures — so a query pays only its own compute.  Goicp queries run the
lockstep driver (:mod:`goicp_tpu_torch.multipair_lockstep`) against the
shared target, so P queries advance through one round at a time; icp
queries refine in one batched ICP on K1 (or the grid's index field above
``icp_exact_max`` targets).  One lock serialises the device work of a
service (and of every target of a :class:`MultiTargetService`).
"""

from __future__ import annotations

import dataclasses
import threading
import time
from collections import OrderedDict
from typing import List, Optional, Sequence

import numpy as np
import torch

from goicp_tpu_torch.bnb import BnbParams, GoIcpResult, make_solver
from goicp_tpu_torch.core.device import resolve_device, to_device
from goicp_tpu_torch.core.logging import get_logger
from goicp_tpu_torch.core.metrics import Metrics
from goicp_tpu_torch.core.types import RigidTransform
from goicp_tpu_torch.geo.normals import estimate_normals
from goicp_tpu_torch.geo.rotation import random_rotations
from goicp_tpu_torch.icp import IcpParams, exact_correspondence, grid_correspondence, run_icp
from goicp_tpu_torch import multipair_lockstep
from goicp_tpu_torch.multipair import lockstep_compatible, register_pairs
from goicp_tpu_torch.nn.grid import build_distance_grid

_QUERY_KEYS = (
    "source", "points", "subsample", "seed", "resize", "id", "init", "mode",
    "target",
)
# per-query BnbParams overrides accepted over the wire: the solve-semantics
# knobs a client may tune; device and engine topology stay the operator's
_PARAM_KEYS = (
    "mse_threshold", "trim_fraction", "max_rounds", "max_wall_s",
    "init_multistart", "icp_metric", "escalate_mse",
)


class RegistrationService:
    """Holds one target resident on the device and registers query sources
    against it (``service.py:41``).

    ``params`` are the solve defaults (per-query overrides through the
    whitelisted keys).  The distance grid is built once at the service's
    ``grid_resolution`` with its index field, for the single-query solver's
    grid backends and the grid ICP above ``icp_exact_max`` targets.
    ``source_root``: None lets ``{"source": <path>}`` queries read any path
    (trusted local stdio), "" disables paths, a directory confines them
    under it.  ``max_points`` rejects larger queries; ``bucket_shapes``
    pads query sizes to :meth:`_bucket` sizes (weight-0 rows, exact);
    ``icp_cache_size`` caps the tracking path's closures (one per
    parameter override combination).  ``device=None`` means CUDA.
    """

    def __init__(
        self,
        target: np.ndarray,
        params: BnbParams = BnbParams(),
        name: str = "target",
        source_root: Optional[str] = None,
        max_points: int = 1 << 20,
        bucket_shapes: bool = True,
        icp_cache_size: int = 16,
        device=None,
    ):
        self.device = resolve_device(device)
        self.tgt = np.asarray(target, np.float32)
        self.params = params
        self.name = name
        self.source_root = source_root
        self.max_points = int(max_points)
        self.bucket_shapes = bool(bucket_shapes)
        self.icp_cache_size = max(1, int(icp_cache_size))
        self.log = get_logger()
        self.escalations = 0            # tracking-loss escalations served
        self._lock = threading.Lock()   # one device, one solve at a time
        # reentrant (_icp_setup calls _normals): the host caches may be hit
        # from several threads before the device lock
        self._cache_lock = threading.RLock()
        self.queries = 0
        self._tgt_dev = to_device(self.tgt, self.device)
        self._nrm_dev: dict = {}        # normals_k -> device target normals
        self._icp_cache: OrderedDict = OrderedDict()   # params key -> (IcpParams, corr, refine_fn)
        t0 = time.perf_counter()
        self.grid = build_distance_grid(
            self._tgt_dev, n=params.grid_resolution, expand=params.grid_expand,
            method=params.grid_method, with_index=True,
        )
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        self.log.info(
            "service '%s': target %d pts resident, %d³ field built in %.2fs",
            name, self.tgt.shape[0], self.grid.n, time.perf_counter() - t0,
        )

    def resolve(self, name: Optional[str] = None) -> "RegistrationService":
        """Single-target service: accepts only its own name (or none)."""
        if name is None or name == self.name:
            return self
        raise ValueError(
            f"unknown target {name!r}; this server serves only {self.name!r}"
        )

    def _params(self, overrides: Optional[dict] = None) -> BnbParams:
        if not overrides:
            return self.params
        bad = set(overrides) - set(_PARAM_KEYS)
        if bad:
            raise ValueError(f"unknown/forbidden param override(s): {sorted(bad)}")
        # fail fast on client-supplied enum values: a bad string would
        # otherwise leave a dead entry in the closure cache
        if overrides.get("icp_metric", "point") not in ("point", "plane"):
            raise ValueError(
                f"icp_metric must be 'point' or 'plane', "
                f"got {overrides['icp_metric']!r}"
            )
        esc = overrides.get("escalate_mse")
        if esc is not None and not float(esc) > 0.0:
            raise ValueError(
                f"escalate_mse must be a positive mse threshold, got {esc!r}"
            )
        return dataclasses.replace(self.params, **overrides)

    @staticmethod
    def _bucket(n: int) -> int:
        """Shape bucket: the next size in {128, 192, 256, 384, 512, …}
        (powers of two interleaved with 1.5×) ≥ n; the padded rows carry
        weight 0, and the 1.5× steps cap the padding at a third."""
        b = 128
        while True:
            if n <= b:
                return b
            if n <= b + b // 2:
                return b + b // 2
            b *= 2

    def _check_points(self, sources: Sequence[np.ndarray]):
        for s in sources:
            if s.shape[0] > self.max_points:
                raise ValueError(
                    f"query has {s.shape[0]} points; this server caps "
                    f"queries at {self.max_points} (operator: --max-points)"
                )

    def register(
        self,
        src: np.ndarray,
        init: Optional[RigidTransform] = None,
        **overrides,
    ) -> GoIcpResult:
        """One globally-optimal solve against the resident target; ``init``
        (a re-localization prior) is pinned as a multistart seed."""
        return self.register_batch(
            [np.asarray(src, np.float32)], inits=[init], **overrides
        )[0]

    def register_batch(
        self,
        sources: Sequence[np.ndarray],
        inits: Optional[Sequence[Optional[RigidTransform]]] = None,
        **overrides,
    ) -> List[GoIcpResult]:
        """Micro-batched solve (``service.py:177-234``): all queries advance
        in lockstep against the shared target, ``icp_metric="plane"`` on the
        resident normals, ``inits`` pinned per query.  With
        ``bucket_shapes`` a single query also takes the lockstep, padded to
        its bucket.  Configurations outside the lockstep fall back to the
        single-pair solver (one query) or ``register_pairs``' pair-by-pair
        loop."""
        if not sources:
            return []
        p = self._params(overrides)
        sources = [np.asarray(s, np.float32) for s in sources]
        self._check_points(sources)
        n_max = max(s.shape[0] for s in sources)
        use_lockstep = (
            (len(sources) >= 2 or self.bucket_shapes)
            and lockstep_compatible(p, n_max, self.tgt.shape[0])
        )
        with self._lock:
            self.queries += len(sources)
            if use_lockstep:
                return multipair_lockstep._register_pairs_lockstep(
                    [(s, self.tgt) for s in sources], p,
                    tgt_normals=self._normals(p), inits=inits,
                    pad_src_to=self._bucket(n_max) if self.bucket_shapes else None,
                    device=self.device,
                )
            if len(sources) == 1:
                return [
                    make_solver(
                        sources[0], self.tgt, p, grid=self.grid,
                        normals=self._normals(p), device=self.device,
                    ).run(None if inits is None else inits[0])
                ]
            return register_pairs(
                [(s, self.tgt) for s in sources], p, solver_grid=self.grid,
                tgt_normals=self._normals(p), inits=inits, device=self.device,
            )

    def _normals(self, p: BnbParams):
        """Resident target normals for the plane metric, computed once per
        ``normals_k`` on the device and shared by every query."""
        if p.icp_metric != "plane":
            return None
        with self._cache_lock:
            normals = self._nrm_dev.get(p.normals_k)
            if normals is None:
                normals = estimate_normals(self._tgt_dev, k=p.normals_k)
                self._nrm_dev[p.normals_k] = normals
            return normals

    def _icp_setup(self, p: BnbParams):
        """(IcpParams, correspondence closure, refine function) of the
        tracking path, cached per parameter key (LRU, ``icp_cache_size``):
        K1 against the resident target up to ``icp_exact_max`` targets, the
        resident grid's index field above."""
        key = (
            p.icp_max_iter, p.icp_rel_tol, p.mse_threshold,
            p.trim_fraction, p.icp_exact_max, p.icp_metric, p.normals_k,
        )
        with self._cache_lock:
            hit = self._icp_cache.get(key)
            if hit is not None:
                self._icp_cache.move_to_end(key)
                return hit
            normals = self._normals(p)
            ip = IcpParams(
                max_iter=p.icp_max_iter,
                rel_tol=min(p.icp_rel_tol, p.mse_threshold),
                trim_fraction=p.trim_fraction,
                metric=p.icp_metric,
            )
            corr = (
                exact_correspondence(self._tgt_dev, normals=normals)
                if self.tgt.shape[0] <= p.icp_exact_max
                else grid_correspondence(self.grid, self._tgt_dev, normals=normals)
            )

            def refine_fn(srcs, T0, w):
                res = run_icp(srcs, corr, T0, ip, point_weights=w)
                return res.transform.R, res.transform.t, res.sse, res.iters

            self._icp_cache[key] = (ip, corr, refine_fn)
            while len(self._icp_cache) > self.icp_cache_size:
                old_key, _ = self._icp_cache.popitem(last=False)
                self.log.info("icp cache evicted %s (cap %d)", old_key, self.icp_cache_size)
            return self._icp_cache[key]

    def _escalate(
        self,
        results: List[GoIcpResult],
        sources: Sequence[np.ndarray],
        p: BnbParams,
        overrides: dict,
    ) -> List[GoIcpResult]:
        """Tracking-loss escalation (``service.py:331``): every refine whose
        mse exceeds ``escalate_mse`` is solved again in the prior-seeded
        goicp lane — one lockstep batch for all of them — and answered with
        the certified pose and ``escalated=True``; the refined pose rides
        as its prior."""
        if p.escalate_mse is None:
            return results
        idxs = [i for i, r in enumerate(results) if r.mse > p.escalate_mse]
        if not idxs:
            return results
        ov = {k: v for k, v in overrides.items() if k != "escalate_mse"}
        self.escalations += len(idxs)
        solved = self.register_batch(
            [sources[i] for i in idxs],
            inits=[results[i].transform for i in idxs],
            **ov,
        )
        out = list(results)
        for i, res in zip(idxs, solved):
            out[i] = dataclasses.replace(
                res,
                escalated=True,
                icp_iters=res.icp_iters + results[i].icp_iters,
                wall_s=res.wall_s + results[i].wall_s,
            )
        return out

    def refine(
        self,
        src: np.ndarray,
        init: Optional[RigidTransform] = None,
        **overrides,
    ) -> GoIcpResult:
        """Local ICP refinement from ``init`` (the tracking path); with
        ``escalate_mse`` set, a refine above that mse escalates to a
        prior-seeded certified solve (:meth:`_escalate`)."""
        return self.refine_batch([src], inits=[init], **overrides)[0]

    def refine_batch(
        self,
        sources: Sequence[np.ndarray],
        inits: Optional[Sequence[Optional[RigidTransform]]] = None,
        **overrides,
    ) -> List[GoIcpResult]:
        """Batched tracking: every query refines in one batched ICP against
        the shared resident correspondence (one K1 launch an iteration, or
        grid lookups), its outputs fetched in one copy; diverged refines
        (above ``escalate_mse``) share one lockstep goicp batch."""
        if not sources:
            return []
        p = self._params(overrides)
        _, _, refine_fn = self._icp_setup(p)
        sources = [np.asarray(s, np.float32) for s in sources]
        self._check_points(sources)
        B = len(sources)
        N = max(s.shape[0] for s in sources)
        if self.bucket_shapes:
            N = self._bucket(N)
        srcs = np.zeros((B, N, 3), np.float32)
        w = np.zeros((B, N), np.float32)
        for b, s in enumerate(sources):
            srcs[b, : s.shape[0]] = s
            w[b, : s.shape[0]] = 1.0
        R0 = np.tile(np.eye(3, dtype=np.float32), (B, 1, 1))
        t0v = np.zeros((B, 3), np.float32)
        for b, T in enumerate(inits or []):
            if T is not None:
                R0[b] = np.asarray(T.R, np.float32)
                t0v[b] = np.asarray(T.t, np.float32)
        dev = self.device
        t_start = time.perf_counter()
        with self._lock:
            self.queries += B
            Rn, tn, sse, iters = refine_fn(
                to_device(srcs, dev),
                RigidTransform(to_device(R0, dev), to_device(t0v, dev)),
                to_device(w, dev),
            )
            Rn, tn, sse, iters = multipair_lockstep._fetch(Rn, tn, sse, iters)  # one copy
        wall = time.perf_counter() - t_start
        out = []
        for b, s in enumerate(sources):
            n_eff = max(1, int(round(s.shape[0] * (1.0 - p.trim_fraction))))
            mse = float(sse[b]) / n_eff
            out.append(GoIcpResult(
                transform=RigidTransform(Rn[b], tn[b]),
                sse=float(sse[b]),
                mse=mse,
                converged=mse <= p.mse_threshold,
                gap=0.0,
                rot_nodes=0,
                trans_nodes=0,
                icp_iters=int(iters[b]),
                rounds=0,
                wall_s=wall,
                metrics=Metrics(),
            ))
        return self._escalate(out, sources, p, overrides)

    def warmup(self, n_src: int, seed: int = 0) -> GoIcpResult:
        """One solve of an ``n_src``-point query (a rigidly moved target
        sample) before serving: the kernels build, and the allocator and
        the frontier runtime warm up."""
        rng = np.random.default_rng(seed)
        idx = rng.choice(self.tgt.shape[0], n_src, replace=n_src > self.tgt.shape[0])
        Q = random_rotations(1, rng)[0]
        src = (self.tgt[idx] @ Q.T).astype(np.float32)
        t0 = time.perf_counter()
        res = self.register(src)
        self.log.info("warmup n=%d: %.2fs (converged=%s)", n_src,
                      time.perf_counter() - t0, res.converged)
        return res

    def info(self) -> dict:
        if self.device.type == "cuda":
            devices = [torch.cuda.get_device_name(i) for i in range(torch.cuda.device_count())]
        else:
            devices = [str(self.device)]
        return {
            "ok": True,
            "service": self.name,
            "target_points": int(self.tgt.shape[0]),
            "grid_resolution": int(self.grid.n),
            "queries_served": self.queries,
            "escalations_served": self.escalations,
            "max_points": self.max_points,
            "bucket_shapes": self.bucket_shapes,
            "devices": devices,
            "defaults": {k: getattr(self.params, k) for k in _PARAM_KEYS},
        }


class MultiTargetService:
    """Several resident targets behind one endpoint (``service.py:534``):
    queries pick one with ``"target": "<name>"`` (default: the first).
    Every target's service shares one device lock."""

    def __init__(self, services: dict, default: Optional[str] = None):
        if not services:
            raise ValueError("need at least one target service")
        self.services = dict(services)
        self.default = default or next(iter(self.services))
        if self.default not in self.services:
            raise ValueError(f"default target {self.default!r} not served")
        self.name = f"zoo({', '.join(sorted(self.services))})"
        shared = threading.Lock()
        for svc in self.services.values():
            svc._lock = shared

    @property
    def source_root(self):
        return self.services[self.default].source_root

    def resolve(self, name: Optional[str] = None) -> RegistrationService:
        key = name if name is not None else self.default
        svc = self.services.get(key)
        if svc is None:
            raise ValueError(
                f"unknown target {key!r}; serving {sorted(self.services)}"
            )
        return svc

    def info(self) -> dict:
        # a superset of the single-target response
        base = self.services[self.default].info()
        base.update(
            service=self.name,
            default=self.default,
            targets={
                k: {
                    "target_points": int(v.tgt.shape[0]),
                    "grid_resolution": int(v.grid.n),
                    "queries_served": v.queries,
                }
                for k, v in self.services.items()
            },
        )
        return base
