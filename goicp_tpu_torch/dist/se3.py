"""SE(3) BnB rounds over a ``("cubes", "points")`` device mesh (port of the
JAX package's ``dist/se3.py``).

A round's flat job batch is cut over the cube rows and the (padded) source
cloud over the point columns; every per-node bound sum, plain or trimmed,
is reduced over the row (:mod:`goicp_tpu_torch.dist.sharding` says how one
process runs the collectives).  The round returns the global ``[M]``
bounds on the mesh's first device, then the refine tail takes the global
top-k over all shards' ub and runs the batched ICP there.

Backends, as in the JAX package:

- "mxu": K4 per shard on its ``[M/c nodes] × [N/p points]`` block
  (:func:`~goicp_tpu_torch.nn.fused.min_d2_nodes`), then the deflation
  epilogue, which masks padded points by the shard's global start;
- "screen" on a cube-only mesh: the screened evaluator per cube shard (K2
  untrimmed, K5 trimmed); on a point-sharded mesh it falls back to "mxu",
  since a shard's partial sum cannot be held against the global threshold;
- "exact"/"grid": the tile scan of :func:`~goicp_tpu_torch.bnb.se3_eval.evaluate_se3_nodes`
  per shard, with its sums in the same order.

On a cube-only mesh every shard computes what the single-device round
computes for its nodes, in the same order, so the bounds are the same bits.
"""

from __future__ import annotations

import numpy as np
import torch

from goicp_tpu_torch.bnb.se3_eval import (
    _drop,
    _masked,
    _refine_tail,
    deflate_terms,
    evaluate_se3_nodes_screened,
    node_tile_terms,
    tile_sums,
)
from goicp_tpu_torch.core.device import local_devices
from goicp_tpu_torch.dist.sharding import Mesh, _Placed, grid_to, make_mesh, on_device, pmax, psum, split
from goicp_tpu_torch.nn import fused


def pad_points(src: np.ndarray, norms: np.ndarray, n_points: int, quantum: int):
    """The solve cloud zero-padded so that the point axis splits into
    ``n_points`` shards of a multiple of ``quantum`` points
    (``dist/se3.py:48``); the padded rows' terms are masked by the count of
    real points."""
    n = src.shape[0]
    step = n_points * quantum
    n_pad = ((n + step - 1) // step) * step
    if n_pad == n:
        return np.asarray(src, np.float32), np.asarray(norms, np.float32)
    src_p = np.zeros((n_pad, 3), np.float32)
    src_p[:n] = src
    norms_p = np.zeros((n_pad,), np.float32)
    norms_p[:n] = norms
    return src_p, norms_p


def _trimmed_sum_bisect_psum(xs, h: int, upper: bool, dev: torch.device, iters: int = 24,
                             ordered: bool = False):
    """:func:`~goicp_tpu_torch.nn.fused.trimmed_sum_bisect` over the point
    shards ``xs`` (``[M, Nl]`` each, one cube row): the same 24 halvings,
    every row reduction summed over the shards (``dist/se3.py:64``), so one
    shard gives that function's result.  ``ordered``: each shard's sum in
    XLA's order and ``S + rem·τ`` rounded once, as ``ordered=True`` there."""
    rowmax = pmax([torch.where(x < 1e29, x, torch.zeros_like(x)).amax(-1) for x in xs], dev)
    lo = torch.zeros_like(rowmax)
    hi = rowmax + 1e-12
    for _ in range(iters):
        mid = 0.5 * (lo + hi)
        cnt = psum([(x <= mid.to(x.device)[:, None]).sum(-1).to(torch.float32) for x in xs], dev)
        take = cnt >= h
        lo, hi = torch.where(take, lo, mid), torch.where(take, mid, hi)
    sels = [x <= lo.to(x.device)[:, None] for x in xs]
    kept = [torch.where(sel, x, torch.zeros_like(x)) for sel, x in zip(sels, xs)]
    S = psum([fused.ordered_row_sum(k) if ordered else k.sum(-1) for k in kept], dev)
    C = psum([sel.sum(-1).to(torch.float32) for sel in sels], dev)
    rem = torch.clamp(h - C, min=0.0)
    tau = hi if upper else lo
    if ordered:
        return (S.double() + rem.double() * tau.double()).float()
    return S + rem * tau


class ShardedRound:
    """The mesh round (``dist/se3.py:96``).  :meth:`bounds` gives ``(ub, lb)
    [M]``; calling the round also runs the refine tail and returns ``(ub,
    lb, R_ref, t_ref, sse_ref, iters)``, as the JAX package's jitted round
    does.  The SE(3) round driver calls :meth:`bounds` when it dispatches
    and the refine tail when it absorbs the round."""

    def __init__(self, mesh: Mesh, *, h: int, n_valid: int, lookup: str, backend: str,
                 tile: int, refine_k: int, icp_params, icp_backend: str, out_device=None):
        if backend == "screen" and mesh.shape["points"] != 1:
            # a point shard's partial sum bounds only its slice: it cannot
            # be screened against the global threshold
            backend = "mxu"
        self.mesh, self.h, self.n_valid = mesh, h, n_valid
        self.lookup, self.backend, self.tile = lookup, backend, tile
        self.refine_k, self.icp_params, self.icp_backend = refine_k, icp_params, icp_backend
        self.drop = _drop(h, n_valid)
        self.out_device = torch.device(out_device) if out_device is not None else mesh.first
        self._grids = _Placed()

    def _grid_on(self, grid, dev):
        if grid is None or grid.values.device == dev:
            return grid
        return self._grids.get(id(grid), dev, lambda d: grid_to(grid, d))

    def bounds(self, src_pad, norms_pad, grid, tgt, slack, thresh, R, max_angle, t_c,
               t_span, mask):
        """``(ub, lb) [M]`` on the output device; job arrays ``[M]`` with M
        a multiple of the cube extent, ``src_pad``/``norms_pad`` from
        :func:`pad_points`."""
        n_c, n_p = self.mesh.devices.shape
        jobs = [split(x, n_c) for x in (R, max_angle, t_c, t_span, mask)]
        src_s, norms_s = split(src_pad, n_p), split(norms_pad, n_p)
        nl = src_s[0].shape[0]
        rows = []
        for c in range(n_c):
            row_dev = self.mesh.devices[c, 0]
            R_c, ang_c, tc_c, ts_c, m_c = (j[c] for j in jobs)
            if self.backend == "screen":
                with on_device(row_dev):
                    rows.append(evaluate_se3_nodes_screened(
                        src_s[0][:self.n_valid].to(row_dev),
                        norms_s[0][:self.n_valid].to(row_dev), tgt.to(row_dev), slack, thresh,
                        R_c.to(row_dev), ang_c.to(row_dev), tc_c.to(row_dev),
                        ts_c.to(row_dev), m_c.to(row_dev), h=self.h))
                continue
            us, ls = [], []
            for p in range(n_p):
                dev = self.mesh.devices[c, p]
                start = p * nl
                with on_device(dev):
                    args = [x.to(dev) for x in (R_c, ang_c, tc_c, ts_c)]
                    if self.backend == "mxu":
                        u, l = self._mxu_terms(src_s[p].to(dev), norms_s[p].to(dev),
                                               tgt.to(dev), slack, start, *args)
                    else:
                        n_real = int(min(max(self.n_valid - start, 0), nl))
                        if n_real == 0:
                            continue          # all padding: no terms to add
                        u, l = self._tile_terms(src_s[p][:n_real].to(dev),
                                                norms_s[p][:n_real].to(dev),
                                                self._grid_on(grid, dev), tgt.to(dev), slack,
                                                *args)
                    us.append(u)
                    ls.append(l)
            rows.append(_masked(m_c.to(row_dev), self._reduce(us, True, row_dev),
                                self._reduce(ls, False, row_dev)))
        dev = self.out_device
        return (torch.cat([r[0].to(dev) for r in rows]),
                torch.cat([r[1].to(dev) for r in rows]))

    def _mxu_terms(self, src_p, norms_p, tgt, slack, start, R, ang, t_c, t_span):
        """K4 on the shard's block, then the epilogue's per-point terms."""
        d2 = fused.min_d2_nodes(fused.pack_sources(src_p), fused.pack_targets(tgt),
                                fused.pack_params(R, t_c))                  # [Ml, Nl]
        nl = src_p.shape[0]
        pmask = ((start + torch.arange(nl, device=src_p.device)) < self.n_valid
                 ).to(torch.float32)[None, :]
        return deflate_terms(d2, norms_p, slack, ang, t_span, pmask, self.drop)

    def _tile_terms(self, src_p, norms_p, grid, tgt, slack, R, ang, t_c, t_span):
        """The "exact"/"grid" tile scan over the shard's real points, each
        tile's terms concatenated (trimmed) or summed in the single-device
        round's order (untrimmed)."""
        u, l = node_tile_terms(src_p, norms_p, grid, tgt, slack, R, ang, t_c, t_span,
                               drop=self.drop, lookup=self.lookup, backend=self.backend,
                               tile=self.tile, tgt_tile=256)
        if self.drop:
            return torch.cat(u, dim=1), torch.cat(l, dim=1)
        return tile_sums(torch.stack(u, dim=1)), tile_sums(torch.stack(l, dim=1))

    def _reduce(self, xs, upper: bool, dev):
        """A cube row's (trimmed) sums over its point shards."""
        tiled = self.backend in ("exact", "grid")
        if self.drop:
            return _trimmed_sum_bisect_psum(xs, self.h, upper, dev, ordered=tiled)
        return psum(xs if tiled else [x.sum(-1) for x in xs], dev)

    def refine(self, ub, lb, R, t_c, src, tgt, grid=None, refine_gate=None):
        """The global top-k refine on the output device (``dist/se3.py:255``)."""
        return _refine_tail(ub, lb, R, t_c, src, tgt, self.refine_k, self.icp_params,
                            refine_gate, grid=grid, icp_backend=self.icp_backend)

    def __call__(self, src_pad, norms_pad, grid, tgt, slack, thresh, R, max_angle, t_c,
                 t_span, mask, src, refine_gate=None):
        ub, lb = self.bounds(src_pad, norms_pad, grid, tgt, slack, thresh, R, max_angle, t_c,
                             t_span, mask)
        dev = self.out_device
        return self.refine(ub, lb, R.to(dev), t_c.to(dev), src.to(dev), tgt.to(dev),
                           self._grid_on(grid, dev), refine_gate)


def make_sharded_se3_round(mesh: Mesh, *, h: int, n_valid: int, lookup: str, backend: str,
                           tile: int, refine_k: int, icp_params, icp_backend: str,
                           out_device=None) -> ShardedRound:
    """The mesh round of ``backend`` (``dist/se3.py:96``): see
    :class:`ShardedRound`.  ``h``: the trimmed keep-count (0 untrimmed);
    ``n_valid``: the real source points inside the padded cloud;
    ``out_device``: where the bounds and the refine land (default the
    mesh's first device)."""
    return ShardedRound(mesh, h=h, n_valid=n_valid, lookup=lookup, backend=backend,
                        tile=tile, refine_k=refine_k, icp_params=icp_params,
                        icp_backend=icp_backend, out_device=out_device)


def make_engine_mesh(p, backend: str, src, norms, *, h: int, icp_params, icp_backend: str,
                     device, log=None, tag: str = ""):
    """The engines' mesh set-up (``dist/se3.py:301``): the (cubes × points)
    extents from ``mesh_cubes``/``mesh_points`` (``mesh_cubes = 0``: every
    local device over the cubes), the padded cloud and the mesh round, on
    :func:`~goicp_tpu_torch.core.device.local_devices` of ``device``, the
    solver's device, where the round's outputs land.  Returns None for a
    1×1 mesh (the single-device round), else ``(round, src_pad, norms_pad,
    n_c, n_p)`` with the padded cloud on ``device``."""
    n_p = max(1, p.mesh_points)
    n_c = (max(1, len(local_devices(device)) // n_p) if p.mesh_cubes == 0
           else max(1, p.mesh_cubes))
    if n_c * n_p <= 1:
        return None
    mesh = make_mesh(n_c, n_p, device=device)
    quantum = 128 if backend in ("mxu", "screen") else p.point_tile
    src_pad, norms_pad = pad_points(np.asarray(src, np.float32), np.asarray(norms, np.float32),
                                    n_p, quantum)
    rnd = make_sharded_se3_round(
        mesh, h=h, n_valid=src.shape[0], lookup=p.lookup, backend=backend,
        tile=p.point_tile, refine_k=p.refine_top_k, icp_params=icp_params,
        icp_backend=icp_backend, out_device=device,
    )
    if log is not None:
        log.info("%sSE(3) rounds on a %dx%d (cubes x points) local device mesh", tag, n_c, n_p)
    dev = torch.device(device)
    return (rnd, torch.as_tensor(src_pad, device=dev), torch.as_tensor(norms_pad, device=dev),
            n_c, n_p)
