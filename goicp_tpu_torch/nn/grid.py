"""Dense distance field over the target cloud — port of the JAX package's
``nn/grid.py`` in plain PyTorch (the JAX package builds and reads it in
XLA, outside any Pallas kernel).

The grid carries an explicit ``origin``/``cell`` and two build paths:

- ``method="brute"``: exact min squared distance from every cell center to
  the target points, by x-slabs whose distances use the
  ``|q|² − 2q·t + |t|²`` expansion (a matmul);
- ``method="edt"``: rasterize the targets to the grid, then the exact
  squared EDT to the occupied cell centers by three separable min-plus
  passes (the Felzenszwalb/Huttenlocher decomposition), with the nearest
  target's index carried as the argmin's payload.  When several targets
  fall into one cell, the cell keeps the largest index, which is what the
  JAX package's in-order scatter keeps on the CPU; here a ``scatter_reduce``
  "amax" makes that deterministic on the card too.

Queries outside the domain get an *escape distance* by the triangle
inequality: with ``c`` the clamped query,
``d(q,T) in [max(d(c)-|q-c|, 0), d(c)+|q-c|]``.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Optional, Tuple

import numpy as np
import torch

from goicp_tpu_torch.core.device import resolve_device
from goicp_tpu_torch.nn.fused import _sq3, fma, sqrt_rn

# elements of one min-plus candidate block: 512 MB in f64 (and 256 MB once
# rounded), so a 256³ build stays beside the solve's buffers
_MINPLUS_ELEMS = 1 << 26
# elements of one brute-build distance block
_BRUTE_ELEMS = 1 << 24


@dataclasses.dataclass(frozen=True)
class DistanceGrid:
    """Squared-distance field ``values[ix, iy, iz]`` sampled at cell centers
    ``origin + (idx + 0.5) * cell``; optionally ``indices``, the nearest
    target-point index per cell (grid-correspondence ICP).  ``cell`` is a
    Python float holding an f32 value.  ``raster_err``: worst-case distance
    between the field's effective target set and the true targets (0 for
    the brute build; half the cell diagonal for the rasterized EDT)."""

    values: Any      # [n, n, n] f32 squared distances
    origin: Any      # [3] f32
    cell: float
    indices: Any = None  # [n, n, n] int64 or None
    raster_err: float = 0.0

    @property
    def n(self) -> int:
        return self.values.shape[0]


def grid_domain(
    targets: np.ndarray, expand: float = 2.0, cover: Optional[np.ndarray] = None
) -> Tuple[np.ndarray, float]:
    """Cubic domain: target bbox, cube-ified, expanded by ``expand`` about its
    center (``grid.py:71``).  ``cover`` optionally adds points the domain
    must also contain.  Returns ``(origin [3], side)``."""
    t = np.asarray(targets)
    lo, hi = t.min(0), t.max(0)
    center = (lo + hi) / 2
    side = float((hi - lo).max()) * expand
    if side <= 0.0:
        # degenerate cloud (single point / coincident points): a zero-sized
        # domain would give cell=0 and NaN lookups everywhere
        side = max(1e-3, 2e-3 * float(np.abs(center).max()), 1.0e-3)
    if cover is not None:
        c = np.asarray(cover).reshape(-1, 3)
        side = max(side, float(2.0 * np.abs(c - center).max()) * 1.001)
    origin = center - side / 2
    return origin.astype(np.float32), side


def _build_brute(targets, origin, cell: float, n: int, with_index: bool):
    """Exact build over blocks of x-slabs (``grid.py:95``): distances by
    ``|q|² − 2q·t + |t|²`` through a matmul, min (and argmin) over targets."""
    dev = targets.device
    tn = _sq3(targets)                                          # [Nt]
    ar = torch.arange(n, device=dev, dtype=torch.float32)
    yz = torch.stack(torch.meshgrid(ar, ar, indexing="ij"), -1).reshape(-1, 2)  # [n², 2]
    values = torch.empty((n, n * n), dtype=torch.float32, device=dev)
    indices = torch.empty((n, n * n), dtype=torch.int64, device=dev) if with_index else None
    step = max(1, _BRUTE_ELEMS // max(1, n * n * targets.shape[0]))
    for x0 in range(0, n, step):
        xs = ar[x0:x0 + step]
        ijk = torch.cat([xs.repeat_interleave(n * n)[:, None], yz.repeat(xs.shape[0], 1)], 1)
        cells = origin[None, :] + (ijk + 0.5) * cell                # [k·n², 3]
        qn = _sq3(cells)
        dots = cells @ targets.T                                    # [k·n², Nt]
        d2 = (qn[:, None] - 2.0 * dots) + tn[None, :]
        val, arg = torch.min(d2, dim=1)
        values[x0:x0 + step] = torch.clamp(val, min=0.0).reshape(-1, n * n)
        if with_index:
            indices[x0:x0 + step] = arg.reshape(-1, n * n)
    return values.reshape(n, n, n), (indices.reshape(n, n, n) if with_index else None)


def _minplus_axis(D, I, c2: float, axis: int):
    """Tropical (min-plus) transform along ``axis``:
    ``D'[i] = min_j D[j] + c2·(i−j)²``, carrying the argmin's payload ``I``
    (or None) — ``grid.py:135``.  Each candidate is rounded to f32 once
    from its f64 value, as the fused multiply-add that XLA's CPU build emits
    for ``D + c2·k²`` rounds it, so values and argmins equal the JAX
    package's.  Ties keep the first ``j`` (``torch.min`` over a dimension
    returns the first minimal index).  Candidates ``[rows, n, chunk]`` are
    built in blocks of at most ``_MINPLUS_ELEMS`` elements."""
    n = D.shape[axis]
    Dm = D.movedim(axis, -1)
    shape = Dm.shape
    D2 = Dm.reshape(-1, n).to(torch.float64)
    I2 = None if I is None else I.movedim(axis, -1).reshape(-1, n)
    R = D2.shape[0]
    chunk = min(n, 16)
    rows = max(1, _MINPLUS_ELEMS // (n * chunk))
    j = torch.arange(n, device=D.device, dtype=torch.float64)
    out_v = torch.empty(D2.shape, dtype=torch.float32, device=D.device)
    out_i = None if I2 is None else torch.empty_like(I2)
    for i0 in range(0, n, chunk):
        i = j[i0:i0 + chunk]
        C = c2 * (j[:, None] - i[None, :]) ** 2                    # [n, c], exact
        for r0 in range(0, R, rows):
            cand = (D2[r0:r0 + rows, :, None] + C).to(torch.float32)
            best, amin = torch.min(cand, dim=1)
            out_v[r0:r0 + rows, i0:i0 + chunk] = best
            if out_i is not None:
                out_i[r0:r0 + rows, i0:i0 + chunk] = torch.gather(I2[r0:r0 + rows], 1, amin)
    out_v = out_v.reshape(shape).movedim(-1, axis)
    out_i = None if out_i is None else out_i.reshape(shape).movedim(-1, axis)
    return out_v, out_i


def _build_edt(targets, origin, cell: float, n: int, with_index: bool = True):
    """Separable EDT of the rasterized target cloud (``grid.py:168``):
    occupied cells at 0, three min-plus passes, exact to the occupied cell
    centers.  Per-cell nearest-target indices ride along as the payload;
    a cell hit by several targets holds the largest of their indices."""
    dev = targets.device
    idx = torch.clamp(torch.floor((targets - origin[None, :]) / cell).to(torch.int32), 0, n - 1)
    idx = idx.to(torch.int64)
    flat = (idx[:, 0] * n + idx[:, 1]) * n + idx[:, 2]
    occ = torch.full((n * n * n,), float("inf"), dtype=torch.float32, device=dev)
    occ[flat] = 0.0
    D = occ.reshape(n, n, n)
    c2 = float(np.float32(cell) * np.float32(cell))
    I = None
    if with_index:
        pid = torch.zeros((n * n * n,), dtype=torch.int64, device=dev)
        pid.scatter_reduce_(0, flat, torch.arange(targets.shape[0], device=dev), "amax")
        I = pid.reshape(n, n, n)
    for ax in range(3):
        D, I = _minplus_axis(D, I, c2, ax)
    return D.contiguous(), (None if I is None else I.contiguous())


def build_distance_grid(
    targets,
    n: int = 256,
    expand: float = 2.0,
    cover=None,
    method: str = "brute",
    with_index: bool = False,
    domain: Optional[Tuple[np.ndarray, float]] = None,
    device=None,
) -> DistanceGrid:
    """Build the distance field over ``targets [Nt,3]`` (``grid.py:203``).
    A tensor is used on its own device; a numpy array goes to ``device``
    (None means CUDA)."""
    if isinstance(targets, torch.Tensor):
        t = targets.to(torch.float32)
    else:
        t = torch.as_tensor(np.asarray(targets, np.float32), device=resolve_device(device))
    if domain is None:
        domain = grid_domain(t.cpu().numpy(), expand, cover)
    origin_np, side = domain
    cell = float(np.float32(side / n))
    origin = torch.as_tensor(np.asarray(origin_np, np.float32), device=t.device)
    raster_err = 0.0
    if method == "brute":
        values, indices = _build_brute(t, origin, cell, n, with_index)
    elif method == "edt":
        values, indices = _build_edt(t, origin, cell, n, with_index)
        raster_err = cell * math.sqrt(3.0) / 2.0
    else:
        raise ValueError(f"unknown grid build method {method!r}")
    return DistanceGrid(values=values, origin=origin, cell=cell, indices=indices,
                        raster_err=raster_err)


def _clamped_cell_coords(grid: DistanceGrid, queries):
    """Continuous cell coordinates (centered convention) + escape distance."""
    n = grid.n
    x = (queries - grid.origin) / grid.cell - 0.5
    xc = torch.clamp(x, 0.0, n - 1.0)
    esc = sqrt_rn(_sq3((x - xc) * grid.cell))
    return xc, esc


def _nearest_flat(grid: DistanceGrid, xc):
    """Flat index of the nearest cell; ``torch.round`` rounds half to even,
    as ``jnp.round`` does."""
    n = grid.n
    idx = torch.clamp(torch.round(xc).to(torch.int64), 0, n - 1)
    return (idx[..., 0] * n + idx[..., 1]) * n + idx[..., 2]


def lookup_sq_nearest(grid: DistanceGrid, queries):
    """Nearest-cell squared distance + escape (``grid.py:249``)."""
    xc, esc = _clamped_cell_coords(grid, queries)
    return torch.take(grid.values, _nearest_flat(grid, xc)), esc


def lookup_sq_trilinear(grid: DistanceGrid, queries):
    """Trilinearly interpolated squared distance + escape (``grid.py:259``)."""
    n = grid.n
    xc, esc = _clamped_cell_coords(grid, queries)
    x0 = torch.floor(xc)
    f = xc - x0
    i0 = torch.clamp(x0.to(torch.int64), 0, n - 1)
    i1 = torch.clamp(i0 + 1, 0, n - 1)

    def at(ix, iy, iz):
        return torch.take(grid.values, (ix * n + iy) * n + iz)

    fx, fy, fz = f[..., 0], f[..., 1], f[..., 2]
    c000 = at(i0[..., 0], i0[..., 1], i0[..., 2])
    c100 = at(i1[..., 0], i0[..., 1], i0[..., 2])
    c010 = at(i0[..., 0], i1[..., 1], i0[..., 2])
    c110 = at(i1[..., 0], i1[..., 1], i0[..., 2])
    c001 = at(i0[..., 0], i0[..., 1], i1[..., 2])
    c101 = at(i1[..., 0], i0[..., 1], i1[..., 2])
    c011 = at(i0[..., 0], i1[..., 1], i1[..., 2])
    c111 = at(i1[..., 0], i1[..., 1], i1[..., 2])
    # XLA's CPU build contracts each blend a·(1−f) + b·f into one fused
    # multiply-add: along x it keeps a·(1−f) rounded and fuses b·f, along y
    # and z the reverse; the same single roundings keep the lookup equal
    # to the jitted JAX function's bit for bit
    gx, gy, gz = 1 - fx, 1 - fy, 1 - fz
    c00 = fma(c100, fx, c000 * gx)
    c10 = fma(c110, fx, c010 * gx)
    c01 = fma(c101, fx, c001 * gx)
    c11 = fma(c111, fx, c011 * gx)
    c0 = fma(c00, gy, c10 * fy)
    c1 = fma(c01, gy, c11 * fy)
    return fma(c0, gz, c1 * fz), esc


def lookup_index(grid: DistanceGrid, queries):
    """Nearest target-point index via the index grid (grid-ICP path)."""
    if grid.indices is None:
        raise ValueError("grid built without with_index=True")
    xc, _ = _clamped_cell_coords(grid, queries)
    return torch.take(grid.indices, _nearest_flat(grid, xc))


def distance_bounds(grid: DistanceGrid, queries, lookup: str = "trilinear"):
    """Per-query conservative distance interval ``(d_lo, d_hi)``
    (``grid.py:301``): lattice discretization (d is 1-Lipschitz), the
    build's rasterization error and the escape term."""
    if lookup == "trilinear":
        val, esc = lookup_sq_trilinear(grid, queries)
        lat = grid.cell * np.sqrt(3.0)
    elif lookup == "nearest":
        val, esc = lookup_sq_nearest(grid, queries)
        lat = grid.cell * (np.sqrt(3.0) / 2.0)
    else:
        raise ValueError(f"unknown lookup {lookup!r}")
    slack = float(lat + grid.raster_err)
    d = sqrt_rn(torch.clamp(val, min=0.0))
    return torch.clamp(d - esc - slack, min=0.0), d + esc + slack
