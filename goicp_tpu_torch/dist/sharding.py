"""Sharding over a ``("cubes", "points")`` device mesh (port of the JAX
package's ``dist/sharding.py``).

Two axes of the workload split over devices:

- **cubes**: a batch of bound evaluations (SE(3) nodes, poses) is cut into
  equal contiguous slices, one per cube row of the mesh;
- **points**: the source cloud is cut into equal slices, one per point
  column; every per-node sum over points becomes a reduction over the row.

The JAX package writes these with ``shard_map`` and lets XLA insert the
collectives.  Here one process drives every shard and the collectives are
explicit: ``psum`` adds the shards' partials in shard order on the row's
first device, ``pmax`` takes their max there, and ``all_gather`` followed
by ``top_k`` concatenates in shard order and takes ``topk``.  A mesh may
list one device more than once; its shards then run in turn.  Outputs come
back concatenated over the cube rows on the mesh's first device.

Trimmed sums over the point axis use the two-stage selection of the JAX
package: the global ``k`` largest terms lie in the union of each shard's
``k`` largest, so a shard-local ``topk``, a gather and a global ``topk``
give the exact trimmed sum.
"""

from __future__ import annotations

import contextlib
import dataclasses
import math

import numpy as np
import torch

from goicp_tpu_torch.core.device import local_devices
from goicp_tpu_torch.geo.procrustes import horn_quaternion
from goicp_tpu_torch.geo.rotation import quat_to_matrix, rotation_displacement
from goicp_tpu_torch.nn.fused import sqrt_rn
from goicp_tpu_torch.nn.grid import (
    DistanceGrid,
    lookup_index,
    lookup_sq_nearest,
    lookup_sq_trilinear,
)

_SQRT3 = math.sqrt(3.0)
_INF = float("inf")


@dataclasses.dataclass(frozen=True, eq=False)
class Mesh:
    """Devices ``[n_cubes, n_points]`` (an object array of ``torch.device``)
    with named axes, read as the JAX package's ``jax.sharding.Mesh``:
    ``mesh.shape["points"]``, ``mesh.devices.size``, ``mesh.axis_names``.
    A single named axis (``("pairs",)``) serves the lockstep's pair mesh."""

    devices: np.ndarray
    axis_names: tuple = ("cubes", "points")

    @property
    def shape(self) -> dict:
        return dict(zip(self.axis_names, self.devices.shape))

    @property
    def first(self) -> torch.device:
        return self.devices.flat[0]


def device_array(devices) -> np.ndarray:
    """A 1-D object array of ``torch.device`` from any device list."""
    out = np.empty(len(devices), dtype=object)
    out[:] = [torch.device(d) for d in devices]
    return out


def make_mesh(n_cubes: int = 1, n_points: int = 1, devices=None, device=None) -> Mesh:
    """Mesh with axes ``("cubes", "points")`` (``sharding.py:43``) over
    ``devices`` (default :func:`~goicp_tpu_torch.core.device.local_devices`
    of ``device``: every card, or that many CPU shards).  The list may
    repeat a device.  Fewer devices than ``n_cubes·n_points`` raise."""
    n = n_cubes * n_points
    devs = device_array(local_devices(device, n) if devices is None else list(devices))
    if devs.size < n:
        raise ValueError(f"need {n} devices, have {devs.size}")
    return Mesh(devs[:n].reshape(n_cubes, n_points), ("cubes", "points"))


def on_device(dev: torch.device):
    """The context that makes ``dev`` current, so a kernel launched in it
    runs on that card (a no-op for the CPU)."""
    return torch.cuda.device(dev) if dev.type == "cuda" else contextlib.nullcontext()


def split(x, k: int):
    """``x`` cut along its first axis into ``k`` equal slices."""
    n = x.shape[0]
    if n % k:
        raise ValueError(f"{n} rows do not split over {k} shards")
    m = n // k
    return [x[i * m:(i + 1) * m] for i in range(k)]


def psum(parts, dev: torch.device):
    """Shard partials added in shard order on ``dev``."""
    acc = parts[0].to(dev)
    for q in parts[1:]:
        acc = acc + q.to(dev)
    return acc


def pmax(parts, dev: torch.device):
    """Shard partials' element-wise max on ``dev``."""
    acc = parts[0].to(dev)
    for q in parts[1:]:
        acc = torch.maximum(acc, q.to(dev))
    return acc


def gather_top(parts, k: int, dev: torch.device):
    """``all_gather`` of the shards' rows in shard order, then the ``k``
    largest per row (descending): ``[..., k]`` on ``dev``."""
    return torch.topk(torch.cat([q.to(dev) for q in parts], dim=-1), k, dim=-1).values


def _psum_trimmed(xs, drop: int, dev: torch.device):
    """Trimmed sum over the point shards ``xs`` (``[..., Nl]`` each): the
    global sum less the ``drop`` largest entries (``sharding.py:61``)."""
    total = psum([x.sum(-1) for x in xs], dev)
    if drop <= 0:
        return total
    k = min(drop, xs[0].shape[-1])
    top = gather_top([torch.topk(x, k, dim=-1).values for x in xs], drop, dev)
    return total - top.sum(-1)


class _Placed:
    """Per-device copies of replicated inputs (a grid, a target cloud),
    made once per device."""

    def __init__(self):
        self._cache = {}

    def get(self, key, dev: torch.device, make):
        k = (key, str(dev))
        if k not in self._cache:
            self._cache[k] = make(dev)
        return self._cache[k]


def grid_to(grid: DistanceGrid, dev: torch.device) -> DistanceGrid:
    """``grid`` with its tensors on ``dev``."""
    return dataclasses.replace(
        grid, values=grid.values.to(dev), origin=grid.origin.to(dev),
        indices=None if grid.indices is None else grid.indices.to(dev),
    )


def _local_distance(grid: DistanceGrid, pts, lookup: str):
    if lookup == "trilinear":
        val, esc = lookup_sq_trilinear(grid, pts)
    else:
        val, esc = lookup_sq_nearest(grid, pts)
    return sqrt_rn(torch.clamp(val, min=0.0)), esc


def _points(R, t, src):
    """``R_m·p + t_m`` for every job and point: ``[M, N, 3]``."""
    return src[None] @ R.transpose(-1, -2) + t[:, None, :]


class _ShardedStep:
    """The shared shape of the sharded steps: jobs over cube rows, points
    over point columns, per-shard terms reduced over each row."""

    def __init__(self, mesh: Mesh, grid: DistanceGrid):
        self.mesh = mesh
        self.grid = grid
        self.placed = _Placed()
        self.n_c, self.n_p = mesh.devices.shape

    def grid_on(self, dev):
        return self.placed.get("grid", dev, lambda d: grid_to(self.grid, d))

    def shards(self, src, jobs):
        """``(row_device, [(device, src_p, jobs_c on device) for p])`` per
        cube row ``c``."""
        src_parts = split(src, self.n_p)
        job_parts = [split(j, self.n_c) for j in jobs]
        for c in range(self.n_c):
            row = []
            for p in range(self.n_p):
                dev = self.mesh.devices[c, p]
                row.append((dev, src_parts[p].to(dev),
                            [jp[c].to(dev) for jp in job_parts]))
            yield self.mesh.devices[c, 0], row

    def out(self, rows):
        """Row outputs concatenated on the mesh's first device."""
        dev = self.mesh.first
        return tuple(torch.cat([r[i].to(dev) for r in rows]) for i in range(len(rows[0])))


def sharded_bounds_step(mesh: Mesh, grid: DistanceGrid, *, trim_drop: int = 0,
                        lookup: str = "trilinear", slack: float = 0.0):
    """The sharded bound step (``sharding.py:74``): ``step(src, norms, R,
    max_angle, t_center, t_span, rot_flag, mask) -> (center_val, node_lb)
    [M]``, the center value and lower bound of ``BoundsEvaluator`` with
    ``src [N,3]`` split over points and the jobs ``[M,...]`` over cubes."""
    st = _ShardedStep(mesh, grid)

    def step(src, norms, R, max_angle, t_center, t_span, rot_flag, mask):
        rows = []
        srcn = torch.cat([src, norms[:, None]], dim=1)
        for row_dev, row in st.shards(srcn, (R, max_angle, t_center, t_span, rot_flag, mask)):
            cs, ls = [], []
            for dev, sn, (R_c, ang, tc, ts, flag, _) in row:
                with on_device(dev):
                    d, esc = _local_distance(st.grid_on(dev), _points(R_c, tc, sn[:, :3]), lookup)
                    d_lo = torch.clamp(d - esc - slack, min=0.0)
                    d_hi = d + esc + slack
                    gamma_r = rotation_displacement(ang, sn[:, 3]) * flag[:, None]
                    gamma_t = (_SQRT3 * ts)[:, None]
                    center_d = torch.where(flag[:, None] > 0, d_lo, d_hi)
                    cc = torch.clamp(center_d - gamma_r, min=0.0)
                    lc = torch.clamp(d_lo - gamma_r - gamma_t, min=0.0)
                    cs.append(cc * cc)
                    ls.append(lc * lc)
            mask_c = row[0][2][5].to(row_dev)
            rows.append(_masked(mask_c, _psum_trimmed(cs, trim_drop, row_dev),
                                _psum_trimmed(ls, trim_drop, row_dev)))
        return st.out(rows)

    return step


def _masked(mask, a, b):
    inf = torch.full_like(a, _INF)
    return torch.where(mask, a, inf), torch.where(mask, b, inf)


def sharded_sse(mesh: Mesh, grid: DistanceGrid, *, trim_drop: int = 0,
                lookup: str = "trilinear"):
    """Point-sharded (trimmed) SSE at a batch of poses split over cubes
    (``sharding.py:137``): ``sse(src, norms, R, t) -> [B]``."""
    step = sharded_bounds_step(mesh, grid, trim_drop=trim_drop, lookup=lookup)

    def sse(src, norms, R, t):
        z = torch.zeros((R.shape[0],), dtype=torch.float32, device=R.device)
        cv, _ = step(src, norms, R, z, t, z, z, torch.ones_like(z, dtype=torch.bool))
        return cv

    return sse


def sharded_evaluate_se3(mesh: Mesh, grid: DistanceGrid, *, trim_drop: int = 0,
                         lookup: str = "nearest", slack: float = 0.0):
    """Sharded SE(3) node bounds on the distance grid (``sharding.py:150``):
    ``step(src, norms, R, max_angle, t_c, t_span, mask) -> (ub, lb) [M]``."""
    st = _ShardedStep(mesh, grid)

    def step(src, norms, R, max_angle, t_c, t_span, mask):
        rows = []
        srcn = torch.cat([src, norms[:, None]], dim=1)
        for row_dev, row in st.shards(srcn, (R, max_angle, t_c, t_span, mask)):
            us, ls = [], []
            for dev, sn, (R_c, ang, tc, ts, _) in row:
                with on_device(dev):
                    d, esc = _local_distance(st.grid_on(dev), _points(R_c, tc, sn[:, :3]), lookup)
                    d_lo = torch.clamp(d - esc - slack, min=0.0)
                    d_hi = d + esc + slack
                    gamma_r = rotation_displacement(ang, sn[:, 3])
                    lc = torch.clamp(d_lo - gamma_r - (_SQRT3 * ts)[:, None], min=0.0)
                    us.append(d_hi * d_hi)
                    ls.append(lc * lc)
            mask_c = row[0][2][4].to(row_dev)
            rows.append(_masked(mask_c, _psum_trimmed(us, trim_drop, row_dev),
                                _psum_trimmed(ls, trim_drop, row_dev)))
        return st.out(rows)

    return step


def sharded_icp_step(mesh: Mesh, grid: DistanceGrid, targets, *, trim_drop: int = 0):
    """One sharded ICP iteration over a batch of poses (``sharding.py:202``):
    ``step(src, R, t) -> (R_new, t_new, sse)``, poses split over cubes and
    source points over points.  Correspondences come from the grid's index
    field; the weighted centroids, the cross-covariance and the SSE are
    summed over the point shards, then Horn's quaternion gives the update
    ``new = delta ∘ old``."""
    st = _ShardedStep(mesh, grid)
    targets = torch.as_tensor(targets, dtype=torch.float32)

    def step(src, R, t):
        rows = []
        for row_dev, row in st.shards(src, (R, t)):
            loc = []
            for dev, sp, (R_c, tc) in row:
                with on_device(dev):
                    pts = _points(R_c, tc, sp)                          # [B, Nl, 3]
                    tg = st.placed.get("targets", dev, lambda d: targets.to(d))
                    dst = tg[lookup_index(st.grid_on(dev), pts)]
                    diff = pts - dst
                    loc.append((pts, dst, (diff * diff).sum(-1)))
            d2s = [d2 for _, _, d2 in loc]
            if trim_drop > 0:
                k = min(trim_drop, d2s[0].shape[-1])
                top = gather_top([torch.topk(d2, k, dim=-1).values for d2 in d2s],
                                 trim_drop, row_dev)
                thresh = top[..., -1:]
                ws = [(d2 < thresh.to(d2.device)).to(d2.dtype) for d2 in d2s]
            else:
                ws = [torch.ones_like(d2) for d2 in d2s]
            wsum = torch.clamp(psum([w.sum(-1, keepdim=True) for w in ws], row_dev), min=1e-30)
            mu_s = psum([(pts * w[..., None]).sum(-2) for (pts, _, _), w in zip(loc, ws)],
                        row_dev) / wsum
            mu_d = psum([(dst * w[..., None]).sum(-2) for (_, dst, _), w in zip(loc, ws)],
                        row_dev) / wsum
            Cs = []
            for (pts, dst, _), w in zip(loc, ws):
                a = pts - mu_s.to(pts.device)[..., None, :]
                b = dst - mu_d.to(pts.device)[..., None, :]
                Cs.append((a * w[..., None]).transpose(-1, -2) @ b)
            C = psum(Cs, row_dev)
            R_d = quat_to_matrix(horn_quaternion(C))
            t_d = mu_d - (R_d @ mu_s[..., None])[..., 0]
            R_c, tc = (x.to(row_dev) for x in row[0][2])
            sse = psum([(d2 * w).sum(-1) for d2, w in zip(d2s, ws)], row_dev)
            rows.append((R_d @ R_c, (R_d @ tc[..., None])[..., 0] + t_d, sse))
        return st.out(rows)

    return step
