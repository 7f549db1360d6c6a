"""Fused min-distance and bound kernels — the port of the JAX package's
``nn/mxu.py`` under the same function names.

Layouts are the JAX package's: sources ``srcT [8, Np]`` with rows
(x, y, z, 0…) from :func:`pack_sources` or (x, y, z, ‖p‖, valid, 0…) from
:func:`pack_sources_ext`; targets ``wm [Mp, 8]`` with columns
(m_x, m_y, m_z, 1, |m|², 0…) and padded targets at 1e15; ``Np`` and ``Mp``
padded to multiples of 128; one parameter row per node or group.  The
``pack_*`` functions take numpy arrays or tensors and give the JAX
package's arrays bit for bit.

Each wrapper (:func:`nearest_neighbor_mxu` K1, :func:`bounds_nodes` K2,
:func:`min_d2_groups` K3, :func:`min_d2_nodes` K4,
:func:`bounds_nodes_trimmed` K5, :func:`bounds_groups_trimmed` K6,
:func:`bounds_groups` K7) runs its CUDA kernel (``csrc/``) for CUDA tensors
and its plain PyTorch version (``*_plain``) for CPU tensors; there is no
fallback from one to the other.  Every kernel launch adds one to
:data:`launches`.
"""

from __future__ import annotations

import collections
import ctypes
import functools

import torch

from goicp_tpu_torch.nn import kernels
from goicp_tpu_torch.nn.brute import nearest_neighbor

_PAD_TGT = 1e15     # padded targets: far off every min
TQB = 384           # point-block cap of the screened bounds (mxu.py:391)
_MAX_ELEMS = 1 << 24
_INF = float("inf")
_SENTINEL = 1e30    # screened ub; padded terms of the trimmed sums

# launches of each kernel in this process (plain integers; reset by callers
# that measure a run, e.g. chip_smoke.py)
launches = {
    "nearest_neighbor_mxu": 0, "bounds_nodes": 0, "min_d2_groups": 0,
    "min_d2_nodes": 0, "bounds_nodes_trimmed": 0, "bounds_groups_trimmed": 0,
    "bounds_groups": 0,
}
# K1's launches by (queries, targets), reset with them
nn_launch_shapes = collections.Counter()


def reset_launch_counts():
    for k in launches:
        launches[k] = 0
    nn_launch_shapes.clear()


def _pick_tile(n: int, cap: int, quantum: int = 128) -> int:
    """Largest divisor of ``n`` that is a multiple of ``quantum`` and ≤ cap
    (``mxu.py:50``)."""
    best = quantum
    t = quantum
    while t <= cap:
        if n % t == 0:
            best = t
        t += quantum
    return best


def _f32(x, device=None) -> torch.Tensor:
    return torch.as_tensor(x, dtype=torch.float32, device=device)


def _sq3(v):
    """``sum(v*v, -1)`` over 3 columns, in the order ((x² + y²) + z²)."""
    return (v[..., 0] * v[..., 0] + v[..., 1] * v[..., 1]) + v[..., 2] * v[..., 2]


def fma(a, b, c):
    """``a·b + c`` of f32 tensors rounded once to f32, as the fused
    multiply-add that XLA's CPU build emits where it contracts a product
    into a sum.  Exact on any device: the product is exact in f64, the sum
    is rounded to odd in f64 (its TwoSum error picks the odd neighbour),
    and rounding that to f32 is then the correctly rounded result."""
    a, b, c = a.double(), b.double(), c.double()
    p = a * b
    s = p + c
    bb = s - p
    e = (p - (s - bb)) + (c - bb)
    even = (s.view(torch.int64) & 1) == 0
    toward = torch.copysign(torch.full_like(s, _INF), e)
    s = torch.where((e != 0) & even, torch.nextafter(s, toward), s)
    return s.float()


def sqrt_rn(x):
    """Square root of f32 ``x`` correctly rounded to f32 on any device, as
    XLA's and CUDA's ``sqrtf`` round it; ATen's vectorized CPU ``sqrt`` of
    f32 is not (some values come out one ulp off).  The f64 root
    of an f32 value rounds to the correctly rounded f32 root (53 ≥ 2·24 + 2
    bits)."""
    return torch.sqrt(x.double()).float()


def _sq3_fma(v):
    """``sum(v*v, -1)`` over 3 columns as XLA's jitted CPU reduce adds it:
    ``fma(z, z, fma(y, y, x·x))``."""
    x, y, z = v[..., 0], v[..., 1], v[..., 2]
    return fma(z, z, fma(y, y, x * x))


def _dot3_fma(a, b):
    """``a · b`` over a last axis of 3 as XLA's CPU dot adds it (K = 3):
    ``fma(a₂, b₂, fma(a₁, b₁, a₀·b₀))``; ``a`` and ``b`` broadcast."""
    return fma(a[..., 2], b[..., 2], fma(a[..., 1], b[..., 1], a[..., 0] * b[..., 0]))


# ---------------------------------------------------------------------------
# packing (bit-identical to goicp_tpu.nn.mxu.pack_*)
# ---------------------------------------------------------------------------


def pack_targets(targets) -> torch.Tensor:
    """``[Nt,3] → wm [Mp, 8]`` cols (m_x, m_y, m_z, 1, |m|², 0…), padded to
    the 128-row quantum with off-scale sentinels (``mxu.py:320``)."""
    t = _f32(targets)
    padt = (-t.shape[0]) % 128
    if padt:
        t = torch.cat([t, torch.full((padt, 3), _PAD_TGT, dtype=torch.float32,
                                     device=t.device)])
    wm = torch.zeros((t.shape[0], 8), dtype=torch.float32, device=t.device)
    wm[:, 0:3] = t
    wm[:, 3] = 1.0
    wm[:, 4] = _sq3(t)
    return wm


def pack_sources(src) -> torch.Tensor:
    """``[N,3] → srcT [8, Np]`` rows (x, y, z, 0…), zero-padded to the
    128-lane quantum (``mxu.py:340``)."""
    s = _f32(src)
    n = s.shape[0]
    out = torch.zeros((8, n + (-n) % 128), dtype=torch.float32, device=s.device)
    out[0:3, :n] = s.T
    return out


def pack_sources_ext(src, norms) -> torch.Tensor:
    """``[N,3] → srcT [8, Np]`` rows (x, y, z, ‖p‖, valid, 0…) for the fused
    bounds kernel; padding has valid = 0 (``mxu.py:616``)."""
    s = _f32(src)
    n = s.shape[0]
    out = torch.zeros((8, n + (-n) % 128), dtype=torch.float32, device=s.device)
    out[0:3, :n] = s.T
    out[3, :n] = _f32(norms, s.device)
    out[4, :n] = 1.0
    return out


def pack_params(R, t) -> torch.Tensor:
    """``R [B,3,3], t [B,3] → [B,16]`` rigid-transform rows (``mxu.py:351``)."""
    R = _f32(R)
    B = R.shape[0]
    return torch.cat(
        [R.reshape(B, 9), _f32(t, R.device),
         torch.zeros((B, 4), dtype=torch.float32, device=R.device)], dim=1
    )


def pack_group_params(R, t8) -> torch.Tensor:
    """``R [G,3,3], t8 [G,8,3] → [G,48]`` rows (R×9, 8×t×3, 8×|t|², pad)
    (``mxu.py:290``)."""
    R = _f32(R)
    t8 = _f32(t8, R.device)
    G = R.shape[0]
    return torch.cat(
        [R.reshape(G, 9), t8.reshape(G, 24), _sq3(t8),
         torch.zeros((G, 7), dtype=torch.float32, device=R.device)], dim=1
    )


def pack_params_bounds(R, t, af, gt, slack, thresh) -> torch.Tensor:
    """``[B,16]`` rows (R×9, t×3, af, γt, slack, thresh) (``mxu.py:974``).
    ``slack`` and ``thresh`` are scalars."""
    R = _f32(R)
    B = R.shape[0]
    dev = R.device
    return torch.cat(
        [R.reshape(B, 9), _f32(t, dev), _f32(af, dev)[:, None], _f32(gt, dev)[:, None],
         _col(float(slack), B, dev), _col(float(thresh), B, dev)],
        dim=1,
    )


def _col(x, n: int, dev) -> torch.Tensor:
    """A scalar or ``[n]`` value as an ``[n, 1]`` f32 column."""
    return _f32(x, dev).expand(n)[:, None]


def pack_params_bounds_trimmed(R, t, af, gt, slack, thresh_eff, tau) -> torch.Tensor:
    """``[B,24]`` rows (R×9, t×3, af, γt, slack, thresh', τ, pad)
    (``mxu.py:757``); ``thresh_eff`` and ``tau`` are scalars or ``[B]``."""
    R = _f32(R)
    B = R.shape[0]
    dev = R.device
    return torch.cat(
        [R.reshape(B, 9), _f32(t, dev), _f32(af, dev)[:, None], _f32(gt, dev)[:, None],
         _col(slack, B, dev), _col(thresh_eff, B, dev), _col(tau, B, dev),
         torch.zeros((B, 7), dtype=torch.float32, device=dev)],
        dim=1,
    )


def _pack_group_bounds(R, t8, af, gt8, tail) -> torch.Tensor:
    R = _f32(R)
    t8 = _f32(t8, R.device)
    G = R.shape[0]
    dev = R.device
    cols = [_col(x, G, dev) for x in tail]
    return torch.cat(
        [R.reshape(G, 9), t8.reshape(G, 24), _sq3(t8), _f32(af, dev)[:, None],
         _f32(gt8, dev).reshape(G, 8), *cols,
         torch.zeros((G, 64 - 50 - len(cols)), dtype=torch.float32, device=dev)],
        dim=1,
    )


def pack_group_params_bounds(R, t8, af, gt8, slack, thresh) -> torch.Tensor:
    """``[G,64]`` rows (R×9, t8×24, |t_j|²×8, af, γt×8, slack, thresh, pad)
    (``mxu.py:991``)."""
    return _pack_group_bounds(R, t8, af, gt8, (slack, thresh))


def pack_group_params_bounds_trimmed(R, t8, af, gt8, slack, thresh_eff,
                                     tau) -> torch.Tensor:
    """``[G,64]`` rows (R×9, t8×24, |t_j|²×8, af, γt×8, slack, thresh', τ,
    pad) (``mxu.py:939``); ``thresh_eff`` and ``tau`` are scalars or ``[G]``."""
    return _pack_group_bounds(R, t8, af, gt8, (slack, thresh_eff, tau))


# ---------------------------------------------------------------------------
# kernel plumbing
# ---------------------------------------------------------------------------


def _route(name: str, *tensors) -> bool:
    """True: launch the CUDA kernel; False: run the plain version.  Inputs
    must share one device, and only CPU or CUDA is accepted."""
    dev = tensors[0].device
    for t in tensors:
        if t.device != dev:
            raise ValueError(f"{name}: inputs on {dev} and {t.device}")
    if dev.type == "cuda":
        return True
    if dev.type == "cpu":
        return False
    raise ValueError(f"{name}: unsupported device {dev}")


def _expect(name: str, t: torch.Tensor, shape, dtype=torch.float32):
    if t.dtype != dtype or not t.is_contiguous() or tuple(t.shape) != tuple(shape):
        raise ValueError(
            f"{name}: expected contiguous {dtype} {tuple(shape)}, got "
            f"{t.dtype} {tuple(t.shape)} contiguous={t.is_contiguous()}"
        )


def _stream(t: torch.Tensor):
    return torch.cuda.current_stream(t.device).cuda_stream


def _launch(name: str, fn, *args):
    """Call the C entry point ``fn``, raise on its CUDA error, count it."""
    kernels.check(fn(*args), name)
    launches[name] += 1


def _rows(P, r0: int, px, py, pz):
    """``((px·P[r0] + py·P[r0+1]) + pz·P[r0+2])`` for every row of ``P``:
    one row of R·p per node, ``[B, Np]``, in the kernels' order."""
    return (px[None] * P[:, r0:r0 + 1] + py[None] * P[:, r0 + 1:r0 + 2]) \
        + pz[None] * P[:, r0 + 2:r0 + 3]


def _transform(params, srcT):
    px, py, pz = srcT[0], srcT[1], srcT[2]
    qx = _rows(params, 0, px, py, pz) + params[:, 9:10]
    qy = _rows(params, 3, px, py, pz) + params[:, 10:11]
    qz = _rows(params, 6, px, py, pz) + params[:, 11:12]
    return qx, qy, qz


def _min_d2_plain(qx, qy, qz, wm, tile: int = 512):
    """Min over targets of |m − q|² (diff form) for query coordinate
    tensors of any shape; chunked over queries."""
    shape = qx.shape
    qx, qy, qz = qx.reshape(-1), qy.reshape(-1), qz.reshape(-1)
    best = torch.full_like(qx, _INF)
    qc = max(1, _MAX_ELEMS // tile)
    for q0 in range(0, qx.shape[0], qc):
        sl = slice(q0, q0 + qc)
        b = best[sl]
        for m0 in range(0, wm.shape[0], tile):
            w = wm[m0:m0 + tile]
            dx = w[None, :, 0] - qx[sl, None]
            dy = w[None, :, 1] - qy[sl, None]
            dz = w[None, :, 2] - qz[sl, None]
            b.copy_(torch.minimum(b, ((dx * dx + dy * dy) + dz * dz).amin(dim=1)))
    return best.reshape(shape)


# ---------------------------------------------------------------------------
# K1: exact nearest neighbour (csrc/nn_min_d2.cu, nn_query_kernel)
# ---------------------------------------------------------------------------


_NN_MIN_SLICE = 64       # targets a split walks at the least


def pack_nn_targets(targets) -> torch.Tensor:
    """K1's target layout ``[Mp, 4]``: the first four columns of
    :func:`pack_targets` (m_x, m_y, m_z, 1; padded rows at 1e15).  A caller
    that queries one cloud many times (the ICP) packs it once."""
    return pack_targets(targets)[:, :4].contiguous()


def nn_route(Q: int, Mp: int, sms: int):
    """K1's launch shape ``(splits, queries per thread)`` for ``Q`` queries
    against ``Mp`` padded targets on a card of ``sms`` SMs.  Up to 4 CTAs
    per SM of one query per thread (32 queries a CTA), as an in-round
    refine's 12,144 queries make: 8 target splits, so that the work spreads
    finely over the SMs.  Above that, 4 queries per thread and 4 splits
    (256 queries a CTA), whose register blocking spends fewer loads and
    selects per pair.  A split walks at least 64 targets.
    (``nn_ab.py --routes`` times every route at the bunny solve's shapes.)"""
    s, qr = (8, 1) if -(-Q // 32) <= 4 * sms else (4, 4)
    while s > 1 and Mp // s < _NN_MIN_SLICE:
        s //= 2
    return s, qr


@functools.lru_cache(maxsize=None)
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def _nn_kernel(flat, t4, nt: int, route=None):
    """K1 on ``flat [Q, 3]`` against ``t4 [Mp, 4]`` (``nt`` real targets):
    ``(d2 [Q], idx [Q] int32)``, ``idx`` clamped to ``nt − 1`` and ``d2``
    taken from that target.  ``route`` forces ``(splits, qr)``."""
    Q, Mp = flat.shape[0], t4.shape[0]
    _expect("nearest_neighbor_mxu", flat, (Q, 3))
    _expect("nearest_neighbor_mxu", t4, (Mp, 4))
    splits, qr = route or nn_route(Q, Mp, _sm_count(flat.device.index))
    d2 = torch.empty((Q,), dtype=torch.float32, device=flat.device)
    idx = torch.empty((Q,), dtype=torch.int32, device=flat.device)
    _launch("nearest_neighbor_mxu", kernels.lib().goicp_nn_query,
            flat.data_ptr(), Q, t4.data_ptr(), Mp, nt, splits, qr,
            d2.data_ptr(), idx.data_ptr(), _stream(flat))
    nn_launch_shapes[(Q, nt)] += 1
    return d2, idx


def nearest_neighbor_mxu(queries, targets, packed=None):
    """Exact NN (values + indices), the drop-in of ``nn.brute.nearest_neighbor``
    (``mxu.py:1026``): ``queries [..., Q, 3]``, ``targets [Nt, 3]`` →
    ``(d2 [..., Q], idx [..., Q] int32)``.  As in the JAX wrapper, the index
    is clamped to ``Nt − 1`` and ``d2`` is that target's distance,
    ``_sq3(q − m_idx)``: the CPU route recomputes it after the plain
    version, the kernel returns it bit for bit.  ``packed`` is
    :func:`pack_nn_targets` of ``targets``, made once by a caller that
    queries them many times; without it the CUDA route packs per call.
    """
    batch_shape = queries.shape[:-2]
    Q = queries.shape[-2]
    flat = queries.reshape(-1, 3).contiguous()
    tensors = (flat, targets) if packed is None else (flat, targets, packed)
    if _route("nearest_neighbor_mxu", *tensors):
        if flat.shape[0] == 0:
            d2 = torch.zeros((0,), dtype=torch.float32, device=flat.device)
            idx = torch.zeros((0,), dtype=torch.int32, device=flat.device)
        else:
            t4 = pack_nn_targets(targets) if packed is None else packed
            d2, idx = _nn_kernel(flat, t4, targets.shape[0])
    else:
        _, idx = nearest_neighbor(flat, targets)
        idx = torch.clamp(idx, max=targets.shape[0] - 1)
        d2 = _sq3(flat - targets.index_select(0, idx))
    return d2.reshape(*batch_shape, Q), idx.reshape(*batch_shape, Q)


# ---------------------------------------------------------------------------
# K3: grouped min distances (csrc/min_d2_grouped.cu)
# ---------------------------------------------------------------------------


def min_d2_groups_plain(srcT, wm, gparams, tile: int = 512):
    """Plain version of K3 (``mxu.py:196``, diff form): ``d2 [8G, Np]``."""
    P = gparams
    G, Np = P.shape[0], srcT.shape[1]
    px, py, pz = srcT[0], srcT[1], srcT[2]
    ux = _rows(P, 0, px, py, pz)
    uy = _rows(P, 3, px, py, pz)
    uz = _rows(P, 6, px, py, pz)                          # [G, Np]
    t = P[:, 9:33].reshape(G, 8, 3)
    tn = P[:, 33:41]
    wx, wy, wz = wm[:, 0], wm[:, 1], wm[:, 2]
    s = (t[..., 0:1] * wx + t[..., 1:2] * wy) + t[..., 2:3] * wz
    b = tn[..., None] - 2.0 * s                           # [G, 8, Mp]
    best = torch.full((G, 8, Np), _INF, dtype=torch.float32, device=srcT.device)
    gc = max(1, _MAX_ELEMS // (Np * tile))
    for g0 in range(0, G, gc):
        gs = slice(g0, g0 + gc)
        for m0 in range(0, wm.shape[0], tile):
            ms = slice(m0, m0 + tile)
            dx = wx[None, None, ms] - ux[gs, :, None]
            dy = wy[None, None, ms] - uy[gs, :, None]
            dz = wz[None, None, ms] - uz[gs, :, None]
            Gp = (dx * dx + dy * dy) + dz * dz            # [gc, Np, tile]
            for j in range(8):
                cur = (Gp + b[gs, j, None, ms]).amin(dim=2)
                best[gs, j] = torch.minimum(best[gs, j], cur)
    a = 2.0 * ((t[..., 0:1] * ux[:, None] + t[..., 1:2] * uy[:, None])
               + t[..., 2:3] * uz[:, None])               # [G, 8, Np]
    return torch.clamp(best + a, min=0.0).reshape(8 * G, Np)


def min_d2_groups(srcT, wm, gparams):
    """Exact min squared distances for 8-sibling translation groups:
    ``d2 [8·G, Np]``, row ``8g+j`` = node (R_g, t_{g,j}) (``mxu.py:303``)."""
    if not _route("min_d2_groups", srcT, wm, gparams):
        return min_d2_groups_plain(srcT, wm, gparams)
    G, Np, Mp = gparams.shape[0], srcT.shape[1], wm.shape[0]
    _expect("min_d2_groups", srcT, (8, Np))
    _expect("min_d2_groups", wm, (Mp, 8))
    _expect("min_d2_groups", gparams, (G, 48))
    d2 = torch.empty((8 * G, Np), dtype=torch.float32, device=srcT.device)
    if G == 0:
        return d2
    _launch("min_d2_groups", kernels.lib().goicp_min_d2_grouped,
            gparams.data_ptr(), G, srcT.data_ptr(), Np, wm.data_ptr(), Mp,
            d2.data_ptr(), _stream(srcT))
    return d2


# ---------------------------------------------------------------------------
# plain helpers shared by the bound kernels K2, K5, K6, K7
# ---------------------------------------------------------------------------


def _point_terms(d2, slack, af, pn, gt):
    """Yang et al. eq. 10 per point from squared distances: ``d_hi = d +
    slack`` and ``c = max(max(d − slack, 0) − (af·|p| + γt), 0)`` (the ub
    term is ``d_hi²``, the lb term ``c²``), in the kernels' order."""
    d = sqrt_rn(torch.clamp(d2, min=0.0))
    d_hi = d + slack
    d_lo = torch.clamp(d - slack, min=0.0)
    return d_hi, torch.clamp(d_lo - (af * pn + gt), min=0.0)


def _block_sums(x, tq: int):
    """Sums over point blocks of ``tq``: ``[..., Np] → [..., Np/tq]``."""
    return x.reshape(*x.shape[:-1], x.shape[-1] // tq, tq).sum(-1)


def _scan(blks, thresh, group: bool):
    """Carry the block sums ``blks`` (``[B, nb]``, or ``[G, 8, nb]`` when
    ``group``) block by block while the last one's carry — for a group the
    smallest of its 8 siblings — is below ``thresh`` ``[B]``/``[G]``, as the
    TPU kernels' ``lax.cond`` per block does.  Returns the carries and the
    blocks run per row."""
    accs = [torch.zeros(b.shape[:-1], dtype=torch.float32, device=b.device) for b in blks]
    runs = torch.zeros(thresh.shape, dtype=torch.int64, device=thresh.device)
    for n in range(blks[0].shape[-1]):
        lead = accs[-1].amin(-1) if group else accs[-1]
        run = lead < thresh
        r = run[:, None] if group else run
        accs = [torch.where(r, a + b[..., n], a) for a, b in zip(accs, blks)]
        runs += run
    return accs, runs


def screen_scan(ub_blk, lb_blk, thresh, group: bool = False):
    """The screening rule over block sums: a block is added only while the
    carried lb (a group's smallest) is below ``thresh``; ub = 1e30 once it
    is not (``mxu.py:462-473``, ``:575-581``).  Returns ``(ub, lb,
    blocks_run)``."""
    (ub, lb), blocks = _scan([ub_blk, lb_blk], thresh, group)
    keep = (lb.amin(-1) < thresh)[:, None] if group else lb < thresh
    return torch.where(keep, ub, torch.full_like(ub, _SENTINEL)), lb, blocks


def ordered_row_sum(x):
    """Row sums ``[..., n] → [...]`` in the order in which XLA's CPU backend
    adds a row: windows of 32 in sequence (again over the window sums while
    more than 32 remain), then the last ≤ 32 sums in sequence.  A row whose
    length is not a multiple of 32 is padded with zeros on both sides, the
    smaller half in front, as XLA's reduce-window pads it.  Only
    element-wise adds, so the card and the CPU agree bit for bit."""
    while x.shape[-1] > 32:
        pad = (-x.shape[-1]) % 32
        if pad:
            x = torch.nn.functional.pad(x, (pad // 2, pad - pad // 2))
        x = x.reshape(*x.shape[:-1], -1, 32)
        acc = x[..., 0]
        for k in range(1, 32):
            acc = acc + x[..., k]
        x = acc
    acc = x[..., 0]
    for k in range(1, x.shape[-1]):
        acc = acc + x[..., k]
    return acc


def trimmed_sum_bisect(x, h: int, upper: bool, iters: int = 24, ordered: bool = False):
    """Sum of the ``h`` smallest entries per row of ``x [M, Np]`` by
    bisection on a value threshold (``bnb/se3_eval.py:30``, and the
    in-kernel reduction of ``mxu.py``'s trimmed kernels): after ``iters``
    halvings ``S(lo) + (h − C(lo))·lo ≤ trimmed_h ≤ S(lo) + (h − C(lo))·hi``
    with ``S``/``C`` the masked sum and count; ``upper`` picks the side.
    Entries ≥ 1e29 are padding and never counted.  ``ordered``: ``S`` by
    :func:`ordered_row_sum` and ``S + rem·τ`` rounded once, as the JAX
    package's jitted CPU build computes them (a fused multiply-add)."""
    rowmax = torch.where(x < 1e29, x, torch.zeros_like(x)).amax(-1)
    lo = torch.zeros_like(rowmax)
    hi = rowmax + 1e-12
    for _ in range(iters):
        mid = 0.5 * (lo + hi)
        cnt = (x <= mid[:, None]).sum(-1).to(torch.float32)
        take = cnt >= h
        lo, hi = torch.where(take, lo, mid), torch.where(take, mid, hi)
    sel = x <= lo[:, None]
    kept = torch.where(sel, x, torch.zeros_like(x))
    C = sel.sum(-1).to(torch.float32)
    rem = torch.clamp(h - C, min=0.0)
    tau = hi if upper else lo
    if ordered:
        # rem·τ is exact in f64; one rounding of the sum, as an FMA gives
        return (ordered_row_sum(kept).double() + rem.double() * tau.double()).float()
    return kept.sum(-1) + rem * tau


def _staged(term, pv):
    """A trimmed kernel's scratch row: ``term·valid``, padding at 1e30."""
    return term * pv + (1.0 - pv) * _SENTINEL


# ---------------------------------------------------------------------------
# K2: screened fused bounds (csrc/bounds.cu)
# ---------------------------------------------------------------------------


def bounds_block_sums_plain(srcT_ext, wm, params):
    """Per point-block sums of the ub and lb terms, ``[B, nb]`` each, with
    blocks of ``tq = _pick_tile(Np, 384)`` points (no screening)."""
    Np = srcT_ext.shape[1]
    tq = _pick_tile(Np, TQB)
    d_hi, c = _point_terms(
        _min_d2_plain(*_transform(params, srcT_ext), wm), params[:, 14:15],
        params[:, 12:13], srcT_ext[3][None], params[:, 13:14],
    )
    pv = srcT_ext[4][None]
    return _block_sums((d_hi * d_hi) * pv, tq), _block_sums((c * c) * pv, tq)


def bounds_nodes_plain(srcT_ext, wm, params):
    """Plain version of K2 (``mxu.py:403``): ``(ub, lb) [B]``."""
    ub_blk, lb_blk = bounds_block_sums_plain(srcT_ext, wm, params)
    ub, lb, _ = screen_scan(ub_blk, lb_blk, params[:, 15])
    return ub, lb


def bounds_nodes(srcT_ext, wm, params):
    """Fused screened bounds for singleton nodes: ``(ub, lb) [B]``
    (``mxu.py:1012``)."""
    if not _route("bounds_nodes", srcT_ext, wm, params):
        return bounds_nodes_plain(srcT_ext, wm, params)
    B, Np, Mp = params.shape[0], srcT_ext.shape[1], wm.shape[0]
    _expect("bounds_nodes", srcT_ext, (8, Np))
    _expect("bounds_nodes", wm, (Mp, 8))
    _expect("bounds_nodes", params, (B, 16))
    ub = torch.empty((B,), dtype=torch.float32, device=params.device)
    lb = torch.empty_like(ub)
    if B == 0:
        return ub, lb
    _launch("bounds_nodes", kernels.lib().goicp_bounds_nodes,
            params.data_ptr(), B, srcT_ext.data_ptr(), Np, wm.data_ptr(), Mp,
            _pick_tile(Np, TQB), ub.data_ptr(), lb.data_ptr(), _stream(params))
    return ub, lb


# ---------------------------------------------------------------------------
# K4: per-node min distances (csrc/nn_min_d2.cu, min_d2_nodes_kernel)
# ---------------------------------------------------------------------------


def min_d2_nodes_plain(srcT, wm, params):
    """Plain version of K4 (``mxu.py:361``): ``d2 [B, Np]``."""
    return torch.clamp(_min_d2_plain(*_transform(params, srcT), wm), min=0.0)


def min_d2_nodes(srcT, wm, params):
    """Per-node exact min squared distances ``d2 [B, Np]`` for the queries
    ``R_b·p + t_b`` (``mxu.py:361``): K1's source without the index."""
    if not _route("min_d2_nodes", srcT, wm, params):
        return min_d2_nodes_plain(srcT, wm, params)
    B, Np, Mp = params.shape[0], srcT.shape[1], wm.shape[0]
    _expect("min_d2_nodes", srcT, (8, Np))
    _expect("min_d2_nodes", wm, (Mp, 8))
    _expect("min_d2_nodes", params, (B, 16))
    d2 = torch.empty((B, Np), dtype=torch.float32, device=srcT.device)
    if B == 0:
        return d2
    _launch("min_d2_nodes", kernels.lib().goicp_nn_min_d2,
            params.data_ptr(), B, srcT.data_ptr(), Np, wm.data_ptr(), Mp,
            d2.data_ptr(), None, _stream(srcT))
    return d2


# ---------------------------------------------------------------------------
# K5: screened trimmed bounds (csrc/bounds_trimmed.cu)
# ---------------------------------------------------------------------------


def bounds_nodes_trimmed_plain(srcT_ext, wm, params, *, h: int, drop: int,
                               with_blocks: bool = False):
    """Plain version of K5 (``mxu.py:632``): clamped-sum screen over point
    blocks of ``_pick_tile(Np, 384)``, exact bisection-trimmed sums for the
    survivors, ``(1e30, Σl̃ − drop·τ)`` for screened nodes.
    ``with_blocks`` also returns the point blocks each node ran."""
    Np = srcT_ext.shape[1]
    d_hi, c = _point_terms(
        _min_d2_plain(*_transform(params, srcT_ext), wm), params[:, 14:15],
        params[:, 12:13], srcT_ext[3][None], params[:, 13:14],
    )
    pv = srcT_ext[4][None]
    lt = c * c
    thresh, tau = params[:, 15], params[:, 16]
    (acc,), blocks = _scan(
        [_block_sums(torch.minimum(lt, tau[:, None]) * pv, _pick_tile(Np, TQB))],
        thresh, group=False,
    )
    ub = trimmed_sum_bisect(_staged(d_hi * d_hi, pv), h, upper=True)
    lb = trimmed_sum_bisect(_staged(lt, pv), h, upper=False)
    screened = acc >= thresh
    out = (torch.where(screened, torch.full_like(ub, _SENTINEL), ub),
           torch.where(screened, acc - drop * tau, lb))
    return (*out, blocks) if with_blocks else out


def bounds_nodes_trimmed(srcT_ext, wm, params, *, h: int, drop: int):
    """Fused screened TRIMMED bounds for singleton nodes: ``(ub, lb) [B]``
    (``mxu.py:777``).  The kernel keeps each node's ``[2, Np]`` scratch in
    shared memory; a source too large for it (Np above ~29,000) raises."""
    if not _route("bounds_nodes_trimmed", srcT_ext, wm, params):
        return bounds_nodes_trimmed_plain(srcT_ext, wm, params, h=h, drop=drop)
    return _k5_kernel(srcT_ext, wm, params, h, drop)


def _k5_kernel(srcT_ext, wm, params, h: int, drop: int, warps: int = 0):
    """K5's launch; ``warps`` forces the warps per CTA (0: the plan's pick,
    the most resident warps per SM)."""
    B, Np, Mp = params.shape[0], srcT_ext.shape[1], wm.shape[0]
    _expect("bounds_nodes_trimmed", srcT_ext, (8, Np))
    _expect("bounds_nodes_trimmed", wm, (Mp, 8))
    _expect("bounds_nodes_trimmed", params, (B, 24))
    ub = torch.empty((B,), dtype=torch.float32, device=params.device)
    lb = torch.empty_like(ub)
    if B == 0:
        return ub, lb
    counter = torch.empty((1,), dtype=torch.int32, device=params.device)
    _launch("bounds_nodes_trimmed", kernels.lib().goicp_bounds_nodes_trimmed,
            params.data_ptr(), B, srcT_ext.data_ptr(), Np, wm.data_ptr(), Mp,
            _pick_tile(Np, TQB), int(warps), int(h), int(drop), counter.data_ptr(),
            ub.data_ptr(), lb.data_ptr(), _stream(params))
    return ub, lb


def k5_plan(B: int, Np: int, Mp: int, warps: int = 0) -> dict:
    """K5's launch plan on the current card, without a launch: targets
    resident in shared memory or read from global memory, warps per CTA,
    persistent grid, dynamic shared bytes."""
    out = (ctypes.c_int * 4)()
    kernels.check(kernels.lib().goicp_bounds_nodes_trimmed_plan(
        B, Np, Mp, _pick_tile(Np, TQB), int(warps), ctypes.addressof(out)), "k5_plan")
    return dict(targets_resident=bool(out[0]), warps=out[1], grid=out[2], smem=out[3])


# ---------------------------------------------------------------------------
# K6 and K7: screened grouped bounds, trimmed and untrimmed
# (csrc/bounds_trimmed_grouped.cu, csrc/bounds_grouped.cu)
# ---------------------------------------------------------------------------


def _grouped_terms(srcT_ext, wm, gparams):
    """Per sibling ``(d_hi, c)``, ``[G, 8, Np]`` each, from K3's separable
    distances; ``gparams [G,64]`` (af 41, γt 42-49, slack 50)."""
    G, Np = gparams.shape[0], srcT_ext.shape[1]
    d2 = min_d2_groups_plain(srcT_ext, wm, gparams).reshape(G, 8, Np)
    return _point_terms(d2, gparams[:, 50, None, None], gparams[:, 41, None, None],
                        srcT_ext[3], gparams[:, 42:50, None])


def bounds_groups_trimmed_plain(srcT_ext, wm, gparams, *, h: int, drop: int,
                                with_blocks: bool = False):
    """Plain version of K6 (``mxu.py:787``): K5 per sibling, with the
    screen at group level (every sibling's clamped sum crossed).
    ``with_blocks`` also returns the point blocks each group ran."""
    G, Np = gparams.shape[0], srcT_ext.shape[1]
    d_hi, c = _grouped_terms(srcT_ext, wm, gparams)
    pv = srcT_ext[4]
    lt = c * c
    thresh, tau = gparams[:, 51], gparams[:, 52]
    (acc,), blocks = _scan(
        [_block_sums(torch.minimum(lt, tau[:, None, None]) * pv, _pick_tile(Np, TQB))],
        thresh, group=True,
    )
    ub = trimmed_sum_bisect(_staged(d_hi * d_hi, pv).reshape(8 * G, Np), h, upper=True)
    lb = trimmed_sum_bisect(_staged(lt, pv).reshape(8 * G, Np), h, upper=False)
    screened = (acc.amin(-1) >= thresh).repeat_interleave(8)
    out = (torch.where(screened, torch.full_like(ub, _SENTINEL), ub),
           torch.where(screened, (acc - drop * tau[:, None]).reshape(-1), lb))
    return (*out, blocks) if with_blocks else out


def bounds_groups_trimmed(srcT_ext, wm, gparams, *, h: int, drop: int):
    """Fused screened TRIMMED bounds for 8-sibling groups: ``(ub, lb)
    [8G]`` in group-major order (``mxu.py:963``)."""
    if not _route("bounds_groups_trimmed", srcT_ext, wm, gparams):
        return bounds_groups_trimmed_plain(srcT_ext, wm, gparams, h=h, drop=drop)
    return _k6_kernel(srcT_ext, wm, gparams, h, drop)


def k6_qr(tq: int) -> int:
    """K6's points per thread for point blocks of ``tq``: 128 threads a CTA
    (``nn_ab.py --routes`` times the others)."""
    return tq // 128


@functools.lru_cache(maxsize=None)
def _k6_ctas(index: int, tq: int, qr: int) -> int:
    with torch.cuda.device(index):
        return kernels.lib().goicp_bounds_groups_trimmed_ctas(tq, qr)


def _k6_kernel(srcT_ext, wm, gparams, h: int, drop: int, qr: int = 0):
    """K6's launch over ``min(G, persistent CTAs)`` CTAs, each with a
    ``[16, Np]`` slot of a global scratch; ``qr`` forces the points per
    thread (0: :func:`k6_qr`)."""
    G, Np, Mp = gparams.shape[0], srcT_ext.shape[1], wm.shape[0]
    _expect("bounds_groups_trimmed", srcT_ext, (8, Np))
    _expect("bounds_groups_trimmed", wm, (Mp, 8))
    _expect("bounds_groups_trimmed", gparams, (G, 64))
    ub = torch.empty((8 * G,), dtype=torch.float32, device=gparams.device)
    lb = torch.empty_like(ub)
    if G == 0:
        return ub, lb
    tq = _pick_tile(Np, TQB)
    qr = qr or k6_qr(tq)
    ctas = _k6_ctas(gparams.device.index, tq, qr)
    if ctas <= 0:
        raise ValueError(f"bounds_groups_trimmed: no launch for {qr} points per thread "
                         f"at blocks of {tq}")
    grid = min(G, ctas)
    scratch = torch.empty((grid, 16, Np), dtype=torch.float32, device=gparams.device)
    counter = torch.empty((1,), dtype=torch.int32, device=gparams.device)
    _launch("bounds_groups_trimmed", kernels.lib().goicp_bounds_groups_trimmed,
            gparams.data_ptr(), G, srcT_ext.data_ptr(), Np, wm.data_ptr(), Mp,
            tq, qr, int(h), int(drop), grid, scratch.data_ptr(), counter.data_ptr(),
            ub.data_ptr(), lb.data_ptr(), _stream(gparams))
    return ub, lb


def bounds_groups_plain(srcT_ext, wm, gparams, with_blocks: bool = False):
    """Plain version of K7 (``mxu.py:502``): ``(ub, lb) [8G]``;
    ``with_blocks`` also returns the point blocks each group ran."""
    Np = srcT_ext.shape[1]
    tq = _pick_tile(Np, TQB)
    d_hi, c = _grouped_terms(srcT_ext, wm, gparams)
    pv = srcT_ext[4]
    ub, lb, blocks = screen_scan(_block_sums((d_hi * d_hi) * pv, tq),
                                 _block_sums((c * c) * pv, tq), gparams[:, 51], group=True)
    out = (ub.reshape(-1), lb.reshape(-1))
    return (*out, blocks) if with_blocks else out


def bounds_groups(srcT_ext, wm, gparams):
    """Fused screened bounds for 8-sibling groups: ``(ub, lb) [8G]``
    (``mxu.py:1019``)."""
    if not _route("bounds_groups", srcT_ext, wm, gparams):
        return bounds_groups_plain(srcT_ext, wm, gparams)
    G, Np, Mp = gparams.shape[0], srcT_ext.shape[1], wm.shape[0]
    _expect("bounds_groups", srcT_ext, (8, Np))
    _expect("bounds_groups", wm, (Mp, 8))
    _expect("bounds_groups", gparams, (G, 64))
    ub = torch.empty((8 * G,), dtype=torch.float32, device=gparams.device)
    lb = torch.empty_like(ub)
    if G == 0:
        return ub, lb
    _launch("bounds_groups", kernels.lib().goicp_bounds_groups,
            gparams.data_ptr(), G, srcT_ext.data_ptr(), Np, wm.data_ptr(), Mp,
            _pick_tile(Np, TQB), ub.data_ptr(), lb.data_ptr(), _stream(gparams))
    return ub, lb
