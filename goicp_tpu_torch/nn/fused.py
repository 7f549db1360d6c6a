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
:func:`bounds_groups` K7, and :func:`min_d2_padded`, K1 over node poses)
runs its CUDA kernel (``csrc/``) for CUDA tensors and its plain PyTorch
version (``*_plain``) for CPU tensors; there is no fallback from one to the
other.  Every kernel launch adds one to :data:`launches`.

K1/K4 and K3 take the TPU kernel's ``variant=`` (:data:`FORMS`): the
distance forms "diff" (every solver path), "exp" (K1/K4, K3) and "dot"
(K1/K4).
"""

from __future__ import annotations

import collections
import ctypes
import functools

import numpy as np
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
    # the forms on no solver path: K4 and K1 over node poses, K3
    "min_d2_nodes_exp": 0, "min_d2_nodes_dot": 0, "min_d2_padded": 0,
    "min_d2_padded_exp": 0, "min_d2_padded_dot": 0, "min_d2_groups_exp": 0,
}
# the distance forms of mxu.py's _min_d2_kernel (`variant=`), by the code
# csrc/common.cuh gives them
FORMS = {"diff": 0, "exp": 1, "dot": 2}
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


_F32_MID = 1 << 28            # the low 29 bits of an f32 midpoint's f64 significand
_F32_TINY = 2.0 ** -126       # below: f32 subnormals, whose midpoints lie elsewhere


def fma_bulk(a, b, c):
    """:func:`fma`'s bits at a fraction of its passes over large tensors:
    ``c + a·b`` in f64 (the product is exact) rounded to f32, which is the
    correctly rounded result unless the f64 sum sits exactly on an f32
    midpoint (rounding to f64 never crosses one); those elements, and f32
    subnormal results, take :func:`fma`.  Pass the operands unexpanded
    (they broadcast here).  It synchronises a CUDA stream once."""
    s = torch.addcmul(c.double(), a.double(), b.double())
    out = s.float()
    odd = ((s.view(torch.int64) & (2 * _F32_MID - 1)) == _F32_MID) \
        | ((s.abs() < _F32_TINY) & (s != 0))
    if bool(odd.any()):
        a, b, c = torch.broadcast_tensors(a, b, c)
        out[odd] = fma(a[odd], b[odd], c[odd])
    return out


def sqrt_rn(x):
    """Square root of f32 ``x`` correctly rounded to f32 on any device, as
    XLA's and CUDA's ``sqrtf`` round it; ATen's vectorized CPU ``sqrt`` of
    f32 is not (some values come out one ulp off).  The f64 root
    of an f32 value rounds to the correctly rounded f32 root (53 ≥ 2·24 + 2
    bits)."""
    return torch.sqrt(x.double()).float()


# The f32 sine, cosine and arc cosine of the JAX package's jitted CPU
# functions.  XLA's CPU backend calls the C library's sinf, cosf and atan2f
# (jnp.arccos(x) is atan2f(sqrt((1 - x)(1 + x)), x)); these repeat glibc
# 2.36's algorithms (sysdeps/ieee754/flt-32: s_sinf.c, s_cosf.c with their
# double-precision polynomials; e_atan2f.c and s_atanf.c in f32) as tensor
# operations, bit for bit, on any device.  ATen's sin, cos and acos give
# other last bits.

_HPI_INV = float.fromhex("0x1.45f306dc9c883p-1")       # 2/π
_HPI = float.fromhex("0x1.921fb54442d18p0")            # π/2
_SC_C = [float.fromhex(h) for h in ("0x1p0", "-0x1.ffffffd0c621cp-2", "0x1.55553e1068f19p-5",
                                     "-0x1.6c087e89a359dp-10", "0x1.99343027bf8c3p-16")]
_SC_S = [float.fromhex(h) for h in ("-0x1.555545995a603p-3", "0x1.1107605230bc4p-7",
                                     "-0x1.994eb3774cf24p-13")]


def sincos_libm(y):
    """``(sin y, cos y)`` of f32 ``y``, |y| < 120, as glibc's ``sinf`` and
    ``cosf`` round them: below 0.75 the polynomials in ``x = y`` (f64),
    else ``x - n·π/2`` for the nearest quadrant ``n``, a sign and the
    quadrant's polynomial; below 2⁻¹² ``y`` and 1."""
    x = y.double()
    top = (y.view(torch.int32) >> 20) & 0x7FF
    small = top < 0x3F4
    n = torch.where(small, torch.zeros_like(x), torch.round(x * _HPI_INV))
    r = torch.where(small, x, x - n * _HPI)
    q = n.to(torch.int64)
    sgn = 1.0 - 2.0 * ((q ^ (q >> 1)) & 1).double()       # +1, -1, -1, +1 by q mod 4
    xs, x2 = r * sgn, r * r
    x3 = xs * x2
    ps = (xs + x3 * _SC_S[0]) + (x3 * x2) * (_SC_S[1] + x2 * _SC_S[2])
    x4 = x2 * x2
    pc = ((_SC_C[0] + x2 * _SC_C[1]) + x4 * _SC_C[2]) + (x4 * x2) * (_SC_C[3] + x2 * _SC_C[4])
    pc = torch.where((q & 2) == 2, -pc, pc)
    odd = (q & 1) == 1
    tiny = top < 0x398
    sin = torch.where(tiny, y, torch.where(odd, pc, ps).float())
    cos = torch.where(tiny, torch.ones_like(y), torch.where(odd, ps, pc).float())
    return sin, cos


def _f32v(v: float) -> float:
    """``v`` rounded to f32, as a Python float: a scalar operand that f32
    tensor arithmetic takes as it is, with no copy to the device."""
    return float(np.float32(v))


_ATANHI = [_f32v(v) for v in (4.6364760399e-01, 7.8539812565e-01, 9.8279368877e-01,
                              1.5707962513e+00)]
_ATANLO = [_f32v(v) for v in (5.0121582440e-09, 3.7748947079e-08, 3.4473217170e-08,
                              7.5497894159e-08)]
_AT = [_f32v(v) for v in (3.3333334327e-01, -2.0000000298e-01, 1.4285714924e-01,
                          -1.1111110449e-01, 9.0908870101e-02, -7.6918758452e-02,
                          6.6610731184e-02, -5.8335702866e-02, 4.9768779427e-02,
                          -3.6531571299e-02, 1.6285819933e-02)]
_PI_F, _PIO2_F, _PI_LO_F = _f32v(3.1415927410e+00), _f32v(1.5707963705e+00), _f32v(-8.7422776573e-08)
_ATAN_HUGE = _f32v(np.float32(_PIO2_F) + np.float32(0.5) * np.float32(_PI_LO_F))


def _atanf_pos(w):
    """glibc's ``atanf`` of f32 ``w ≥ 0`` (fdlibm: a reduction into four
    intervals, then an 11-term odd polynomial, every step in f32)."""
    iw = w.view(torch.int32)
    idx = ((iw >= 0x3EE00000).int() + (iw >= 0x3F300000).int() + (iw >= 0x3F980000).int()
           + (iw >= 0x401C0000).int()) - 1                 # -1, then intervals 0-3
    x = torch.where(idx == 0, (2.0 * w - 1.0) / (2.0 + w),
        torch.where(idx == 1, (w - 1.0) / (w + 1.0),
        torch.where(idx == 2, (w - 1.5) / (1.0 + 1.5 * w),
        torch.where(idx == 3, -1.0 / w, w))))
    z = x * x
    q = z * z
    a = _AT
    s1 = z * (a[0] + q * (a[2] + q * (a[4] + q * (a[6] + q * (a[8] + q * a[10])))))
    s2 = q * (a[1] + q * (a[3] + q * (a[5] + q * (a[7] + q * a[9]))))
    hi = torch.full_like(w, _ATANHI[0])
    lo = torch.full_like(w, _ATANLO[0])
    for k in (1, 2, 3):
        hi = torch.where(idx == k, _ATANHI[k], hi)
        lo = torch.where(idx == k, _ATANLO[k], lo)
    out = torch.where(idx < 0, x - x * (s1 + s2), hi - ((x * (s1 + s2) - lo) - x))
    out = torch.where(iw >= 0x4C000000, _f32v(np.float32(_ATANHI[3]) + np.float32(_ATANLO[3])),
                      out)
    return torch.where(iw < 0x31000000, w, out)


def acos_libm(x):
    """``arccos`` of f32 ``x`` in [-1, 1] as XLA's CPU build computes it:
    ``atan2f(sqrt((1 - x)·(1 + x)), x)`` with glibc's ``atan2f``."""
    y = sqrt_rn((1.0 - x) * (1.0 + x))
    iy, hx = y.view(torch.int32), x.view(torch.int32)
    ix = hx & 0x7FFFFFFF
    k = (iy - ix) >> 23
    z = _atanf_pos(torch.abs(y / x))
    z = torch.where(k > 60, _ATAN_HUGE, z)
    z = torch.where((hx < 0) & (k < -60), 0.0, z)
    out = torch.where(hx < 0, _PI_F - (z - _PI_LO_F), z)
    out = torch.where(ix == 0, _PIO2_F, out)
    return torch.where(iy == 0, torch.where(hx < 0, _PI_F, y), out)


def _dot3c(a0, a1, a2, b0, b1, b2):
    """``a0·b0 + a1·b1 + a2·b2`` as XLA's CPU build contracts it inside an
    elementwise fusion (the interpreted ``exp``/``dot`` kernels):
    ``fma(a2, b2, fma(a0, b0, a1·b1))`` (``csrc/common.cuh: dot3c``)."""
    return fma(a2, b2, fma(a0, b0, a1 * b1))


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


def _form_queries(params, srcT, variant: str):
    """The query side of a form for node poses, ``[B, Np]`` each: q
    (diff, :func:`_transform`), or −2q and |q|² (exp, dot) with q and |q|²
    contracted as XLA's CPU build contracts the interpreted kernel
    (``csrc/nn_min_d2.cu``: ``NodeQueries``, ``min_d2_body``)."""
    if variant == "diff":
        return (*_transform(params, srcT), None)
    px, py, pz = srcT[0][None], srcT[1][None], srcT[2][None]
    q = [_dot3c(px, py, pz, *(params[:, 3 * r + k:3 * r + k + 1] for k in range(3)))
         + params[:, 9 + r:10 + r] for r in range(3)]
    return (-2.0 * q[0], -2.0 * q[1], -2.0 * q[2], _dot3c(*q, *q))


def _form_pairs(q, w, variant: str):
    """The form's value for queries ``q`` (``[n, 1]`` each, from
    :func:`_form_queries`) against the target rows ``w [m, 8]``:
    ``[n, m]``, whose minimum over targets is d² (diff, dot) or d² − |q|²
    (exp) (``csrc/nn_min_d2.cu: pair_d2``)."""
    qx, qy, qz, qn = q
    wx, wy, wz, m2 = (w[None, :, k] for k in (0, 1, 2, 4))
    if variant == "diff":
        dx, dy, dz = wx - qx, wy - qy, wz - qz
        return (dx * dx + dy * dy) + dz * dz
    if variant == "exp":
        return fma_bulk(qz, wz, fma_bulk(qy, wy, fma_bulk(qx, wx, m2)))
    return (fma_bulk(qz, wz, fma_bulk(qy, wy, wx * qx)) + qn) + m2


def _min_pairs_plain(q, wm, variant: str = "diff", want_idx: bool = False, tile: int = 512):
    """Min over targets of the form's value for the queries ``q`` (tensors
    of any one shape, from :func:`_form_queries`), chunked over queries
    and targets; with ``want_idx`` also the earliest target index at the
    minimum (``argmin`` takes the first in a tile, a strict ``<`` keeps the
    earlier tile, as the TPU kernel does)."""
    shape = q[0].shape
    q = [None if v is None else v.reshape(-1) for v in q]
    best = torch.full_like(q[0], _INF)
    idx = torch.zeros(best.shape, dtype=torch.int32, device=best.device) if want_idx else None
    qc = max(1, _MAX_ELEMS // tile)
    for q0 in range(0, best.shape[0], qc):
        sl = slice(q0, q0 + qc)
        qs = [None if v is None else v[sl, None] for v in q]
        b = best[sl]
        for m0 in range(0, wm.shape[0], tile):
            v = _form_pairs(qs, wm[m0:m0 + tile], variant)
            if want_idx:
                cur, arg = v.min(dim=1)
                take = cur < b
                b.copy_(torch.where(take, cur, b))
                idx[sl] = torch.where(take, arg.int() + m0, idx[sl])
            else:
                b.copy_(torch.minimum(b, v.amin(dim=1)))
    return best.reshape(shape), None if idx is None else idx.reshape(shape)


def _min_d2_plain(qx, qy, qz, wm, tile: int = 512):
    """Min over targets of |m − q|² (diff form) for query coordinate
    tensors of any shape; chunked over queries."""
    return _min_pairs_plain((qx, qy, qz, None), wm, tile=tile)[0]


def _check_form(variant: str, forms=FORMS):
    if variant not in forms:
        raise ValueError(f"unknown variant {variant!r}")


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


def min_d2_groups_plain(srcT, wm, gparams, tile: int = 512, *, variant: str = "diff"):
    """Plain version of K3 (``mxu.py:196``): ``d2 [8G, Np]``.  The "exp"
    form takes the base plane |m|² − 2u·m (three FMAs) and adds |u|² with
    a_j after the min, its products contracted as XLA's CPU build contracts
    the interpreted kernel."""
    _check_form(variant, ("diff", "exp"))
    P = gparams
    G, Np = P.shape[0], srcT.shape[1]
    px, py, pz = srcT[0], srcT[1], srcT[2]
    t = P[:, 9:33].reshape(G, 8, 3)
    tn = P[:, 33:41]
    wx, wy, wz = wm[:, 0], wm[:, 1], wm[:, 2]
    exp = variant == "exp"
    if exp:
        u = [_dot3c(px[None], py[None], pz[None], *(P[:, 3 * r + k:3 * r + k + 1]
                                                    for k in range(3))) for r in range(3)]
        s = _dot3c(t[..., 0:1], t[..., 1:2], t[..., 2:3], wx, wy, wz)
    else:
        u = [_rows(P, 3 * r, px, py, pz) for r in range(3)]
        s = (t[..., 0:1] * wx + t[..., 1:2] * wy) + t[..., 2:3] * wz
    ux, uy, uz = u                                        # [G, Np]
    b = tn[..., None] - 2.0 * s                           # [G, 8, Mp]
    best = torch.full((G, 8, Np), _INF, dtype=torch.float32, device=srcT.device)
    gc = max(1, _MAX_ELEMS // (Np * tile))
    for g0 in range(0, G, gc):
        gs = slice(g0, g0 + gc)
        for m0 in range(0, wm.shape[0], tile):
            ms = slice(m0, m0 + tile)
            if exp:
                Gp = fma_bulk(-2.0 * uz[gs, :, None], wz[ms], fma_bulk(
                    -2.0 * uy[gs, :, None], wy[ms], fma_bulk(-2.0 * ux[gs, :, None], wx[ms],
                                                             wm[ms, 4])))
            else:
                dx = wx[None, None, ms] - ux[gs, :, None]
                dy = wy[None, None, ms] - uy[gs, :, None]
                dz = wz[None, None, ms] - uz[gs, :, None]
                Gp = (dx * dx + dy * dy) + dz * dz        # [gc, Np, tile]
            for j in range(8):
                cur = (Gp + b[gs, j, None, ms]).amin(dim=2)
                best[gs, j] = torch.minimum(best[gs, j], cur)
    if exp:
        a = 2.0 * _dot3c(t[..., 0:1], t[..., 1:2], t[..., 2:3], ux[:, None], uy[:, None],
                         uz[:, None]) + _dot3c(*u, *u)[:, None]
    else:
        a = 2.0 * ((t[..., 0:1] * ux[:, None] + t[..., 1:2] * uy[:, None])
                   + t[..., 2:3] * uz[:, None])           # [G, 8, Np]
    return torch.clamp(best + a, min=0.0).reshape(8 * G, Np)


def min_d2_groups(srcT, wm, gparams, variant: str = "diff"):
    """Exact min squared distances for 8-sibling translation groups:
    ``d2 [8·G, Np]``, row ``8g+j`` = node (R_g, t_{g,j}) (``mxu.py:303``).
    ``variant`` is the TPU kernel's distance form, "diff" (every solver
    path) or "exp"; the port is f32 throughout (TF32 stays off), so there
    is no precision argument."""
    _check_form(variant, ("diff", "exp"))
    if not _route("min_d2_groups", srcT, wm, gparams):
        return min_d2_groups_plain(srcT, wm, gparams, variant=variant)
    G, Np, Mp = gparams.shape[0], srcT.shape[1], wm.shape[0]
    _expect("min_d2_groups", srcT, (8, Np))
    _expect("min_d2_groups", wm, (Mp, 8))
    _expect("min_d2_groups", gparams, (G, 48))
    d2 = torch.empty((8 * G, Np), dtype=torch.float32, device=srcT.device)
    if G == 0:
        return d2
    _launch(_form_counter("min_d2_groups", variant), kernels.lib().goicp_min_d2_grouped,
            gparams.data_ptr(), G, srcT.data_ptr(), Np, wm.data_ptr(), Mp, FORMS[variant],
            d2.data_ptr(), _stream(srcT))
    return d2


def _form_counter(name: str, variant: str) -> str:
    """The launch counter of a wrapper's form: its own name for "diff"."""
    return name if variant == "diff" else f"{name}_{variant}"


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


def _k2_terms(srcT_ext, wm, params):
    """K2's per-point ub and lb terms, ``[B, Np]`` each: ``d_hi²·valid``
    and ``c²·valid``."""
    d_hi, c = _point_terms(
        _min_d2_plain(*_transform(params, srcT_ext), wm), params[:, 14:15],
        params[:, 12:13], srcT_ext[3][None], params[:, 13:14],
    )
    pv = srcT_ext[4][None]
    return (d_hi * d_hi) * pv, (c * c) * pv


def bounds_block_sums_plain(srcT_ext, wm, params):
    """Per point-block sums of the ub and lb terms, ``[B, nb]`` each, with
    blocks of ``tq = _pick_tile(Np, 384)`` points (no screening)."""
    tq = _pick_tile(srcT_ext.shape[1], TQB)
    u, l = _k2_terms(srcT_ext, wm, params)
    return _block_sums(u, tq), _block_sums(l, tq)


def bounds_nodes_plain(srcT_ext, wm, params):
    """Plain version of K2 (``mxu.py:403``): ``(ub, lb) [B]``."""
    ub_blk, lb_blk = bounds_block_sums_plain(srcT_ext, wm, params)
    ub, lb, _ = screen_scan(ub_blk, lb_blk, params[:, 15])
    return ub, lb


def _warp_order_sums(x, tq: int):
    """Block sums of ``x [B, Np]`` over blocks of ``tq`` points in K2's
    order: within a block, for each r < tq/32 the 32 points ``32·r + L`` are
    added by an xor butterfly (offsets 16, 8, 4, 2, 1; each step adds a
    lane's partner to it), then the tq/32 partials in r order."""
    B, Np = x.shape
    x = x.reshape(B, Np // tq, tq // 32, 32)
    lane = torch.arange(32, device=x.device)
    for off in (16, 8, 4, 2, 1):
        x = x + x[..., lane ^ off]
    x = x[..., 0]
    acc = x[..., 0]
    for r in range(1, x.shape[-1]):
        acc = acc + x[..., r]
    return acc


def bounds_nodes_kernel_order(srcT_ext, wm, params):
    """K2's arithmetic in plain PyTorch, with the kernel's summation order
    (:func:`_warp_order_sums`, then the carried sums block by block):
    ``(ub, lb) [B]`` bit-equal to the kernel's on any launch plan.  Only
    the order of the adds differs from :func:`bounds_nodes_plain`, which the
    CPU path runs (its parity with the JAX package rests on it)."""
    tq = _pick_tile(srcT_ext.shape[1], TQB)
    u, l = _k2_terms(srcT_ext, wm, params)
    ub, lb, _ = screen_scan(_warp_order_sums(u, tq), _warp_order_sums(l, tq), params[:, 15])
    return ub, lb


def bounds_nodes(srcT_ext, wm, params):
    """Fused screened bounds for singleton nodes: ``(ub, lb) [B]``
    (``mxu.py:1012``)."""
    if not _route("bounds_nodes", srcT_ext, wm, params):
        return bounds_nodes_plain(srcT_ext, wm, params)
    return _k2_kernel(srcT_ext, wm, params)


def _k2_kernel(srcT_ext, wm, params, warps: int = 0, grid: int = 0, route: str = "auto"):
    """K2's launch; ``warps``, ``grid`` and ``route`` force its plan (0: the
    plan's pick; see :func:`k2_plan`)."""
    B, Np, Mp = params.shape[0], srcT_ext.shape[1], wm.shape[0]
    _expect("bounds_nodes", srcT_ext, (8, Np))
    _expect("bounds_nodes", wm, (Mp, 8))
    _expect("bounds_nodes", params, (B, 16))
    ub = torch.empty((B,), dtype=torch.float32, device=params.device)
    lb = torch.empty_like(ub)
    if B == 0:
        return ub, lb
    state = torch.empty((B + 1,), dtype=torch.int32, device=params.device)
    carry = torch.empty((B, 2), dtype=torch.float32, device=params.device)
    _launch("bounds_nodes", kernels.lib().goicp_bounds_nodes,
            params.data_ptr(), B, srcT_ext.data_ptr(), Np, wm.data_ptr(), Mp,
            _pick_tile(Np, TQB), int(warps), int(grid), K2_ROUTES[route], state.data_ptr(),
            carry.data_ptr(), ub.data_ptr(), lb.data_ptr(), _stream(params))
    return ub, lb


K2_ROUTES = {"auto": 0, "resident": 1, "ring": 2}


def k2_plan(B: int, Np: int, Mp: int, warps: int = 0, grid: int = 0,
            route: str = "auto") -> dict:
    """K2's launch plan on the current card, without a launch.  Items are
    (node, point block) pairs, one warp each, taken in block-major order
    by ``grid`` persistent CTAs of ``warps`` warps; the targets stay
    resident in shared memory up to 6,144 (``route="resident"``) or stream
    through each warp's ring (``"ring"``).  ``k`` is the blocks of one node
    in flight while all ``B`` nodes are live (1: the serial scan's order);
    ``points_per_lane`` is tq / 32."""
    tq = _pick_tile(Np, TQB)
    out = (ctypes.c_int * 4)()
    kernels.check(kernels.lib().goicp_bounds_nodes_plan(
        B, Np, Mp, tq, int(warps), int(grid), K2_ROUTES[route], ctypes.addressof(out)),
        "k2_plan")
    nb = Np // tq
    inflight = out[1] * out[2]
    return dict(targets_resident=bool(out[0]), warps=out[1], grid=out[2], smem=out[3],
                points_per_lane=tq // 32, blocks=nb,
                k=min(nb, -(-inflight // B)))


# ---------------------------------------------------------------------------
# K4: per-node min distances (csrc/nn_min_d2.cu, min_d2_nodes_kernel)
# ---------------------------------------------------------------------------


def min_d2_nodes_plain(srcT, wm, params, variant: str = "diff"):
    """Plain version of K4 (``mxu.py:361``): ``d2 [B, Np]``."""
    return min_d2_padded_plain(params, srcT, wm, want_idx=False, variant=variant)[0]


def min_d2_padded_plain(params, srcT, wm, *, want_idx: bool, variant: str = "dot"):
    """Plain version of ``mxu.py:152 _min_d2_padded``: ``(d2 [B, Np], idx
    [B, Np] int32 or None)``.  ``idx`` is the earliest target index at the
    minimum of the form's values, unclamped (0 where nothing beats +inf).
    "exp" adds |q|² after the min; every form clamps d² at 0."""
    _check_form(variant)
    q = _form_queries(params, srcT, variant)
    best, idx = _min_pairs_plain(q, wm, variant, want_idx)
    if variant == "exp":
        best = best + q[3]
    return torch.clamp(best, min=0.0), idx


def min_d2_nodes(srcT, wm, params, variant: str = "diff"):
    """Per-node exact min squared distances ``d2 [B, Np]`` for the queries
    ``R_b·p + t_b`` (``mxu.py:361``): K1's source without the index.
    ``variant`` is the TPU kernel's distance form ("diff", every solver
    path; "exp"; "dot"); the port is f32 throughout (TF32 stays off), so
    there is no precision argument."""
    return min_d2_padded(params, srcT, wm, want_idx=False, variant=variant)[0]


def min_d2_padded(params, srcT, wm, *, want_idx: bool, variant: str = "dot"):
    """``mxu.py:152 _min_d2_padded``: ``params [B,16]``, ``srcT [8, Np]``,
    ``wm [Mp, 8]`` → ``(d2 [B, Np], idx [B, Np] int32 or None)``.  Without
    the index it is K4 (:func:`min_d2_nodes`); with it, K1's index search
    over node poses (``nn_route`` picks its launch shape).  The default
    form is the JAX function's, "dot"; no precision argument (f32
    throughout, TF32 off)."""
    _check_form(variant)
    name = _form_counter("min_d2_padded" if want_idx else "min_d2_nodes", variant)
    if not _route(name, srcT, wm, params):
        return min_d2_padded_plain(params, srcT, wm, want_idx=want_idx, variant=variant)
    B, Np, Mp = params.shape[0], srcT.shape[1], wm.shape[0]
    _expect(name, srcT, (8, Np))
    _expect(name, wm, (Mp, 8))
    _expect(name, params, (B, 16))
    d2 = torch.empty((B, Np), dtype=torch.float32, device=srcT.device)
    idx = torch.empty((B, Np), dtype=torch.int32, device=srcT.device) if want_idx else None
    if B == 0:
        return d2, idx
    splits, qr = nn_route(B * Np, Mp, _sm_count(srcT.device.index)) if want_idx else (1, 4)
    _launch(name, kernels.lib().goicp_nn_min_d2,
            params.data_ptr(), B, srcT.data_ptr(), Np, wm.data_ptr(), Mp, FORMS[variant],
            splits, qr, d2.data_ptr(), None if idx is None else idx.data_ptr(), _stream(srcT))
    return d2, idx


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
    (``mxu.py:777``).  The kernel keeps each warp's ``[2, Np]`` scratch in
    a global buffer sized from its plan (:func:`k5_plan`)."""
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
    plan = _k5_plan_cached(params.device.index, B, Np, Mp, int(warps))
    gscr = torch.empty((plan["grid"] * plan["warps"], 2, Np), dtype=torch.float32,
                       device=params.device)
    counter = torch.empty((1,), dtype=torch.int32, device=params.device)
    _launch("bounds_nodes_trimmed", kernels.lib().goicp_bounds_nodes_trimmed,
            params.data_ptr(), B, srcT_ext.data_ptr(), Np, wm.data_ptr(), Mp,
            _pick_tile(Np, TQB), int(warps), int(h), int(drop), gscr.data_ptr(),
            counter.data_ptr(), ub.data_ptr(), lb.data_ptr(), _stream(params))
    return ub, lb


def k5_plan(B: int, Np: int, Mp: int, warps: int = 0) -> dict:
    """K5's launch plan on the current card, without a launch: targets
    resident in shared memory or read from global memory, warps per CTA,
    persistent grid (with the warps, the rows of the global scratch) and
    dynamic shared bytes."""
    out = (ctypes.c_int * 4)()
    kernels.check(kernels.lib().goicp_bounds_nodes_trimmed_plan(
        B, Np, Mp, _pick_tile(Np, TQB), int(warps), ctypes.addressof(out)), "k5_plan")
    return dict(targets_resident=bool(out[0]), warps=out[1], grid=out[2], smem=out[3])


@functools.lru_cache(maxsize=256)
def _k5_plan_cached(index, B: int, Np: int, Mp: int, warps: int) -> dict:
    with torch.cuda.device(index):
        return k5_plan(B, Np, Mp, warps)


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
