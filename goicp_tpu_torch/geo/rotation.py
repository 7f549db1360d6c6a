"""Rotation maps and uncertainty radii, batched (port of the JAX package's
``geo/rotation.py``: the axis-angle pieces the SE(3) engine runs).

Axis-angle vectors ``v`` in the π-ball map to rotations by Rodrigues'
formula (``jly_goicp.cpp:449-467``).  For a cube of half side ``span`` any
rotation in it moves a point ``p`` at most ``2·sin(min(θ, π)/2)·|p|`` from
``R(v0)·p``, with ``θ`` the cube's angle bound.  Everything is batched:
centers ``[B,3]``, spans ``[B]``, outputs ``[B, ...]``.
"""

from __future__ import annotations

import functools
import math

import numpy as np
import torch

from goicp_tpu_torch.nn.fused import (
    _dot3c, _sq3, _sq3_fma, acos_libm, fma, sincos_libm, sqrt_rn,
)

_SQRT3 = 1.7320508075688772


def quat_to_matrix(q):
    """Unit quaternion(s) ``[..., 4]`` (w,x,y,z) → rotation matrix ``[...,3,3]``."""
    w, x, y, z = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
    ww, xx, yy, zz = w * w, x * x, y * y, z * z
    wx, wy, wz = w * x, w * y, w * z
    xy, xz, yz = x * y, x * z, y * z
    return torch.stack(
        [
            torch.stack([ww + xx - yy - zz, 2 * (xy - wz), 2 * (xz + wy)], -1),
            torch.stack([2 * (xy + wz), ww - xx + yy - zz, 2 * (yz - wx)], -1),
            torch.stack([2 * (xz - wy), 2 * (yz + wx), ww - xx - yy + zz], -1),
        ],
        dim=-2,
    )


def _quat_to_matrix_fma(q, ww):
    """:func:`quat_to_matrix` of ``q = (w, x, y, z)`` with ``w = sqrt(ww)``,
    as XLA's CPU build rounds it inside a jitted function: it squares the
    root away (``w·w = ww``) and contracts each product into the sum or
    difference that follows (the diagonal ``fma(±z, z, fma(±y, y, fma(±x,
    x, ww)))``, an off-diagonal entry ``2·fma(a, b, ±c·d)``)."""
    w, x, y, z = q[..., 0], q[..., 1], q[..., 2], q[..., 3]

    def diag(sx, sy, sz):
        return fma(sz * z, z, fma(sy * y, y, fma(sx * x, x, ww)))

    def off(a, b, c, d, sign):
        return 2.0 * fma(a, b, sign * (c * d))

    return torch.stack(
        [
            torch.stack([diag(1, -1, -1), off(x, y, w, z, -1), off(x, z, w, y, 1)], -1),
            torch.stack([off(x, y, w, z, 1), diag(-1, 1, -1), off(y, z, w, x, -1)], -1),
            torch.stack([off(x, z, w, y, -1), off(y, z, w, x, 1), diag(-1, -1, 1)], -1),
        ],
        dim=-2,
    )


def quat_cube_rotation(center):
    """Quaternion-ball point(s) ``[...,3]`` → rotation matrix ``[...,3,3]``
    with ``w = sqrt(max(0, 1 − |v|²))`` (``geo/rotation.py:49``); a point
    outside the ball gives the matrix at the radially clamped point, so
    callers gate on :func:`quat_cube_in_SO3`.  Rounded as the jitted JAX
    function (``fused.fma``, ``fused.sqrt_rn``), but for the radial clamp
    of a point outside the ball, where XLA's CPU build takes its own
    reciprocal root."""
    r2 = _sq3_fma(center)[..., None]
    scale = torch.where(r2 > 1.0, 1.0 / sqrt_rn(torch.clamp(r2, min=1e-30)), 1.0)
    v = center * scale
    ww = torch.clamp(1.0 - _sq3_fma(v), min=0.0)
    return _quat_to_matrix_fma(torch.cat([sqrt_rn(ww)[..., None], v], dim=-1), ww)


def quat_cube_in_SO3(center):
    """``|v| ≤ 1`` (``geo/rotation.py:65``)."""
    return _sq3_fma(center) <= 1.0


def quat_cube_overlaps_SO3(center, span):
    """Does the cube meet the unit ball: ``Σ max(|v_i| − span, 0)² ≤ 1``
    (``geo/rotation.py:70``)."""
    d = torch.clamp(torch.abs(center) - span[..., None], min=0.0)
    return _sq3_fma(d) <= 1.0


def quat_cube_max_angle(center, span):
    """Max rotation angle between R(center) and R(v) over the cube, ``[B]``
    (``geo/rotation.py:82``): the 4-D chordal bound ``d² ≤ 3·span² + dw²``
    over the extreme radii, ``θ = 2·arccos(clip(1 − d²/2, 0, 1))``, never
    wrapped round the double cover.  Rounded as the jitted JAX function:
    roots by ``fused.sqrt_rn``, the arc cosine by ``fused.acos_libm``, and
    each of the three sums of squares in the order XLA's fusion of it takes
    (tests/test_torch_geo.py: bit-equal on all but 1 of 100,000 cubes)."""
    s = span[..., None]
    a = torch.abs(center)
    lo, hi = torch.clamp(a - s, min=0.0), a + s
    r_min = sqrt_rn(_dot3c(lo[..., 0], lo[..., 1], lo[..., 2], lo[..., 0], lo[..., 1], lo[..., 2]))
    r_max = sqrt_rn(_sq3_fma(hi))

    def w_of(r):
        r = torch.clamp(r, max=1.0)
        return sqrt_rn(torch.clamp(fma(-r, r, torch.ones_like(r)), min=0.0))

    w0 = w_of(sqrt_rn(_sq3(center)))
    dw = torch.maximum(w_of(r_min) - w0, w0 - w_of(r_max))
    d2 = fma(torch.full_like(span, 3.0), span * span, dw * dw)
    return 2.0 * acos_libm(torch.clamp(1.0 - d2 / 2.0, 0.0, 1.0))


def axis_angle_rotation(center):
    """Axis-angle vector(s) ``[...,3]`` → rotation matrix (Rodrigues), by the
    singularity-free quaternion route with a series-safe ``sin(t/2)/t``."""
    t2 = torch.sum(center * center, dim=-1, keepdim=True)
    t = torch.sqrt(torch.clamp(t2, min=1e-30))
    half = 0.5 * t
    sinc_half = torch.where(t < 1e-4, 0.5 - t2 / 48.0, torch.sin(half) / t)
    q = torch.cat([torch.cos(half), center * sinc_half], dim=-1)
    return quat_to_matrix(q)


def axis_angle_in_ball(center, span):
    """Cube-center test against the π-ball: keep the cube if ``|v0| −
    √3·span ≤ π`` (``geo/rotation.py:128``)."""
    return sqrt_rn(_sq3_fma(center)) - _SQRT3 * span <= math.pi


def axis_angle_max_angle(span):
    """``min(√3·span, π)`` (``geo/rotation.py:135``)."""
    return torch.clamp(_SQRT3 * span, max=math.pi)


def _xla_linspace(start: float, k: int, dev):
    """``jnp.linspace(start, 1, k)`` for start -1 or 0 as XLA's CPU build
    computes it: ``start·(1 − i·c) + i·c`` with ``c`` the f32 value of
    ``1/(k−1)``, each step rounded, and the last entry exactly 1."""
    ic = torch.arange(k - 1, dtype=torch.float32, device=dev) * float(np.float32(1.0 / (k - 1)))
    head = -(1.0 - ic) + ic if start == -1.0 else ic
    return torch.cat([head, torch.ones(1, dtype=torch.float32, device=dev)])


def axis_angle_cube_max_angle(centers, spans, *, k_outer: int = 40,
                              k_side: int = 12):
    """Center-aware upper bound on the angle between ``exp(c)`` and ``exp(v)``
    over the axis-angle cube ``c ± s`` — strictly tighter than jly's chordal
    ``√3·σ`` away from the origin.  The derivation is in the JAX package's
    ``geo/rotation.py:axis_angle_cube_max_angle``; this is the same sampling
    of the cube's (radial, tangential) image boundary plus its Lipschitz
    slack, falling back to ``min(√3·s, π)`` where the chart may fold.
    Inputs ``centers [M,3]``, ``spans [M]`` → ``[M]``.

    Every step rounds as the jitted JAX function does on the CPU, so the
    result is bit-equal to it (``tests/test_torch_rotation.py``): the
    products XLA's fusions contract into a sum are one fused multiply-add
    (``fused.fma``), roots are correctly rounded (``fused.sqrt_rn``), the
    sine, cosine and arc cosine are the C library's (``fused.sincos_libm``,
    ``fused.acos_libm``), ``linspace`` is XLA's, and ``p_end/(k_side−1)``
    is a product with the f32 reciprocal, as XLA rewrites it.

    That is ~550 small tensor operations.  On a CUDA device they are
    captured once per cube count into a CUDA graph and replayed: the same
    kernels, so the same bits, for one launch from the host.
    """
    c = centers.to(torch.float32).contiguous()
    s = spans.to(torch.float32).contiguous()
    if not c.is_cuda:
        return _cube_max_angle(c, s, k_outer, k_side)
    graph, c_in, s_in, out = _cube_max_angle_graph(c.device.index, c.shape[0], k_outer, k_side)
    c_in.copy_(c)
    s_in.copy_(s)
    graph.replay()
    return out.clone()


@functools.lru_cache(maxsize=64)
def _cube_max_angle_graph(index, M: int, k_outer: int, k_side: int):
    """A CUDA graph of :func:`_cube_max_angle` over M cubes on device
    ``index``: ``(graph, centers in, spans in, out)``."""
    with torch.cuda.device(index):
        c = torch.zeros((M, 3), dtype=torch.float32, device="cuda")
        s = torch.zeros((M,), dtype=torch.float32, device="cuda")
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            _cube_max_angle(c, s, k_outer, k_side)     # allocator warm-up
        torch.cuda.current_stream().wait_stream(side)
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph, capture_error_mode="thread_local"):
            out = _cube_max_angle(c, s, k_outer, k_side)
        return graph, c, s, out


def _cube_max_angle(c, s, k_outer: int, k_side: int):
    """:func:`axis_angle_cube_max_angle` of f32 ``c [M,3]``, ``s [M]``."""
    dev = c.device
    yang = torch.clamp(_SQRT3 * s, max=math.pi)

    a = sqrt_rn(_sq3_fma(c))
    safe_a = torch.clamp(a, min=1e-12)
    ac = torch.abs(c)
    c1, c2, c3 = ac[..., 0], ac[..., 1], ac[..., 2]
    h1s = s * ((c1 + c2) + c3) / safe_a
    m = torch.minimum(
        torch.minimum(torch.abs(c1 + c2 + c3), torch.abs(c1 + c2 - c3)),
        torch.minimum(torch.abs(c1 - c2 + c3), torch.abs(c1 - c2 - c3)),
    ) / safe_a
    p_box = s * sqrt_rn(torch.clamp(fma(-m, m, torch.full_like(m, 3.0)), min=0.0))

    M = h1s.shape[0]
    frac = _xla_linspace(-1.0, k_outer, dev)
    uo_o = h1s[:, None] * frac[None, :]
    po_o = torch.minimum(
        sqrt_rn(torch.clamp(fma(-uo_o, uo_o, ((s * s) * 3.0)[:, None].expand_as(uo_o)),
                            min=0.0)),
        p_box[:, None],
    )
    fs = _xla_linspace(0.0, k_side, dev)
    p_end = torch.minimum(
        sqrt_rn(torch.clamp(fma(s * 3.0, s, -(h1s * h1s)), min=0.0)), p_box
    )
    uo_s = torch.cat(
        [(-h1s)[:, None].expand(M, k_side), h1s[:, None].expand(M, k_side)], dim=1
    )
    po_s = torch.cat([p_end[:, None] * fs[None, :]] * 2, dim=1)
    uo = torch.cat([uo_o, uo_s], dim=1)
    po = torch.cat([po_o, po_s], dim=1)

    u = a[:, None] + uo
    b = sqrt_rn(torch.clamp(fma(po, po, u * u), min=1e-30))
    t = u / b
    sin_a, cos_a = sincos_libm((a * 0.5)[:, None].expand_as(b))
    sin_b, cos_b = sincos_libm(b * 0.5)
    f = fma(cos_a, cos_b, (sin_a * sin_b) * t)
    theta = 2.0 * acos_libm(torch.clamp(torch.abs(f), 0.0, 1.0))

    # uo_o's steps as XLA fuses them: the later product minus the earlier
    du = fma(h1s[:, None].expand(M, k_outer - 1), frac[None, 1:].expand(M, k_outer - 1),
             -uo_o[:, :-1])
    dp = torch.diff(po_o, dim=1)
    d_out = sqrt_rn(fma(du, du, dp * dp))
    gap = torch.maximum(torch.max(d_out, dim=1).values,
                        p_end * float(np.float32(1.0 / (k_side - 1))))
    tight = torch.max(theta, dim=1).values + 0.5 * gap

    ok = (a - h1s > 1e-6) & (a + _SQRT3 * s < 2.0 * math.pi - 1e-3)
    return torch.where(ok, torch.minimum(tight, yang), yang)


def deflation_factor(max_angle):
    """``2·sin(min(θ,π)/2)`` per node, with glibc's ``sinf``
    (``fused.sincos_libm``), as the jitted JAX function rounds it: the
    factor of every point's rotation radius."""
    return 2.0 * sincos_libm(torch.clamp(max_angle, max=math.pi) / 2.0)[0]


def rotation_displacement(max_angle, norms):
    """Per-point rotation uncertainty radius ``[B,N]``:
    ``2·sin(min(θ,π)/2)·|p|`` (``jly_goicp.cpp:159``), bit-equal to the
    jitted JAX function (:func:`deflation_factor`)."""
    return deflation_factor(max_angle)[..., None] * norms[None, :]


def random_rotations(n: int, rng) -> np.ndarray:
    """``[n,3,3]`` random rotations (sign-fixed QR with a det(+1) flip) from a
    numpy Generator — host numpy, as in the JAX package."""
    A = rng.normal(size=(n, 3, 3))
    Q, R = np.linalg.qr(A)
    Q = Q * np.sign(np.einsum("bii->bi", R))[:, None, :]
    det = np.linalg.det(Q)
    Q[det < 0, :, 0] *= -1.0
    return Q.astype(np.float32)
