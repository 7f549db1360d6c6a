"""Rotation maps and uncertainty radii, batched (port of the JAX package's
``geo/rotation.py``: the axis-angle pieces the SE(3) engine runs).

Axis-angle vectors ``v`` in the π-ball map to rotations by Rodrigues'
formula (``jly_goicp.cpp:449-467``).  For a cube of half side ``span`` any
rotation in it moves a point ``p`` at most ``2·sin(min(θ, π)/2)·|p|`` from
``R(v0)·p``, with ``θ`` the cube's angle bound.  Everything is batched:
centers ``[B,3]``, spans ``[B]``, outputs ``[B, ...]``.
"""

from __future__ import annotations

import math

import numpy as np
import torch

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


def axis_angle_rotation(center):
    """Axis-angle vector(s) ``[...,3]`` → rotation matrix (Rodrigues), by the
    singularity-free quaternion route with a series-safe ``sin(t/2)/t``."""
    t2 = torch.sum(center * center, dim=-1, keepdim=True)
    t = torch.sqrt(torch.clamp(t2, min=1e-30))
    half = 0.5 * t
    sinc_half = torch.where(t < 1e-4, 0.5 - t2 / 48.0, torch.sin(half) / t)
    q = torch.cat([torch.cos(half), center * sinc_half], dim=-1)
    return quat_to_matrix(q)


def axis_angle_cube_max_angle(centers, spans, *, k_outer: int = 40,
                              k_side: int = 12):
    """Center-aware upper bound on the angle between ``exp(c)`` and ``exp(v)``
    over the axis-angle cube ``c ± s`` — strictly tighter than jly's chordal
    ``√3·σ`` away from the origin.  The derivation is in the JAX package's
    ``geo/rotation.py:axis_angle_cube_max_angle``; this is the same sampling
    of the cube's (radial, tangential) image boundary plus its Lipschitz
    slack, falling back to ``min(√3·s, π)`` where the chart may fold.
    Inputs ``centers [M,3]``, ``spans [M]`` → ``[M]``.
    """
    c = centers.to(torch.float32)
    s = spans.to(torch.float32)
    dev = c.device
    yang = torch.clamp(_SQRT3 * s, max=math.pi)

    a = torch.sqrt(torch.sum(c * c, dim=-1))
    safe_a = torch.clamp(a, min=1e-12)
    l1 = torch.sum(torch.abs(c), dim=-1)
    h1s = s * l1 / safe_a
    c1, c2, c3 = torch.abs(c[..., 0]), torch.abs(c[..., 1]), torch.abs(c[..., 2])
    m = torch.minimum(
        torch.minimum(torch.abs(c1 + c2 + c3), torch.abs(c1 + c2 - c3)),
        torch.minimum(torch.abs(c1 - c2 + c3), torch.abs(c1 - c2 - c3)),
    ) / safe_a
    p_box = s * torch.sqrt(torch.clamp(3.0 - m * m, min=0.0))

    frac = torch.linspace(-1.0, 1.0, k_outer, dtype=torch.float32, device=dev)
    uo_o = h1s[:, None] * frac[None, :]
    po_o = torch.minimum(
        torch.sqrt(torch.clamp(3.0 * (s * s)[:, None] - uo_o * uo_o, min=0.0)),
        p_box[:, None],
    )
    fs = torch.linspace(0.0, 1.0, k_side, dtype=torch.float32, device=dev)
    p_end = torch.minimum(
        torch.sqrt(torch.clamp(3.0 * s * s - h1s * h1s, min=0.0)), p_box
    )
    M = h1s.shape[0]
    uo_s = torch.cat(
        [(-h1s)[:, None].expand(M, k_side), h1s[:, None].expand(M, k_side)], dim=1
    )
    po_s = torch.cat([p_end[:, None] * fs[None, :]] * 2, dim=1)
    uo = torch.cat([uo_o, uo_s], dim=1)
    po = torch.cat([po_o, po_s], dim=1)

    u = a[:, None] + uo
    b = torch.sqrt(torch.clamp(u * u + po * po, min=1e-30))
    t = u / b
    ha = (a / 2.0)[:, None]
    f = torch.cos(ha) * torch.cos(b / 2.0) + torch.sin(ha) * torch.sin(b / 2.0) * t
    theta = 2.0 * torch.arccos(torch.clamp(torch.abs(f), 0.0, 1.0))

    d_out = torch.sqrt(
        torch.diff(uo_o, dim=1) ** 2 + torch.diff(po_o, dim=1) ** 2
    )
    gap = torch.maximum(torch.max(d_out, dim=1).values, p_end / (k_side - 1))
    tight = torch.max(theta, dim=1).values + 0.5 * gap

    ok = (a - h1s > 1e-6) & (a + _SQRT3 * s < 2.0 * math.pi - 1e-3)
    return torch.where(ok, torch.minimum(tight, yang), yang)


def rotation_displacement(max_angle, norms):
    """Per-point rotation uncertainty radius ``[B,N]``:
    ``2·sin(min(θ,π)/2)·|p|`` (``jly_goicp.cpp:159``)."""
    half = torch.clamp(max_angle, max=math.pi) / 2.0
    return (2.0 * torch.sin(half))[..., None] * norms[None, :]


def random_rotations(n: int, rng) -> np.ndarray:
    """``[n,3,3]`` random rotations (sign-fixed QR with a det(+1) flip) from a
    numpy Generator — host numpy, as in the JAX package."""
    A = rng.normal(size=(n, 3, 3))
    Q, R = np.linalg.qr(A)
    Q = Q * np.sign(np.einsum("bii->bi", R))[:, None, :]
    det = np.linalg.det(Q)
    Q[det < 0, :, 0] *= -1.0
    return Q.astype(np.float32)
