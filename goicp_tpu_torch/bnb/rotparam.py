"""Rotation-space parametrization adapters (host-side, pure numpy).

Quaternion cube (fgoicp, ``common.h:40-60``) and axis-angle π-cube (jly,
``jly_goicp.cpp:44-48``): these run on the host every BnB round — an eager
device op costs a launch (and a transfer) each.  Copied unchanged from
the JAX package's ``bnb/rotparam.py``.
"""

from __future__ import annotations

import math

import numpy as np

_SQRT3 = math.sqrt(3.0)



def _np_quat_to_matrix(q):
    w, x, y, z = (q[..., i : i + 1] for i in range(4))
    ww, xx, yy, zz = w * w, x * x, y * y, z * z
    wx, wy, wz = w * x, w * y, w * z
    xy, xz, yz = x * y, x * z, y * z
    R = np.concatenate(
        [
            ww + xx - yy - zz, 2 * (xy - wz), 2 * (xz + wy),
            2 * (xy + wz), ww - xx + yy - zz, 2 * (yz - wx),
            2 * (xz - wy), 2 * (yz + wx), ww - xx - yy + zz,
        ],
        axis=-1,
    ).reshape(*q.shape[:-1], 3, 3)
    return R.astype(np.float32)


class QuatParam:
    """FastGoICP's quaternion cube: root span 1.0 (``fgoicp.cpp:35``).

    Pure numpy (like :class:`AxisAngleParam`): these adapters run on the
    host every BnB round, and an eager device op costs a launch each.
    """

    root_span = 1.0

    @staticmethod
    def rotation(centers):
        c = np.asarray(centers, np.float32)
        r2 = np.sum(c * c, axis=-1, keepdims=True)
        scale = np.where(r2 > 1.0, 1.0 / np.sqrt(np.maximum(r2, 1e-30)), 1.0)
        v = c * scale
        w = np.sqrt(np.maximum(0.0, 1.0 - np.sum(v * v, axis=-1, keepdims=True)))
        return _np_quat_to_matrix(np.concatenate([w, v], axis=-1))

    @staticmethod
    def max_angle(centers, spans):
        c = np.asarray(centers, np.float32)
        s = np.asarray(spans, np.float32)[..., None]
        a = np.abs(c)
        r_min = np.sqrt(np.sum(np.maximum(a - s, 0.0) ** 2, axis=-1))
        r_max = np.sqrt(np.sum((a + s) ** 2, axis=-1))
        w_of = lambda r: np.sqrt(np.maximum(0.0, 1.0 - np.minimum(r, 1.0) ** 2))
        r0 = np.sqrt(np.sum(c * c, axis=-1))
        w0 = w_of(r0)
        dw = np.maximum(w_of(r_min) - w0, w0 - w_of(r_max))
        d2 = 3.0 * np.squeeze(s, -1) ** 2 + dw**2
        # no double-cover |.|: d2 is an upper bound, so cos is clamped at 0
        # (theta = pi) instead of wrapping around (see quat_cube_max_angle)
        cos_half = np.clip(1.0 - d2 / 2.0, 0.0, 1.0)
        return (2.0 * np.arccos(cos_half)).astype(np.float32)

    @staticmethod
    def valid(centers, spans):
        c = np.asarray(centers, np.float32)
        s = np.asarray(spans, np.float32)[..., None]
        d = np.maximum(np.abs(c) - s, 0.0)
        return np.sum(d * d, axis=-1) <= 1.0


class AxisAngleParam:
    """jly's axis-angle cube: root span π (``jly_goicp.cpp:44-48``).

    Pure numpy — these run on the host every BnB round, and an eager device op
    costs a launch each.
    """

    root_span = math.pi

    @staticmethod
    def rotation(centers):
        c = np.asarray(centers, np.float32)
        t2 = np.sum(c * c, axis=-1, keepdims=True)
        t = np.sqrt(np.maximum(t2, 1e-30))
        half = 0.5 * t
        sinc_half = np.where(t < 1e-4, 0.5 - t2 / 48.0, np.sin(half) / t)
        w = np.cos(half)  # [..., 1]
        v = c * sinc_half
        x, y, z = v[..., 0:1], v[..., 1:2], v[..., 2:3]
        ww, xx, yy, zz = w * w, x * x, y * y, z * z
        wx, wy, wz = w * x, w * y, w * z
        xy, xz, yz = x * y, x * z, y * z
        R = np.concatenate(
            [
                ww + xx - yy - zz, 2 * (xy - wz), 2 * (xz + wy),
                2 * (xy + wz), ww - xx + yy - zz, 2 * (yz - wx),
                2 * (xz - wy), 2 * (yz + wx), ww - xx - yy + zz,
            ],
            axis=-1,
        ).reshape(*c.shape[:-1], 3, 3)
        return R.astype(np.float32)

    @staticmethod
    def max_angle(centers, spans):
        """jly chordal bound ``min(√3·σ, π)`` (``jly_goicp.cpp:153-157``).
        The SE(3) engine replaces this per-dispatch with the center-aware
        device bound ``geo.rotation.axis_angle_cube_max_angle`` (strictly
        tighter off-origin); this host form serves the nested engine and
        split classification."""
        s = np.asarray(spans, np.float32)
        return np.minimum(_SQRT3 * s, np.pi).astype(np.float32)

    @staticmethod
    def valid(centers, spans):
        c = np.asarray(centers, np.float32)
        s = np.asarray(spans, np.float32)
        r = np.sqrt(np.sum(c * c, axis=-1))
        return r - _SQRT3 * s <= np.pi


_PARAMS = {"quaternion": QuatParam, "axis_angle": AxisAngleParam}
