"""The center-aware rotation bound and the f32 sine, cosine and arc cosine
under it, against the jitted JAX functions on the CPU: bit-equal.

XLA's CPU backend calls the C library's ``sinf``, ``cosf`` and ``atan2f``
(``jnp.arccos(x)`` is ``atan2f(sqrt((1 − x)(1 + x)), x)``); ATen's
``sin``, ``cos`` and ``acos`` round otherwise in some last bits, and so did
the port's rotation bound until it repeated XLA's roundings
(``goicp_tpu_torch/geo/rotation.py``).
"""

import numpy as np
import pytest

pytest.importorskip("jax")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from goicp_tpu.geo.rotation import axis_angle_cube_max_angle as jax_cube_angle  # noqa: E402
from goicp_tpu_torch.geo.rotation import axis_angle_cube_max_angle  # noqa: E402
from goicp_tpu_torch.nn import fused  # noqa: E402

torch.set_num_threads(1)


def _bits_differ(a, b):
    return int((np.asarray(a).view(np.int32) != np.asarray(b).view(np.int32)).sum())


def test_sin_cos_acos_round_as_jitted_jax():
    rng = np.random.default_rng(21)
    y = np.concatenate([rng.uniform(-4.0, 4.0, 150_000), rng.uniform(-1e-3, 1e-3, 2_000),
                        [0.0, -0.0, 0.75, -0.75, 0.7499999, np.pi / 2, np.pi]]).astype(np.float32)
    sin, cos = fused.sincos_libm(torch.from_numpy(y))
    assert _bits_differ(sin.numpy(), jax.jit(jnp.sin)(y)) == 0
    assert _bits_differ(cos.numpy(), jax.jit(jnp.cos)(y)) == 0
    x = np.concatenate([rng.uniform(-1.0, 1.0, 150_000), 1.0 - rng.uniform(0, 1e-4, 20_000),
                        rng.uniform(-1e-7, 1e-7, 1_000), [-1.0, 1.0, 0.0, -0.0, 0.5]]
                       ).astype(np.float32)
    assert _bits_differ(fused.acos_libm(torch.from_numpy(x)).numpy(), jax.jit(jnp.arccos)(x)) == 0
    # ATen's own functions differ in last bits: the reason for the above
    assert _bits_differ(torch.sin(torch.from_numpy(y)).numpy(), jax.jit(jnp.sin)(y)) > 0


def test_cube_angle_bound_bit_equal_to_jitted_jax():
    """100,000 random cubes in the π-ball, spans π/2 … π/2¹⁰ (the BnB's
    levels): every bound bit-equal, the fallback (√3·s) and the tight branch
    both taken."""
    rng = np.random.default_rng(22)
    c = rng.uniform(-np.pi, np.pi, (200_000, 3)).astype(np.float32)
    c = c[np.linalg.norm(c, axis=1) <= np.pi][:100_000]
    s = (np.pi / 2.0 ** rng.integers(1, 11, c.shape[0])).astype(np.float32)
    assert c.shape[0] == 100_000
    ref = np.asarray(jax.jit(jax_cube_angle)(c, s))
    got = axis_angle_cube_max_angle(torch.from_numpy(c), torch.from_numpy(s)).numpy()
    assert _bits_differ(got, ref) == 0
    yang = np.minimum(np.float32(1.7320508075688772) * s, np.float32(np.pi))
    assert 0 < int((got < yang).sum()) < got.size


def test_rotation_displacement_bit_equal_to_jitted_jax():
    """The deflation's per-point rotation radius ``2·sin(min(θ,π)/2)·‖p‖``
    over 120,000 angles in [0, π] (and beyond π, clamped) with random
    norms: bit-equal to the jitted JAX function, as is the screened
    evaluators' factor ``af``.  ATen's sine differs on some of them."""
    from goicp_tpu.geo.rotation import rotation_displacement as jax_disp
    from goicp_tpu_torch.geo.rotation import deflation_factor, rotation_displacement

    rng = np.random.default_rng(23)
    ang = np.concatenate([rng.uniform(0.0, np.pi, 120_000),
                          [0.0, np.pi, 4.0, 1e-6, np.pi / 2]]).astype(np.float32)
    norms = rng.uniform(0.0, 2.0, 7).astype(np.float32)
    ref = np.asarray(jax.jit(jax_disp)(ang, norms))
    got = rotation_displacement(torch.from_numpy(ang), torch.from_numpy(norms)).numpy()
    assert got.shape == (ang.size, norms.size)
    assert _bits_differ(got, ref) == 0
    af_ref = np.asarray(jax.jit(lambda a: 2.0 * jnp.sin(jnp.minimum(a, jnp.pi) / 2.0))(ang))
    assert _bits_differ(deflation_factor(torch.from_numpy(ang)).numpy(), af_ref) == 0
    aten = (2.0 * torch.sin(torch.clamp(torch.from_numpy(ang), max=np.pi) / 2.0)).numpy()
    assert _bits_differ(aten, af_ref) > 0

