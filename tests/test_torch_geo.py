"""The port's rotation maps, cube angle bound, rotation displacement,
rigid transforms and Procrustes against the JAX package on the same numpy
inputs.  Tolerance: atol 1e-5 (f32 transcendental and summation-order
differences between XLA and PyTorch)."""

import numpy as np
import pytest

pytest.importorskip("jax")

import torch  # noqa: E402

from goicp_tpu.core.types import RigidTransform as JRT  # noqa: E402
from goicp_tpu.geo.procrustes import horn_quaternion as jhorn  # noqa: E402
from goicp_tpu.geo.procrustes import procrustes as jprocrustes  # noqa: E402
from goicp_tpu.geo import rotation as jrot  # noqa: E402
from goicp_tpu_torch.core.types import RigidTransform  # noqa: E402
from goicp_tpu_torch.geo.procrustes import horn_quaternion, procrustes  # noqa: E402
from goicp_tpu_torch.geo import rotation as trot  # noqa: E402

torch.set_num_threads(1)
ATOL = 1e-5


@pytest.fixture(scope="module")
def rng():
    return np.random.default_rng(77)


def _close(got, ref, atol=ATOL, rtol=0.0):
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=rtol, atol=atol)


def test_axis_angle_rotation_and_quat(rng):
    v = rng.uniform(-np.pi, np.pi, (64, 3)).astype(np.float32)
    v[0] = 0.0
    v[1] = [1e-6, 0.0, 0.0]
    _close(trot.axis_angle_rotation(torch.from_numpy(v)), jrot.axis_angle_rotation(v))
    q = rng.normal(size=(32, 4)).astype(np.float32)
    q /= np.linalg.norm(q, axis=1, keepdims=True)
    _close(trot.quat_to_matrix(torch.from_numpy(q)), jrot.quat_to_matrix(q))


def test_rotation_displacement(rng):
    ang = rng.uniform(0, 4.0, 16).astype(np.float32)
    norms = rng.uniform(0, 1.0, 50).astype(np.float32)
    _close(trot.rotation_displacement(torch.from_numpy(ang), torch.from_numpy(norms)),
           jrot.rotation_displacement(ang, norms))


def test_cube_angle_bound(rng):
    c = rng.uniform(-np.pi, np.pi, (200, 3)).astype(np.float32)
    c[:20] *= 1e-3                                    # near the origin: fallback
    s = (np.pi / 2 ** rng.integers(1, 8, 200)).astype(np.float32)
    got = trot.axis_angle_cube_max_angle(torch.from_numpy(c), torch.from_numpy(s))
    # θ = 2·arccos(f) with f near 1 turns one f32 ulp of f (XLA's and
    # PyTorch's cos/sin differ by an ulp) into ~6e-6 rad at θ ≈ 0.04, so
    # small angles also get a relative tolerance of 1e-3 (ROADMAP queue 3)
    _close(got, jrot.axis_angle_cube_max_angle(c, s), rtol=1e-3)


def test_random_rotations_is_the_jax_sampler():
    a = trot.random_rotations(9, np.random.default_rng(12345))
    b = jrot.random_rotations(9, np.random.default_rng(12345))
    assert np.array_equal(a, b)


def test_rigid_transform_apply_compose(rng):
    R1 = trot.random_rotations(4, rng)
    R2 = trot.random_rotations(4, rng)
    t1 = rng.normal(size=(4, 3)).astype(np.float32)
    t2 = rng.normal(size=(4, 3)).astype(np.float32)
    p = rng.normal(size=(4, 20, 3)).astype(np.float32)
    A, B = RigidTransform(torch.from_numpy(R1), torch.from_numpy(t1)), \
        RigidTransform(torch.from_numpy(R2), torch.from_numpy(t2))
    JA, JB = JRT(R1, t1), JRT(R2, t2)
    _close(A.apply(torch.from_numpy(p)), JA.apply(p))
    C, JC = A.compose(B), JA.compose(JB)
    _close(C.R, JC.R)
    _close(C.t, JC.t)
    _close(A.inverse().t, JA.inverse().t)


def test_procrustes_batched(rng):
    B, N = 8, 150
    src = rng.normal(size=(B, N, 3)).astype(np.float32) * 0.3
    R = trot.random_rotations(B, rng)
    t = rng.normal(size=(B, 3)).astype(np.float32) * 0.1
    dst = (np.einsum("bij,bnj->bni", R, src) + t[:, None]
           + rng.normal(0, 0.005, (B, N, 3))).astype(np.float32)
    Rt, tt = procrustes(torch.from_numpy(src), torch.from_numpy(dst))
    Rj, tj = jprocrustes(src, dst)
    _close(Rt, Rj)
    _close(tt, tj)
    np.testing.assert_allclose(Rt.numpy(), R, atol=0.05)
    C = rng.normal(size=(B, 3, 3)).astype(np.float32)
    C[0] = 0.0                                        # degenerate: identity
    _close(horn_quaternion(torch.from_numpy(C)), jhorn(C))


# The six cube helpers of the JAX package's geo/rotation.py.  Tolerance:
# bit-equal to the jitted JAX functions, except quat_cube_max_angle (1 of
# 100,000 cubes one ulp off: within rtol 2.4e-7) and quat_cube_rotation
# outside the unit ball, where XLA's CPU build takes its own reciprocal
# root for the radial clamp (atol 2e-3 there: w = sqrt(1 − |v|²) near 0
# magnifies a 1-ulp step of v).  Then the cases of tests/test_geo.py:23-160
# on the port's functions.
def _bits(a, b):
    return np.asarray(a).view(np.int32), np.asarray(b).view(np.int32)


def _cubes(rng, n, r):
    c = rng.uniform(-r, r, (n, 3)).astype(np.float32)
    s = rng.uniform(0.001, 0.5, n).astype(np.float32)
    return c, s


def test_quat_cube_rotation_matches_jitted_jax():
    import jax

    c, _ = _cubes(np.random.default_rng(31), 100_000, 1.2)
    inside = (c.astype(np.float64) ** 2).sum(1) <= 1.0
    got = trot.quat_cube_rotation(torch.from_numpy(c)).numpy()
    ref = np.asarray(jax.jit(jrot.quat_cube_rotation)(c))
    g, r = _bits(got[inside], ref[inside])
    assert inside.sum() > 20_000 and np.array_equal(g, r)
    np.testing.assert_allclose(got[~inside], ref[~inside], rtol=0, atol=2e-3)


def test_quat_cube_tests_and_angles_match_jitted_jax():
    import jax

    c, s = _cubes(np.random.default_rng(32), 100_000, 1.2)
    ct, st = torch.from_numpy(c), torch.from_numpy(s)
    assert np.array_equal(trot.quat_cube_in_SO3(ct).numpy(),
                          np.asarray(jax.jit(jrot.quat_cube_in_SO3)(c)))
    assert np.array_equal(trot.quat_cube_overlaps_SO3(ct, st).numpy(),
                          np.asarray(jax.jit(jrot.quat_cube_overlaps_SO3)(c, s)))
    got = trot.quat_cube_max_angle(ct, st).numpy()
    ref = np.asarray(jax.jit(jrot.quat_cube_max_angle)(c, s))
    g, r = _bits(got, ref)
    assert (g != r).sum() <= 2
    np.testing.assert_allclose(got, ref, rtol=2.4e-7, atol=0)
    c3 = (3 * c).astype(np.float32)
    assert np.array_equal(trot.axis_angle_in_ball(torch.from_numpy(c3), st).numpy(),
                          np.asarray(jax.jit(jrot.axis_angle_in_ball)(c3, s)))
    s4 = (4 * s).astype(np.float32)
    g, r = _bits(trot.axis_angle_max_angle(torch.from_numpy(s4)),
                 jax.jit(jrot.axis_angle_max_angle)(s4))
    assert np.array_equal(g, r)


def test_quat_cube_rotation_matches_scipy_and_is_rotation():
    from scipy.spatial.transform import Rotation as ScipyRot

    rng = np.random.default_rng(1234)
    v = rng.uniform(-0.57, 0.57, size=(32, 3)).astype(np.float32)
    R = trot.quat_cube_rotation(torch.from_numpy(v)).numpy()
    w = np.sqrt(1 - np.sum(v ** 2, axis=1))
    R_ref = ScipyRot.from_quat(np.concatenate([v, w[:, None]], axis=1)).as_matrix()
    np.testing.assert_allclose(R, R_ref, atol=1e-5)
    v = rng.uniform(-1, 1, size=(64, 3)).astype(np.float32)
    R = trot.quat_cube_rotation(torch.from_numpy(v)).numpy()
    eye = np.einsum("bij,bkj->bik", R, R)
    np.testing.assert_allclose(eye, np.broadcast_to(np.eye(3), eye.shape), atol=1e-5)
    np.testing.assert_allclose(np.linalg.det(R), 1.0, atol=1e-5)


def test_so3_membership_and_ball_tests():
    c = torch.tensor([[0.0, 0, 0], [0.9, 0.9, 0.9], [0.5, 0.5, 0.5]])
    assert trot.quat_cube_in_SO3(c).tolist() == [True, False, True]
    ov = trot.quat_cube_overlaps_SO3(c, torch.tensor([0.25, 0.25, 0.25]))
    assert ov[0] and ov[2]
    assert not trot.quat_cube_overlaps_SO3(torch.tensor([[1.5, 1.5, 1.5]]),
                                           torch.tensor([0.1]))[0]
    keep = trot.axis_angle_in_ball(torch.tensor([[3.0, 3.0, 3.0], [0.5, 0, 0]]),
                                   torch.tensor([0.1, 0.1]))
    assert not keep[0] and keep[1]


def test_quat_and_axis_angle_max_angles_are_sound():
    """For random cubes and members, the rotation angle between the center
    and the member stays within the bound (tests/test_geo.py:62-103)."""
    from scipy.spatial.transform import Rotation as ScipyRot

    rng = np.random.default_rng(1234)
    for _ in range(50):
        c = rng.uniform(-0.5, 0.5, size=3)
        span = rng.uniform(0.01, 0.3)
        if np.linalg.norm(c) > 1:
            continue
        ct = torch.tensor(c[None], dtype=torch.float32)
        bound = float(trot.quat_cube_max_angle(ct, torch.tensor([span], dtype=torch.float32))[0])
        Rc = trot.quat_cube_rotation(ct)[0].numpy()
        for _ in range(20):
            v = c + rng.uniform(-span, span, size=3)
            if np.linalg.norm(v) > 1:
                continue
            Rv = trot.quat_cube_rotation(torch.tensor(v[None], dtype=torch.float32))[0].numpy()
            angle = np.arccos(np.clip((np.trace(Rc.T @ Rv) - 1) / 2, -1, 1))
            assert angle <= bound + 1e-4, (angle, bound, c, span, v)
    for _ in range(50):
        c = rng.uniform(-2, 2, size=3)
        span = rng.uniform(0.01, 0.5)
        bound = float(trot.axis_angle_max_angle(torch.tensor([span], dtype=torch.float32))[0])
        Rc = ScipyRot.from_rotvec(c).as_matrix()
        for _ in range(10):
            v = c + rng.uniform(-span, span, size=3)
            Rv = ScipyRot.from_rotvec(v).as_matrix()
            angle = np.arccos(np.clip((np.trace(Rc.T @ Rv) - 1) / 2, -1, 1))
            assert angle <= bound + 1e-5


def test_geo_exports_the_jax_names():
    import goicp_tpu.geo as jgeo
    import goicp_tpu_torch.geo as tgeo

    missing = [n for n in jgeo.__all__ if n not in tgeo.__all__]
    assert missing == []
