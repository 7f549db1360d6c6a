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
