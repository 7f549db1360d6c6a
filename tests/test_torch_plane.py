"""The port's plane metric against the JAX package on the same numpy
inputs: the closed-form smallest eigenvector, PCA normals, the damped
Gauss-Newton step, plane-metric ICP (batched, trimmed, on exact and grid
correspondences), the traced ICP of the CLI's ICP modes, and a whole
plane-metric solve.

Tolerances: normals |dot| ≥ 1 − 1e-5 (sign-free; the kNN sets are equal
away from distance ties, which the clouds here do not have); the plane step
rtol 1e-4 + atol 1e-6 (batched 6x6 solves, LAPACK against XLA); ICP poses to
1e-4, sse rtol 1e-5, iteration counts equal; whole solves with rounds and
nodes equal.
"""

import dataclasses
import os

import numpy as np
import pytest

pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from goicp_tpu.bnb import BnbParams as JBnbParams  # noqa: E402
from goicp_tpu.bnb import register as jregister  # noqa: E402
from goicp_tpu.core.types import RigidTransform as JRT  # noqa: E402
from goicp_tpu.geo import normals as jnormals  # noqa: E402
from goicp_tpu.icp import IcpParams as JIcpParams  # noqa: E402
from goicp_tpu.icp import solver as jicp  # noqa: E402
from goicp_tpu.nn import grid as jgrid  # noqa: E402
from goicp_tpu_torch import BnbParams, register  # noqa: E402
from goicp_tpu_torch.core.types import RigidTransform  # noqa: E402
from goicp_tpu_torch.geo import normals as tnormals  # noqa: E402
from goicp_tpu_torch.geo.rotation import random_rotations  # noqa: E402
from goicp_tpu_torch.icp import IcpParams  # noqa: E402
from goicp_tpu_torch.icp import solver as ticp  # noqa: E402
from goicp_tpu_torch.io import read_ply  # noqa: E402
from goicp_tpu_torch.nn import grid as tgrid  # noqa: E402

torch.set_num_threads(1)

BUNNY = os.path.join(os.path.dirname(__file__), "..", "data_generated", "rotated_bunny.ply")


def _unit_dots(a, b):
    return np.abs(np.sum(a * b, axis=-1))


def test_smallest_eigvec_matches_jax_and_degenerate_inputs():
    rng = np.random.default_rng(2)
    A = rng.normal(size=(64, 3, 3)).astype(np.float32)
    C = A @ A.transpose(0, 2, 1)                                  # generic SPD
    u = np.float32([[1, 0, 0]]).T
    v = np.float32([[0, 1, 0]]).T
    degenerate = np.stack([
        u @ u.T + v @ v.T,                      # planar: rank 2, normal +z
        4.0 * (u @ u.T),                        # collinear: rank 1
        np.eye(3, dtype=np.float32),            # isotropic: every direction
        np.zeros((3, 3), np.float32),           # a single repeated point
    ]).astype(np.float32)
    C = np.concatenate([C, degenerate])
    nj = np.asarray(jnormals._smallest_eigvec_3x3(jnp.asarray(C)))
    nt = tnormals._smallest_eigvec_3x3(torch.from_numpy(C)).numpy()
    assert np.all(_unit_dots(nt, nj) >= 1 - 1e-5)
    np.testing.assert_allclose(np.linalg.norm(nt, axis=1), 1.0, rtol=1e-5)
    # it is the eigenvector of the smallest eigenvalue of the generic ones
    w, V = np.linalg.eigh(C[:64].astype(np.float64))
    assert np.all(_unit_dots(nt[:64], V[:, :, 0]) >= 1 - 1e-4)
    assert abs(nt[64, 2]) > 1 - 1e-6                               # planar → ±z
    assert abs(nt[65, 0]) < 1e-6                                   # ⟂ the line
    np.testing.assert_array_equal(nt[66:], [[0, 0, 1], [0, 0, 1]])  # fallback +z


@pytest.mark.parametrize("n,k,block", [(700, 16, 256), (1500, 8, 1024)])
def test_estimate_normals_matches_jax(n, k, block):
    pts = read_ply(BUNNY)
    pts = pts[np.sort(np.random.default_rng(n).choice(pts.shape[0], n, replace=False))]
    pts = (pts / np.abs(pts).max()).astype(np.float32)
    nj = np.asarray(jnormals.estimate_normals(jnp.asarray(pts), k=k, block=block))
    nt = tnormals.estimate_normals(torch.from_numpy(pts), k=k, block=block).numpy()
    # away from kNN distance ties, the neighbour sets and the normals agree
    d2 = np.sum((pts[:, None] - pts[None]) ** 2, -1)
    srt = np.sort(d2, axis=1)
    clear = srt[:, k] - srt[:, k - 1] > 1e-6 * srt[:, k]
    assert clear.mean() > 0.95
    assert np.all(_unit_dots(nt[clear], nj[clear]) >= 1 - 1e-5)


@pytest.fixture(scope="module")
def problem():
    """A smooth surface (bunny subset) moved by a pose, and 16 starts within
    ~15° and 0.04 of it: plane-metric ICP from far starts wanders, and its
    f32 rounding then grows past any fixed tolerance."""
    pts = read_ply(BUNNY)
    pts = pts / np.abs(pts).max()
    rng = np.random.default_rng(5)
    tgt = pts[np.sort(rng.choice(pts.shape[0], 400, replace=False))].astype(np.float32)
    src = pts[np.sort(rng.choice(pts.shape[0], 250, replace=False))]
    R = random_rotations(1, rng)[0]
    src = ((src.astype(np.float32) - np.float32([0.02, -0.01, 0.03])) @ R).astype(np.float32)
    from goicp_tpu_torch.geo.rotation import axis_angle_rotation

    dR = axis_angle_rotation(torch.from_numpy(rng.uniform(-0.15, 0.15, (16, 3)).astype(np.float32)))
    R0 = (dR.numpy() @ R).astype(np.float32)
    t0 = (np.float32([0.02, -0.01, 0.03]) + rng.normal(0, 0.02, (16, 3))).astype(np.float32)
    nrm = np.array(jnormals.estimate_normals(jnp.asarray(tgt), k=16))
    return src, tgt, nrm, R0, t0


def test_plane_update_matches_jax(problem):
    src, tgt, nrm, R0, t0 = problem
    rng = np.random.default_rng(7)
    pts = (src[None] @ R0.transpose(0, 2, 1) + t0[:, None]).astype(np.float32)
    idx = rng.integers(0, tgt.shape[0], pts.shape[:2])
    dst, nn = tgt[idx], nrm[idx]
    w = (rng.random(pts.shape[:2]) > 0.2).astype(np.float32)
    for ww in (None, w):
        Rj, tj = jicp._plane_update(jnp.asarray(pts), jnp.asarray(dst), jnp.asarray(nn),
                                    None if ww is None else jnp.asarray(ww))
        Rt, tt = ticp._plane_update(torch.from_numpy(pts), torch.from_numpy(dst),
                                    torch.from_numpy(nn),
                                    None if ww is None else torch.from_numpy(ww))
        np.testing.assert_allclose(Rt.numpy(), np.asarray(Rj), rtol=1e-4, atol=1e-6)
        np.testing.assert_allclose(tt.numpy(), np.asarray(tj), rtol=1e-4, atol=1e-6)


def _corrs(kind, tgt, nrm):
    if kind == "exact":
        return (jicp.exact_correspondence(tgt, normals=nrm),
                ticp.exact_correspondence(torch.from_numpy(tgt), normals=torch.from_numpy(nrm)))
    J = jgrid.build_distance_grid(tgt, n=48, method="edt", with_index=True)
    T = tgrid.build_distance_grid(torch.from_numpy(tgt), n=48, method="edt", with_index=True)
    return (jicp.grid_correspondence(J, jnp.asarray(tgt), normals=nrm),
            ticp.grid_correspondence(T, torch.from_numpy(tgt), normals=torch.from_numpy(nrm)))


@pytest.mark.parametrize("kind", ["exact", "grid"])
@pytest.mark.parametrize("trim", [0.0, 0.15])
def test_run_icp_plane_matches_jax(problem, kind, trim):
    src, tgt, nrm, R0, t0 = problem
    cj, ct = _corrs(kind, tgt, nrm)
    kw = dict(max_iter=40, rel_tol=1e-5, trim_fraction=trim, metric="plane")
    active0 = np.ones(16, bool)
    active0[[3, 11]] = False
    rj = jicp.run_icp(src, cj, JRT(R0, t0), JIcpParams(**kw), active0=active0)
    rt = ticp.run_icp(torch.from_numpy(src), ct,
                      RigidTransform(torch.from_numpy(R0), torch.from_numpy(t0)),
                      IcpParams(**kw), active0=torch.from_numpy(active0))
    np.testing.assert_allclose(rt.transform.R.numpy(), np.asarray(rj.transform.R), atol=1e-4)
    np.testing.assert_allclose(rt.transform.t.numpy(), np.asarray(rj.transform.t), atol=1e-4)
    np.testing.assert_allclose(rt.sse.numpy(), np.asarray(rj.sse), rtol=1e-5)
    np.testing.assert_array_equal(rt.iters.numpy(), np.asarray(rj.iters))
    assert rt.iters.max() > 2 and np.isinf(rt.sse.numpy()[~active0]).all()


@pytest.mark.parametrize("metric,kind", [("point", "exact"), ("plane", "exact"),
                                         ("plane", "grid")])
def test_run_icp_trace_matches_jax(problem, metric, kind):
    src, tgt, nrm, R0, t0 = problem
    cj, ct = _corrs(kind, tgt, nrm)
    for max_iter in (25, 0):
        kw = dict(max_iter=max_iter, rel_tol=1e-5, metric=metric)
        rj, trj = jicp.run_icp_trace(src, cj, JRT(R0[0], t0[0]), JIcpParams(**kw))
        rt, trt = ticp.run_icp_trace(torch.from_numpy(src), ct,
                                     RigidTransform(torch.from_numpy(R0[0]),
                                                    torch.from_numpy(t0[0])),
                                     IcpParams(**kw))
        assert [tuple(x.shape) for x in trt] == [np.shape(x) for x in trj]
        np.testing.assert_array_equal(trt[3].numpy(), np.asarray(trj[3]))
        np.testing.assert_allclose(trt[0].numpy(), np.asarray(trj[0]), atol=1e-4)
        np.testing.assert_allclose(trt[1].numpy(), np.asarray(trj[1]), atol=1e-4)
        np.testing.assert_allclose(trt[2].numpy(), np.asarray(trj[2]), rtol=1e-5)
        np.testing.assert_allclose(rt.transform.R.numpy(), np.asarray(rj.transform.R), atol=1e-4)
        np.testing.assert_allclose(rt.sse.numpy(), np.asarray(rj.sse), rtol=1e-5)
        assert int(rt.iters) == int(rj.iters) == int(trt[3].sum())
        assert int(rt.iters) > 2 or max_iter == 0


@pytest.fixture(scope="module")
def clouds():
    rng = np.random.default_rng(11)
    src = rng.uniform(-0.3, 0.3, (100, 3)).astype(np.float32)
    R = random_rotations(1, np.random.default_rng(5))[0]
    tgt = (src @ R.T + np.float32([0.05, -0.02, 0.03])
           + rng.normal(0, 0.01, (100, 3))).astype(np.float32)
    return src, tgt


@pytest.mark.parametrize("kw", [dict(bound_backend="mxu", screen=True),
                                dict(bound_backend="grid", icp_exact_max=50,
                                     grid_resolution=32)],
                         ids=["mxu", "grid-icp"])
def test_plane_metric_whole_solve_parity_with_jax(clouds, kw):
    src, tgt = clouds
    jp = JBnbParams(mse_threshold=1e-4, se3_pop=64, init_multistart=8, refine_top_k=2,
                    max_rounds=30, icp_metric="plane", **kw)
    rj = jregister(src, tgt, jp)
    rt = register(src, tgt, BnbParams.from_dict(dataclasses.asdict(jp)), device="cpu")
    assert rj.rounds == rt.rounds == 30
    assert rt.rot_nodes == rj.rot_nodes and rt.rot_nodes > 1000
    assert rt.converged == rj.converged and rt.icp_iters == rj.icp_iters
    np.testing.assert_allclose(rt.transform.R, np.asarray(rj.transform.R), atol=1e-4)
    np.testing.assert_allclose(rt.sse, rj.sse, rtol=1e-5)
    np.testing.assert_allclose(rt.gap, rj.gap, rtol=1e-5, atol=1e-7)


def test_plane_step_stages_against_jitted_jax():
    """Which stage of the plane step rounds apart from the jitted JAX one
    (``icp/solver.py:143``), each stage fed the same f32 inputs:

    - the residual ``sum((p − q)·n)``: XLA contracts it as
      ``fma(d_z, n_z, fma(d_y, n_y, d_x·n_x))``, which ``fused.fma``
      repeats bit for bit (the port's plain sum differs in about a third);
    - the Gram matrix ``Jwᵀ J`` over 1,518 points: an XLA CPU dot thunk
      (Eigen's blocked contraction) against ATen's matmul;
    - the 6×6 solve: jaxlib's LAPACK ``sgetrf`` and two ``strsm`` against
      ``torch.linalg.solve``.

    The last two differ in the last bits of (nearly) every system (on an
    x86 CPU: the Gram matrix of 32 of 32 poses, the solution of 98,068 of
    the 100,000 systems here), so the step stays within the file's rtol
    1e-4 + atol 1e-6 and is not bit-equal."""
    import jax

    from goicp_tpu_torch.nn.fused import fma

    rng = np.random.default_rng(40)
    d = rng.normal(size=(100_000, 3)).astype(np.float32)
    n = rng.normal(size=(100_000, 3)).astype(np.float32)
    rj = np.asarray(jax.jit(lambda d, n: jnp.sum(d * n, axis=-1))(d, n))
    D, Nn = torch.from_numpy(d), torch.from_numpy(n)
    r_fma = fma(D[:, 2], Nn[:, 2], fma(D[:, 1], Nn[:, 1], D[:, 0] * Nn[:, 0])).numpy()
    assert np.array_equal(r_fma.view(np.int32), rj.view(np.int32))

    gram = jax.jit(lambda a, b: jnp.einsum("...ni,...nj->...ij", a, b,
                                           precision=jax.lax.Precision.HIGHEST))
    for _ in range(4):
        Jw = rng.normal(size=(8, 1518, 6)).astype(np.float32)
        J = rng.normal(size=(8, 1518, 6)).astype(np.float32)
        Hj = np.asarray(gram(Jw, J))
        Ht = (torch.from_numpy(Jw).transpose(-1, -2) @ torch.from_numpy(J)).numpy()
        np.testing.assert_allclose(Ht, Hj, rtol=0, atol=1e-5 * np.abs(Jw).max() * np.abs(J).max()
                                   * np.sqrt(1518))

    S = 100_000
    A = rng.normal(size=(S, 60, 6)).astype(np.float32)
    H = np.einsum("sni,snj->sij", A.astype(np.float64), A).astype(np.float32)
    g = rng.normal(size=(S, 6)).astype(np.float32)
    xj = np.asarray(jax.jit(lambda H, g: jnp.linalg.solve(H, g[..., None])[..., 0])(H, g))
    xt = torch.linalg.solve(torch.from_numpy(H), torch.from_numpy(g)[..., None])[..., 0].numpy()
    np.testing.assert_allclose(xt, xj, rtol=1e-4, atol=1e-6)
