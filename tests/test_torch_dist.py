"""The port's device mesh (``goicp_tpu_torch.dist``) against the JAX
package's on the same numpy inputs: the JAX functions on the tests'
8-device virtual CPU mesh, the port's on 8 CPU shards (``device="cpu"``).

- ``sharded_bounds_step``, ``sharded_evaluate_se3`` and
  ``sharded_icp_step`` on meshes (1,8), (8,1) and (4,2), trimmed and not:
  bounds within rtol 1e-5 + atol 1e-5 (as for K2), ICP poses within 1e-5;
- ``make_sharded_se3_round`` on "exact", "grid", "mxu" and "screen", at
  h_frac 0 and 0.9: ub/lb within rtol 1e-5 + atol 1e-5 of the JAX mesh
  round, and on a cube-only mesh bit-equal to the port's own single-device
  round;
- whole solves on a (4,2) and a (2,4) mesh and the 20-round certification
  loop, against the JAX package's (``tests/test_dist_se3.py``).
"""

import numpy as np
import pytest

pytest.importorskip("jax")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from goicp_tpu.bnb import BnbParams as JBnbParams  # noqa: E402
from goicp_tpu.bnb import make_solver as jmake_solver  # noqa: E402
from goicp_tpu.dist import sharding as jsh  # noqa: E402
from goicp_tpu.dist.se3 import make_sharded_se3_round as jmake_round  # noqa: E402
from goicp_tpu.icp import IcpParams as JIcpParams  # noqa: E402
from goicp_tpu.nn.grid import build_distance_grid as jbuild_grid  # noqa: E402
from goicp_tpu_torch.bnb import BnbParams, make_solver  # noqa: E402
from goicp_tpu_torch.bnb import se3_eval  # noqa: E402
from goicp_tpu_torch.dist import sharding as sh  # noqa: E402
from goicp_tpu_torch.dist.se3 import make_engine_mesh, make_sharded_se3_round, pad_points  # noqa: E402
from goicp_tpu_torch.icp import IcpParams  # noqa: E402
from goicp_tpu_torch.nn.grid import build_distance_grid  # noqa: E402
from tests.conftest import random_rotation  # noqa: E402

torch.set_num_threads(1)
CPU = "cpu"
MESHES = [(1, 8), (8, 1), (4, 2)]
COVER = np.array([[1.5] * 3, [-1.5] * 3])


def _t(x, dtype=torch.float32):
    return torch.as_tensor(np.asarray(x), dtype=dtype)


def _close(got, ref):
    got, ref = np.asarray(got), np.asarray(ref)
    fin = np.isfinite(ref)
    assert (fin == np.isfinite(got)).all()
    np.testing.assert_allclose(got[fin], ref[fin], rtol=1e-5, atol=1e-5)


def _bits_equal(a, b):
    a, b = np.asarray(a, np.float32), np.asarray(b, np.float32)
    assert a.shape == b.shape
    assert (a.view(np.int32) == b.view(np.int32)).all(), int((a != b).sum())


@pytest.fixture(scope="module")
def grid_setup():
    rng = np.random.default_rng(5)
    src = (rng.random((256, 3)).astype(np.float32) - 0.5) * 0.6
    tgt = (rng.random((200, 3)).astype(np.float32) - 0.5) * 0.6
    kw = dict(n=64, cover=COVER, method="brute", with_index=True)
    return src, tgt, jbuild_grid(tgt, **kw), build_distance_grid(tgt, device=CPU, **kw)


def _quat_jobs(rng, M):
    from goicp_tpu.geo.rotation import quat_cube_max_angle, quat_cube_rotation

    q_c = (rng.random((M, 3)).astype(np.float32) - 0.5)
    q_s = rng.random(M).astype(np.float32) * 0.2 + 0.02
    R = np.asarray(quat_cube_rotation(jnp.asarray(q_c)))
    ang = np.asarray(quat_cube_max_angle(jnp.asarray(q_c), jnp.asarray(q_s)))
    t_c = (rng.random((M, 3)).astype(np.float32) - 0.5) * 0.3
    t_s = rng.random(M).astype(np.float32) * 0.1
    flag = (rng.random(M) > 0.5).astype(np.float32)
    return R, ang, t_c, t_s, flag


@pytest.mark.parametrize("trim", [0, 32])
@pytest.mark.parametrize("mesh_shape", MESHES)
def test_sharded_bounds_step_matches_jax(grid_setup, mesh_shape, trim):
    src, _, jgrid, grid = grid_setup
    rng = np.random.default_rng(11)
    M = 16
    R, ang, t_c, t_s, flag = _quat_jobs(rng, M)
    mask = np.ones(M, bool)
    mask[-3:] = False
    norms = np.linalg.norm(src, axis=1).astype(np.float32)
    slack = 0.01
    jstep = jsh.sharded_bounds_step(jsh.make_mesh(*mesh_shape), jgrid, trim_drop=trim,
                                    lookup="trilinear", slack=slack)
    ref = jstep(*(jnp.asarray(x) for x in (src, norms, R, ang, t_c, t_s, flag, mask)))
    step = sh.sharded_bounds_step(sh.make_mesh(*mesh_shape, device=CPU), grid, trim_drop=trim,
                                  lookup="trilinear", slack=slack)
    got = step(*(_t(x) for x in (src, norms, R, ang, t_c, t_s, flag)), _t(mask, torch.bool))
    for g, r in zip(got, ref):
        _close(g.numpy(), r)
    # the SSE form: the center value at exact poses
    sse = sh.sharded_sse(sh.make_mesh(*mesh_shape, device=CPU), grid, trim_drop=trim)
    jsse = jsh.sharded_sse(jsh.make_mesh(*mesh_shape), jgrid, trim_drop=trim)
    _close(sse(_t(src), _t(norms), _t(R), _t(t_c)).numpy(),
           jsse(jnp.asarray(src), jnp.asarray(norms), jnp.asarray(R), jnp.asarray(t_c)))


@pytest.mark.parametrize("trim", [0, 32])
@pytest.mark.parametrize("mesh_shape", MESHES)
def test_sharded_evaluate_se3_matches_jax(grid_setup, mesh_shape, trim):
    src, _, jgrid, grid = grid_setup
    rng = np.random.default_rng(12)
    M = 16
    R = np.stack([random_rotation(rng) for _ in range(M)])
    ang = rng.random(M).astype(np.float32) * 0.4
    t_c = (rng.random((M, 3)).astype(np.float32) - 0.5) * 0.3
    t_s = rng.random(M).astype(np.float32) * 0.1
    mask = np.ones(M, bool)
    mask[:2] = False
    norms = np.linalg.norm(src, axis=1).astype(np.float32)
    jstep = jsh.sharded_evaluate_se3(jsh.make_mesh(*mesh_shape), jgrid, trim_drop=trim,
                                     slack=0.005)
    ref = jstep(*(jnp.asarray(x) for x in (src, norms, R, ang, t_c, t_s, mask)))
    step = sh.sharded_evaluate_se3(sh.make_mesh(*mesh_shape, device=CPU), grid,
                                   trim_drop=trim, slack=0.005)
    got = step(*(_t(x) for x in (src, norms, R, ang, t_c, t_s)), _t(mask, torch.bool))
    for g, r in zip(got, ref):
        _close(g.numpy(), r)


@pytest.mark.parametrize("trim", [0, 32])
@pytest.mark.parametrize("mesh_shape", MESHES)
def test_sharded_icp_step_matches_jax(grid_setup, mesh_shape, trim):
    src, _, _, _ = grid_setup
    rng = np.random.default_rng(13)
    R_true = random_rotation(rng)
    t_true = np.array([0.05, -0.03, 0.08], np.float32)
    # noise keeps the residuals apart: a noise-free pair gives every point
    # the same residual near the truth, and a trimmed step's "d2 below the
    # drop-th largest" then turns on ties of rounding
    noise = rng.normal(0.0, 0.003, src.shape).astype(np.float32)
    tgt2 = (src @ R_true.T + t_true + noise).astype(np.float32)
    kw = dict(n=64, cover=COVER, method="brute", with_index=True)
    jstep = jsh.sharded_icp_step(jsh.make_mesh(*mesh_shape), jbuild_grid(tgt2, **kw), tgt2,
                                 trim_drop=trim)
    step = sh.sharded_icp_step(sh.make_mesh(*mesh_shape, device=CPU),
                               build_distance_grid(tgt2, device=CPU, **kw), tgt2,
                               trim_drop=trim)
    B = 8
    Rs = np.tile(R_true[None], (B, 1, 1)).astype(np.float32)
    ts = (t_true[None] + (rng.random((B, 3)).astype(np.float32) - 0.5) * 0.02)
    jR, jt, jsse = jstep(jnp.asarray(src), jnp.asarray(Rs), jnp.asarray(ts))
    R1, t1, sse1 = step(_t(src), _t(Rs), _t(ts))
    np.testing.assert_allclose(R1.numpy(), np.asarray(jR), atol=1e-5)
    np.testing.assert_allclose(t1.numpy(), np.asarray(jt), atol=1e-5)
    np.testing.assert_allclose(sse1.numpy(), np.asarray(jsse), rtol=1e-5, atol=1e-6)
    # iterated, the port's step reaches the true pose
    R, t = R1, t1
    for _ in range(10):
        R, t, _ = step(_t(src), R, t)
    np.testing.assert_allclose(R.numpy()[0], R_true, atol=2e-3)
    np.testing.assert_allclose(t.numpy()[0], t_true, atol=2e-3)


def test_make_mesh_extents_and_repeats():
    m = sh.make_mesh(4, 2, device=CPU)
    assert m.shape == {"cubes": 4, "points": 2} and m.devices.size == 8
    rep = sh.make_mesh(3, 1, devices=[torch.device("cpu")] * 3)
    assert rep.devices.shape == (3, 1)
    with pytest.raises(ValueError, match="need 4 devices"):
        sh.make_mesh(2, 2, devices=["cpu"] * 3)


# ---------------------------------------------------------------------------
# the mesh round (tests/test_dist_se3.py's setup)
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def round_setup():
    rng = np.random.default_rng(9)
    src = (rng.random((300, 3)).astype(np.float32) - 0.5) * 0.6
    tgt = (rng.random((256, 3)).astype(np.float32) - 0.5) * 0.6
    kw = dict(n=16, cover=COVER, method="brute", with_index=True)
    return src, tgt, jbuild_grid(tgt, **kw), build_distance_grid(tgt, device=CPU, **kw)


def _se3_jobs(rng, M):
    Rs = np.stack([random_rotation(rng) for _ in range(M)])
    ang = rng.random(M).astype(np.float32) * 0.4
    t_c = (rng.random((M, 3)).astype(np.float32) - 0.5) * 0.3
    t_s = rng.random(M).astype(np.float32) * 0.1
    return Rs, ang, t_c, t_s


def _single_round(backend, src, norms, grid, tgt, R, ang, t_c, t_s, mask, h, thresh):
    """The port's single-device bounds of the same jobs."""
    return se3_eval.se3_round_bounds(
        _t(src), _t(norms), _t(tgt), 0.0, thresh, _t(R), _t(ang), _t(t_c), _t(t_s),
        _t(mask, torch.bool), h=h, backend=backend, grid=grid, lookup="nearest", tile=128)


ROUND_CASES = [("exact", s) for s in MESHES] + [("grid", s) for s in MESHES] + [
    ("mxu", (2, 2)), ("mxu", (4, 1)), ("screen", (4, 1)), ("screen", (2, 2))]


@pytest.mark.parametrize("h_frac", [0.0, 0.9])
@pytest.mark.parametrize("backend,mesh_shape", ROUND_CASES)
def test_sharded_round_matches_jax_and_single_device(round_setup, backend, mesh_shape, h_frac):
    src, tgt, jgrid, grid = round_setup
    rng = np.random.default_rng(77)
    norms = np.linalg.norm(src, axis=1).astype(np.float32)
    N = src.shape[0]
    h = int(N * h_frac) if h_frac else 0
    M = 16
    R, ang, t_c, t_s = _se3_jobs(rng, M)
    mask = np.ones(M, bool)
    mask[-2:] = False
    n_c, n_p = mesh_shape
    quantum = 128
    src_p, norms_p = pad_points(src, norms, n_p, quantum)
    thresh = np.float32(np.inf)
    kw = dict(h=h, n_valid=N, lookup="nearest", backend=backend, tile=128, refine_k=4,
              icp_backend="exact")
    jrnd = jmake_round(jsh.make_mesh(*mesh_shape), icp_params=JIcpParams(max_iter=2), **kw)
    jub, jlb, *_ = jrnd(
        jnp.asarray(src_p), jnp.asarray(norms_p), jgrid, jnp.asarray(tgt), jnp.float32(0.0),
        jnp.float32(thresh), jnp.asarray(R), jnp.asarray(ang), jnp.asarray(t_c),
        jnp.asarray(t_s), jnp.asarray(mask), jnp.asarray(src))
    rnd = make_sharded_se3_round(sh.make_mesh(*mesh_shape, device=CPU),
                                 icp_params=IcpParams(max_iter=2), **kw)
    ub, lb, R_ref, _, sse_ref, _ = rnd(
        _t(src_p), _t(norms_p), grid, _t(tgt), 0.0, float(thresh), _t(R), _t(ang),
        _t(t_c), _t(t_s), _t(mask, torch.bool), _t(src))
    _close(ub.numpy(), jub)
    _close(lb.numpy(), jlb)
    # the refine ran on the global top-k: finite SSEs, rotations
    assert np.isfinite(sse_ref.numpy()).all()
    np.testing.assert_allclose(np.linalg.det(R_ref.numpy()), 1.0, atol=1e-3)
    if n_p == 1:
        sub, slb = _single_round(backend, src, norms, grid, tgt, R, ang, t_c, t_s, mask, h,
                                 float(thresh))
        _bits_equal(ub.numpy(), sub.numpy())
        _bits_equal(lb.numpy(), slb.numpy())


def test_sharded_screen_round_with_threshold(round_setup):
    """The screened round on a cube-only mesh with a finite threshold: each
    shard screens its own nodes, bit-equal to the single-device screen, and
    every screened lb stays a lower bound of the full lb."""
    src, tgt, _, grid = round_setup
    rng = np.random.default_rng(4)
    norms = np.linalg.norm(src, axis=1).astype(np.float32)
    M = 8
    R, ang, t_c, t_s = _se3_jobs(rng, M)
    mask = np.ones(M, bool)
    src_p, norms_p = pad_points(src, norms, 1, 128)
    full_ub, full_lb = _single_round("mxu", src, norms, grid, tgt, R, ang, t_c, t_s, mask, 0,
                                     np.inf)
    thr = float(np.median(full_lb.numpy()))
    rnd = make_sharded_se3_round(sh.make_mesh(4, 1, device=CPU), h=0, n_valid=src.shape[0],
                                 lookup="nearest", backend="screen", tile=128, refine_k=2,
                                 icp_params=IcpParams(max_iter=1), icp_backend="exact")
    ub, lb = rnd.bounds(_t(src_p), _t(norms_p), grid, _t(tgt), 0.0, thr, _t(R), _t(ang),
                        _t(t_c), _t(t_s), _t(mask, torch.bool))
    sub, slb = _single_round("screen", src, norms, grid, tgt, R, ang, t_c, t_s, mask, 0, thr)
    _bits_equal(ub.numpy(), sub.numpy())
    _bits_equal(lb.numpy(), slb.numpy())
    lb, full = lb.numpy(), full_lb.numpy()
    assert (lb <= full + 1e-5 * np.maximum(full, 1.0)).all()
    pruned = lb < full - 1e-5 * np.maximum(full, 1.0)
    assert (lb[pruned] > thr).all()


def test_engine_mesh_extents():
    """``mesh_cubes = 0`` is every local device: one on the CPU, so no mesh;
    explicit extents build one."""
    src = np.random.default_rng(1).random((40, 3)).astype(np.float32)
    norms = np.linalg.norm(src, axis=1)
    kw = dict(h=0, icp_params=IcpParams(), icp_backend="exact", device=CPU)
    assert make_engine_mesh(BnbParams(mesh_cubes=0), "exact", src, norms, **kw) is None
    assert make_engine_mesh(BnbParams(), "exact", src, norms, **kw) is None
    rnd, src_pad, _, n_c, n_p = make_engine_mesh(BnbParams(mesh_cubes=0, mesh_points=2), "mxu",
                                                 src, norms, **kw)
    assert (n_c, n_p) == (1, 2) and src_pad.shape[0] == 256


# ---------------------------------------------------------------------------
# whole solves on the mesh
# ---------------------------------------------------------------------------


def _tiny_problem():
    rng = np.random.default_rng(21)
    src = (rng.random((48, 3)).astype(np.float32) - 0.5)
    R_true = random_rotation(rng)
    t_true = np.array([0.15, -0.1, 0.05], np.float32)
    tgt = (src @ R_true.T + t_true).astype(np.float32)
    return src, tgt, R_true, t_true


def _both(src, tgt, **kw):
    j = jmake_solver(src, tgt, JBnbParams(**kw)).run()
    t = make_solver(src, tgt, BnbParams(**kw), device=CPU).run()
    return j, t


@pytest.mark.parametrize("trim", [0.0, 0.2])
def test_full_solve_on_mesh_matches_jax(trim):
    """A whole solve on the (4,2) mesh (untrimmed) and the (2,4) mesh
    (trimmed, 10 % outliers) in both packages: both converge to the truth
    and to each other, with equal rounds and node counts."""
    src, tgt, R_true, t_true = _tiny_problem()
    shape = (4, 2)
    if trim:
        rng = np.random.default_rng(5)
        tgt = tgt.copy()
        tgt[:5] += rng.normal(size=(5, 3)).astype(np.float32) * 2.0
        shape = (2, 4)
    kw = dict(mse_threshold=1e-4, trim_fraction=trim, engine="se3", bound_backend="exact",
              se3_pop=32, init_multistart=4, refine_top_k=4, pipeline_depth=1, max_rounds=400,
              mesh_cubes=shape[0], mesh_points=shape[1])
    j, t = _both(src, tgt, **kw)
    solo = make_solver(src, tgt, BnbParams(**{**kw, "mesh_cubes": 1, "mesh_points": 1}),
                       device=CPU).run()
    assert j.converged and t.converged and solo.converged
    tol = 5e-3 if trim else 2e-3
    for res in (j, t):
        np.testing.assert_allclose(res.transform.R, R_true, atol=tol)
        if not trim:
            np.testing.assert_allclose(res.transform.t, t_true, atol=tol)
    np.testing.assert_allclose(t.transform.R, j.transform.R, atol=tol)
    np.testing.assert_allclose(t.transform.R, solo.transform.R, atol=tol)
    assert abs(t.mse - j.mse) < 1e-5
    assert (t.rounds, t.rot_nodes) == (j.rounds, j.rot_nodes)


def test_mesh_certification_frontier_loop_matches_jax():
    """20 rounds of genuine certification through the (4,2) mesh path,
    trimmed: the incumbent equals the JAX package's and the single-device
    port's, the gap within 0.5-2× of them, equal rounds and nodes."""
    rng = np.random.default_rng(31)
    src = (rng.random((120, 3)).astype(np.float32) - 0.5) * 0.6
    A = rng.normal(size=(3, 3))
    Q, R_ = np.linalg.qr(A)
    Q = (Q * np.sign(np.diag(R_))).astype(np.float32)
    if np.linalg.det(Q) < 0:
        Q[:, 0] *= -1
    t_true = np.array([0.15, -0.1, 0.05], np.float32)
    tgt = (src @ Q.T + t_true + rng.normal(size=src.shape).astype(np.float32) * 0.03)
    tgt[:6] += rng.normal(size=(6, 3)).astype(np.float32) * 1.5
    tgt = tgt.astype(np.float32)
    kw = dict(mse_threshold=1.9e-3, trim_fraction=0.1, engine="se3", bound_backend="exact",
              se3_pop=64, init_multistart=8, refine_top_k=4, max_rounds=20)
    solo = make_solver(src, tgt, BnbParams(**kw), device=CPU).run()
    j, t = _both(src, tgt, mesh_cubes=4, mesh_points=2, **kw)
    assert t.rounds > 1 and t.rot_nodes >= 5_000, (t.rounds, t.rot_nodes)
    for ref in (j, solo):
        np.testing.assert_allclose(t.transform.R, ref.transform.R, atol=5e-3)
        g1, g8 = max(ref.gap, 1e-9), max(t.gap, 1e-9)
        assert 0.5 < g8 / g1 < 2.0, (g8, g1)
    assert (t.rounds, t.rot_nodes) == (j.rounds, j.rot_nodes)
