"""The port's SE(3) rounds and whole solve against the JAX package on the
same numpy inputs.

Parity protocol of the whole solve: 100 points uniform in [−0.3, 0.3]³ from
``default_rng(11)``, target = R·src + t + N(0, 0.01), both packages pinned to
``bound_backend="mxu", screen=True`` (JAX on the CPU would otherwise pick
its exact backend).  The initial ICP misses the threshold, so the BnB runs.
"""

import dataclasses
import os

import numpy as np
import pytest

pytest.importorskip("jax")

import torch  # noqa: E402

from goicp_tpu.bnb import BnbParams as JBnbParams  # noqa: E402
from goicp_tpu.bnb import register as jregister  # noqa: E402
from goicp_tpu.bnb.se3_eval import se3_round as jround  # noqa: E402
from goicp_tpu.bnb.se3_eval import se3_round_grouped as jround_g  # noqa: E402
from goicp_tpu.icp import IcpParams as JIcpParams  # noqa: E402
from goicp_tpu_torch import BnbParams, register  # noqa: E402
from goicp_tpu_torch.bnb.se3_eval import se3_round, se3_round_grouped  # noqa: E402
from goicp_tpu_torch.geo.rotation import random_rotations  # noqa: E402
from goicp_tpu_torch.icp import IcpParams  # noqa: E402

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def clouds():
    rng = np.random.default_rng(11)
    src = rng.uniform(-0.3, 0.3, (100, 3)).astype(np.float32)
    R = random_rotations(1, np.random.default_rng(5))[0]
    t = np.float32([0.05, -0.02, 0.03])
    tgt = (src @ R.T + t + rng.normal(0, 0.01, (100, 3))).astype(np.float32)
    return src, tgt, R, t


def _t(x):
    return torch.from_numpy(np.array(x))


def _round_inputs(clouds, M):
    src, tgt, R_true, _ = clouds
    rng = np.random.default_rng(3)
    norms = np.linalg.norm(src, axis=1).astype(np.float32)
    centers = rng.uniform(-1.0, 1.0, (M, 3)).astype(np.float32)
    spans = np.full(M, np.pi / 8, np.float32)
    R = random_rotations(M, rng)
    R[0] = R_true                                   # one node near the optimum
    mask = np.ones(M, bool)
    mask[-3:] = False
    return src, tgt, norms, centers, spans, R, mask


def _agree_round(out_j, out_t):
    ub_j, lb_j, R_j, t_j, sse_j, it_j = (np.asarray(x) for x in out_j)
    ub_t, lb_t, R_t, t_t, sse_t, it_t = (x.numpy() for x in out_t)
    np.testing.assert_array_equal(np.isinf(ub_j), np.isinf(ub_t))
    np.testing.assert_allclose(ub_t, ub_j, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(lb_t, lb_j, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(R_t, R_j, rtol=0, atol=1e-5)
    np.testing.assert_allclose(t_t, t_j, rtol=0, atol=1e-5)
    np.testing.assert_allclose(sse_t, sse_j, rtol=1e-5)
    np.testing.assert_array_equal(it_t, it_j)


def test_se3_round_matches_jax(clouds):
    M = 24
    src, tgt, norms, centers, spans, R, mask = _round_inputs(clouds, M)
    rng = np.random.default_rng(4)
    t_c = rng.uniform(-0.1, 0.1, (M, 3)).astype(np.float32)
    t_span = np.full(M, 0.005, np.float32)
    spans = spans / 8
    # a threshold inside the spread of the unscreened lower bounds
    lb_full = se3_round(
        _t(src), _t(norms), _t(tgt), 0.0, 1e30, _t(R), (_t(centers), _t(spans)),
        _t(t_c), _t(t_span), _t(mask), h=0, backend="screen", refine_k=1,
        icp_params=IcpParams(max_iter=0),
    )[1].numpy()[:-3]
    thresh, gate = float(np.median(lb_full)), 2.0
    assert thresh > 0
    out_j = jround(
        src, norms, None, tgt, None, np.float32(0.0), np.float32(thresh), R,
        (centers, spans), t_c, t_span, mask, h=0, lookup="nearest",
        backend="screen", tile=128, tgt_tile=256, refine_k=4,
        icp_params=JIcpParams(max_iter=32, rel_tol=1e-4), icp_backend="exact",
        refine_gate=np.float32(gate),
    )
    out_t = se3_round(
        _t(src), _t(norms), _t(tgt), 0.0, thresh, _t(R), (_t(centers), _t(spans)),
        _t(t_c), _t(t_span), _t(mask), h=0, backend="screen", refine_k=4,
        icp_params=IcpParams(max_iter=32, rel_tol=1e-4), refine_gate=gate,
    )
    _agree_round(out_j, out_t)
    ub = out_t[0].numpy()
    assert (ub[:-3] == 1e30).any() and (ub[:-3] < 1e30).any()   # some screened


def test_se3_round_grouped_matches_jax(clouds):
    G = 5
    src, tgt, norms, centers, spans, R, _ = _round_inputs(clouds, G)
    rng = np.random.default_rng(6)
    t8 = rng.uniform(-0.1, 0.1, (G, 8, 3)).astype(np.float32)
    ts8 = np.full((G, 8), 0.025, np.float32)
    mask = np.ones(8 * G, bool)
    mask[-8:] = False
    out_j = jround_g(
        src, norms, None, tgt, None, np.float32(0.0), np.float32(0.5), R,
        (centers, spans), t8, ts8, mask, h=0, lookup="nearest",
        backend="screen", tile=128, tgt_tile=256, refine_k=3,
        icp_params=JIcpParams(max_iter=32, rel_tol=1e-4), icp_backend="exact",
        refine_gate=np.float32(1.5),
    )
    out_t = se3_round_grouped(
        _t(src), _t(norms), _t(tgt), 0.0, 0.5, _t(R), (_t(centers), _t(spans)),
        _t(t8), _t(ts8), _t(mask), h=0, backend="screen", refine_k=3,
        icp_params=IcpParams(max_iter=32, rel_tol=1e-4), refine_gate=1.5,
    )
    _agree_round(out_j, out_t)


PARITY = dict(mse_threshold=1e-4, bound_backend="mxu", screen=True, se3_pop=64,
              init_multistart=8, refine_top_k=2, max_rounds=30)


@pytest.mark.parametrize("rotation_param", ["axis_angle", "quaternion"])
def test_whole_solve_parity_with_jax(clouds, rotation_param):
    src, tgt, _, _ = clouds
    kw = dict(PARITY, rotation_param=rotation_param)
    rj = jregister(src, tgt, JBnbParams(**kw))
    rt = register(src, tgt, BnbParams.from_dict(dataclasses.asdict(JBnbParams(**kw))),
                  device="cpu")
    assert rj.rounds == rt.rounds == 30
    assert rt.converged == rj.converged
    # the initial ICP missed the threshold: the BnB really ran
    assert rt.rot_nodes > 1000 and rt.sse > PARITY["mse_threshold"] * 100
    assert rt.rot_nodes == rj.rot_nodes
    assert rt.icp_iters == rj.icp_iters
    np.testing.assert_allclose(rt.transform.R, np.asarray(rj.transform.R), atol=1e-4)
    np.testing.assert_allclose(rt.transform.t, np.asarray(rj.transform.t), atol=1e-4)
    np.testing.assert_allclose(rt.sse, rj.sse, rtol=1e-5)
    np.testing.assert_allclose(rt.gap, rj.gap, rtol=1e-5, atol=1e-7)


def test_params_from_dict_round_trips():
    jp = JBnbParams(mse_threshold=2e-4, trans_center=(0.1, 0.0, -0.1), se3_pop=32)
    p = BnbParams.from_dict(dataclasses.asdict(jp))
    assert dataclasses.asdict(p) == dataclasses.asdict(jp)
    with pytest.raises(TypeError):
        BnbParams.from_dict({"no_such_field": 1})


@pytest.mark.parametrize("kw", [
    dict(trim_fraction=0.1),
    dict(engine="nested"),
    dict(icp_metric="plane"),
    dict(bound_backend="grid"),
    dict(bound_backend="exact"),
    dict(bound_backend="mxu", screen=False),
    dict(mesh_cubes=2),
    dict(checkpoint_path="ck.npz"),
    dict(mxu_max=50),
    dict(icp_exact_max=50),
])
def test_out_of_slice_options_raise(clouds, kw, tmp_path):
    """No option is outside the port any more: device meshes on the SE(3)
    engine (here 2 CPU shards), the trimmed path, unscreened R-rounds (K4),
    the plane metric, the exact and grid bound backends, targets above
    ``mxu_max``/``icp_exact_max``, the nested engine and checkpoints all
    solve on the CPU path (on a 32³ grid where one is built; the checkpoint
    is written)."""
    src, tgt, _, _ = clouds
    if "checkpoint_path" in kw:
        kw = dict(kw, checkpoint_path=str(tmp_path / kw["checkpoint_path"]),
                  checkpoint_every=1)
    res = register(src, tgt, BnbParams(mse_threshold=1e-5, max_rounds=3, se3_pop=64,
                                       grid_resolution=32, rot_pop=4, inner_levels=3, **kw),
                   device="cpu")
    assert res.rounds > 0 and np.isfinite(res.sse) and res.rot_nodes > 0
    if "checkpoint_path" in kw:
        assert os.path.exists(kw["checkpoint_path"])


def test_default_device_is_cuda(clouds, monkeypatch):
    src, tgt, _, _ = clouds
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        register(src, tgt, BnbParams(max_rounds=1))


# The grid bound step and the evaluator's host API (bnb/bounds.py:63-190),
# and the core cube types.  Tolerance: the step sums in ATen's order, as the
# mesh's sharded step does: rtol 1e-5 + atol 1e-5 (tests/test_torch_dist.py).
_COVER = np.array([[1.5, 1.5, 1.5], [-1.5, -1.5, -1.5]])


@pytest.fixture(scope="module")
def bound_setup():
    """tests/test_bnb.py's clouds and grid, in both packages."""
    from goicp_tpu.bnb import BoundsEvaluator as JEv
    from goicp_tpu.nn.grid import build_distance_grid as jbuild
    from goicp_tpu_torch.bnb import BoundsEvaluator
    from goicp_tpu_torch.nn.grid import build_distance_grid

    rng = np.random.default_rng(7)
    src = (rng.random((150, 3)).astype(np.float32) - 0.5) * 0.6
    tgt = (rng.random((180, 3)).astype(np.float32) - 0.5) * 0.6
    jgrid = jbuild(tgt, n=96, cover=_COVER)
    grid = build_distance_grid(tgt, n=96, cover=_COVER, device="cpu")
    return dict(src=src, tgt=tgt, jgrid=jgrid, grid=grid, JEv=JEv, Ev=BoundsEvaluator)


def _bound_jobs(rng, B):
    """B quaternion cubes inside the unit ball and translation cubes:
    ``(q_c, q_s, R, angle bound, t_c, t_s, rot_flag)``."""
    from goicp_tpu_torch.geo import rotation as trot

    q_c = (rng.random((B, 3)).astype(np.float32) - 0.5) * 1.2
    q_s = rng.random(B).astype(np.float32) * 0.2 + 0.02
    nrm = np.linalg.norm(q_c, axis=1, keepdims=True)
    q_c = np.where(nrm > 0.9, q_c * 0.9 / nrm, q_c).astype(np.float32)
    R = trot.quat_cube_rotation(torch.from_numpy(q_c)).numpy()
    ang = trot.quat_cube_max_angle(torch.from_numpy(q_c), torch.from_numpy(q_s)).numpy()
    t_c = (rng.random((B, 3)).astype(np.float32) - 0.5) * 0.4
    t_s = rng.random(B).astype(np.float32) * 0.15 + 0.02
    flag = (rng.random(B) > 0.5).astype(np.float32)
    return q_c, q_s, R, ang, t_c, t_s, flag


def _close_inf(got, ref):
    got, ref = np.asarray(got), np.asarray(ref)
    fin = np.isfinite(ref)
    assert (fin == np.isfinite(got)).all()
    np.testing.assert_allclose(got[fin], ref[fin], rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("lookup", ["nearest", "trilinear"])
@pytest.mark.parametrize("h", [150, 120, 40])
def test_bounds_step_matches_jax(bound_setup, lookup, h):
    """Untrimmed (h = N), trimmed by dropping the 30 largest terms, and by
    keeping the 40 smallest (the other branch of the trimmed row sum)."""
    import jax.numpy as jnp

    from goicp_tpu.bnb.bounds import bounds_step as jstep
    from goicp_tpu_torch.bnb.bounds import bounds_step

    s = bound_setup
    rng = np.random.default_rng(60)
    B = 16
    _, _, R, ang, t_c, t_s, flag = _bound_jobs(rng, B)
    mask = np.ones(B, bool)
    mask[-2:] = False
    norms = np.linalg.norm(s["src"], axis=1).astype(np.float32)
    slack = 0.01
    ref = jstep(jnp.asarray(s["src"]), jnp.asarray(norms), s["jgrid"], jnp.float32(slack),
                *(jnp.asarray(x) for x in (R, ang, t_c, t_s, flag, mask)), h=h, lookup=lookup)
    got = bounds_step(torch.from_numpy(s["src"]), torch.from_numpy(norms), s["grid"], slack,
                      *(torch.from_numpy(x) for x in (R, ang, t_c, t_s, flag, mask)),
                      h=h, lookup=lookup)
    for g, r in zip(got, ref):
        _close_inf(g.numpy(), r)


@pytest.mark.parametrize("trim", [0.0, 0.2])
def test_bounds_evaluator_matches_jax_and_brackets_true_sse(bound_setup, trim):
    """tests/test_bnb.py:60,92 on the port's evaluator: the center value at
    flag 0 bounds the true (trimmed) SSE at the center from above, the node
    lb bounds it from below anywhere in the cube; both within tolerance of
    the JAX evaluator's, and ``sse_at`` is the center value at flag 0."""
    s = bound_setup
    ev = s["Ev"](torch.from_numpy(s["src"]), s["grid"], trim_fraction=trim,
                 lookup="trilinear", conservative=True)
    jev = s["JEv"](s["src"], s["jgrid"], trim_fraction=trim, lookup="trilinear",
                   conservative=True)
    assert ev.h == jev.h and ev.slack == pytest.approx(jev.slack, rel=1e-12)
    rng = np.random.default_rng(61)
    B = 16
    q_c, q_s, R, ang, t_c, t_s, _ = _bound_jobs(rng, B)
    zeros, ones = np.zeros(B, np.float32), np.ones(B, bool)
    ub_cv, _ = ev.evaluate(R, zeros, t_c, zeros, zeros, ones)
    _, node_lb = ev.evaluate(R, ang, t_c, t_s, np.ones(B, np.float32), ones)
    assert isinstance(ub_cv, np.ndarray) and ub_cv.shape == (B,)
    _close_inf(ub_cv, jev.evaluate(R, zeros, t_c, zeros, zeros, ones)[0])
    _close_inf(node_lb, jev.evaluate(R, ang, t_c, t_s, np.ones(B, np.float32), ones)[1])
    np.testing.assert_array_equal(ev.sse_at(R, t_c), ub_cv)

    from goicp_tpu_torch.geo.rotation import quat_cube_rotation

    def true_sse(Rm, t):
        pts = s["src"].astype(np.float64) @ np.asarray(Rm, np.float64).T + t
        d2 = ((pts[:, None] - s["tgt"][None]) ** 2).sum(-1).min(1)
        return float(np.sort(d2)[:ev.h].sum())

    for b in range(B):
        assert ub_cv[b] >= true_sse(R[b], t_c[b]) - 1e-4, b
        for _ in range(5):
            qi = (q_c[b] + (rng.random(3) - 0.5) * 2 * q_s[b]).astype(np.float32)
            if np.linalg.norm(qi) > 1.0:
                continue
            Ri = quat_cube_rotation(torch.from_numpy(qi[None]))[0].numpy()
            dt = ((rng.random(3) - 0.5) * 2 * t_s[b]).astype(np.float32)
            assert node_lb[b] <= true_sse(Ri, t_c[b] + dt) + 1e-4, b


def test_bounds_evaluator_without_grid_refuses_evaluate():
    from goicp_tpu_torch.bnb import BoundsEvaluator

    ev = BoundsEvaluator(torch.zeros((4, 3)))
    with pytest.raises(ValueError, match="grid"):
        ev.sse_at(np.eye(3)[None], np.zeros((1, 3)))


def test_cube_batch_and_bounds_match_jax():
    from goicp_tpu.core import Bounds as JBounds
    from goicp_tpu.core import CubeBatch as JCubeBatch
    from goicp_tpu_torch.core import Bounds, CubeBatch

    jr, r = JCubeBatch.root(span=np.pi, ub=7.0), CubeBatch.root(span=np.pi, ub=7.0)
    assert r.size == jr.size == 1
    for _ in range(2):
        jr, r = jr.subdivide(), r.subdivide()
    rng = np.random.default_rng(62)
    c = rng.uniform(-1, 1, (5, 3)).astype(np.float32)
    s = rng.uniform(0.1, 0.5, 5).astype(np.float32)
    lb, ub = rng.random(5).astype(np.float32), rng.random(5).astype(np.float32) + 1
    mask = np.array([True, False, True, True, False])
    jb = JCubeBatch(c, s, lb, ub, mask).subdivide()
    tb = CubeBatch(*(torch.from_numpy(x) for x in (c, s, lb, ub, mask))).subdivide()
    for got, ref in ((r, jr), (tb, jb)):
        assert got.size == ref.size
        for f in ("center", "span", "lb", "ub", "mask"):
            g, e = getattr(got, f).numpy(), np.asarray(getattr(ref, f))
            assert g.dtype == e.dtype and np.array_equal(g, e), f
    b = Bounds(lb=torch.from_numpy(lb), ub=torch.from_numpy(ub))
    jb2 = JBounds(lb=lb, ub=ub)
    assert np.array_equal(b.lb.numpy(), np.asarray(jb2.lb))
