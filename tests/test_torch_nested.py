"""The port's nested engine (``bnb/device_inner.py``, ``bnb/nested.py``)
against the JAX package on the same numpy inputs.

Tolerances:
- ``inner_bnb_device`` on the exact expansion and both grid lookups,
  trimmed and untrimmed: every output bit-equal, node counts equal.  A
  trimmed lb is a sum minus its dropped top terms and near 0 it is f32
  cancellation noise, so this needs every term rounded as the jitted JAX
  function rounds it: correctly rounded roots (``fused.sqrt_rn``) and,
  with one point tile, the top-k's γt contracted into a fused
  multiply-add, as XLA's CPU build contracts it there.
- Whole solves, untrimmed and trimmed: rounds, rot/trans nodes and ICP
  iterations equal, pose to 1e-4, sse to rtol 1e-5.  The two nested cases
  of ``tests/test_bnb.py`` end in the multistart ICP of a noise-free pair
  (sse ~1e-12, f32 rounding): their ICP iterations may differ by one.
"""

import dataclasses

import numpy as np
import pytest

pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from goicp_tpu.bnb import BnbParams as JBnbParams  # noqa: E402
from goicp_tpu.bnb import register as jregister  # noqa: E402
from goicp_tpu.bnb.device_inner import inner_bnb_device as jinner  # noqa: E402
from goicp_tpu.nn import grid as jgrid  # noqa: E402
from goicp_tpu_torch import BnbParams, register  # noqa: E402
from goicp_tpu_torch.bnb import device_inner  # noqa: E402
from goicp_tpu_torch.bnb.device_inner import inner_bnb_device  # noqa: E402
from goicp_tpu_torch.bnb.nested import GoIcpSolverNested  # noqa: E402
from goicp_tpu_torch.bnb.solver import make_solver  # noqa: E402
from goicp_tpu_torch.geo.rotation import axis_angle_rotation, random_rotations  # noqa: E402
from goicp_tpu_torch.nn import grid as tgrid  # noqa: E402
from tests.conftest import random_rotation  # noqa: E402

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def inner_case():
    rng = np.random.default_rng(0)
    N, G = 150, 8
    src = rng.uniform(-0.3, 0.3, (N, 3)).astype(np.float32)
    Rt = random_rotations(1, rng)[0]
    tgt = (src @ Rt.T + np.float32([0.05, -0.02, 0.03])
           + rng.normal(0, 0.01, (N, 3))).astype(np.float32)
    norms = np.linalg.norm(src, axis=1).astype(np.float32)
    R = random_rotations(G, rng)
    R[0] = Rt                                  # one cube at the true rotation
    ang = rng.uniform(0.05, 0.3, G).astype(np.float32)
    cap_ub = np.full(G, 2.0, np.float32)
    cap_lb = np.full(G, 1.0, np.float32)
    cap_ub[-1] = cap_lb[-1] = -np.inf          # a padding row: pruned after one level
    J = jgrid.build_distance_grid(tgt, n=32, method="edt")
    T = tgrid.build_distance_grid(torch.from_numpy(tgt), n=32, method="edt")
    scalars = (np.float32(0.001), np.float32(0.5), np.float32(1e-3), np.float32(0.0))
    return src, tgt, norms, R, ang, cap_ub, cap_lb, J, T, scalars


@pytest.mark.parametrize("h", [0, 120], ids=["untrimmed", "trimmed"])
@pytest.mark.parametrize("backend,lookup", [("exact", "nearest"), ("grid", "nearest"),
                                            ("grid", "trilinear")])
def test_inner_bnb_device_matches_jax(inner_case, backend, lookup, h):
    src, tgt, norms, R, ang, cap_ub, cap_lb, J, T, (slack, span, thr, floor) = inner_case
    kw = dict(levels=4, C=16, h=h, lookup=lookup, tile=64, backend=backend)
    oj = jinner(jnp.asarray(src), jnp.asarray(norms), J, jnp.asarray(tgt), slack,
                jnp.asarray(R), jnp.asarray(ang), jnp.asarray(cap_ub), jnp.asarray(cap_lb),
                jnp.zeros(3, jnp.float32), span, thr, floor, **kw)
    ot = inner_bnb_device(
        *(torch.from_numpy(x) for x in (src, norms)), T, torch.from_numpy(tgt), float(slack),
        *(torch.from_numpy(x) for x in (R, ang, cap_ub, cap_lb)), torch.zeros(3),
        float(span), float(thr), float(floor), **kw)
    inc_ub, inc_lb, best_t, unres_ub, unres_lb = (x.numpy() for x in ot[:5])
    j_ub, j_lb, j_t, j_uub, j_ulb = (np.asarray(x) for x in oj[:5])
    assert ot[5] == int(oj[5]) and ot[5] > 300
    for a, b in ((inc_ub, j_ub), (inc_lb, j_lb), (best_t, j_t), (unres_ub, j_uub),
                 (unres_lb, j_ulb)):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("backend,lookup", [("grid", "nearest"), ("exact", "nearest"),
                                            ("grid", "trilinear")])
def test_inner_lb_terms_round_as_jitted_jax(backend, lookup, monkeypatch):
    """Term by term where trimmed lbs cancel: 64 rotation cubes near the
    truth at one small translation cube, one point tile (N ≤ ``tile``), the
    cube kept by ``min_span`` so that ``unres_*`` read its lbs.  Every
    output equals the jitted JAX one.  Subtracting γt = √3·span plainly
    where the lb terms feed the top-k (the port's form before, which XLA
    contracts there into a fused multiply-add) moves some lbs, and so does
    ATen's CPU root where the distance is not a grid value."""
    rng = np.random.default_rng(11)
    N, G, drop = 100, 64, 10
    src = rng.uniform(-0.3, 0.3, (N, 3)).astype(np.float32)
    R0 = random_rotations(1, rng)[0]
    tgt = (src @ R0.T + np.float32([0.05, -0.02, 0.03])
           + rng.normal(0, 0.01, (N, 3))).astype(np.float32)
    norms = np.linalg.norm(src, axis=1).astype(np.float32)
    J = jgrid.build_distance_grid(tgt, n=32, method="edt")
    T = tgrid.build_distance_grid(torch.from_numpy(tgt), n=32, method="edt")
    aa = torch.from_numpy(rng.normal(0, 0.05, (G, 3)).astype(np.float32))
    R = (axis_angle_rotation(aa).numpy() @ R0).astype(np.float32)
    ang = rng.uniform(0.0, 0.05, G).astype(np.float32)
    cap = np.full(G, np.inf, np.float32)
    cen, span = np.float32([0.05, -0.02, 0.03]), np.float32(0.01)
    kw = dict(levels=1, C=8, h=N - drop, lookup=lookup, tile=128, backend=backend)
    want = [np.asarray(x) for x in jinner(
        jnp.asarray(src), jnp.asarray(norms), J, jnp.asarray(tgt), np.float32(0.001),
        jnp.asarray(R), jnp.asarray(ang), jnp.asarray(cap), jnp.asarray(cap), jnp.asarray(cen),
        span, np.float32(1e-3), span, **kw)[:5]]

    def differ():
        got = inner_bnb_device(
            torch.from_numpy(src), torch.from_numpy(norms), T, torch.from_numpy(tgt), 0.001,
            *(torch.from_numpy(x) for x in (R, ang, cap, cap, cen)), float(span), 1e-3,
            float(span), **kw)
        return [int((w != g.numpy()).sum()) for w, g in zip(want, got[:5])]

    assert differ() == [0] * 5
    assert np.isfinite(want[3]).all() and np.isfinite(want[4]).all()
    with monkeypatch.context() as mp:
        mp.setattr(device_inner, "fma", lambda a, b, c: a * b + c)
        assert sum(differ()[3:]) > 0
    if (backend, lookup) != ("grid", "nearest"):
        monkeypatch.setattr(device_inner, "sqrt_rn", torch.sqrt)
        assert sum(differ()) > 0


@pytest.fixture(scope="module")
def noise_free():
    rng = np.random.default_rng(21)
    src = (rng.random((200, 3)).astype(np.float32) - 0.5) * 0.6
    R_true = random_rotation(rng)
    tgt = (src @ R_true.T + np.array([0.08, -0.06, 0.1], np.float32)).astype(np.float32)
    return src, tgt


def _solve_both(src, tgt, jp):
    rj = jregister(src, tgt, jp)
    rt = register(src, tgt, BnbParams.from_dict(dataclasses.asdict(jp)), device="cpu")
    np.testing.assert_allclose(rt.transform.R, np.asarray(rj.transform.R), atol=1e-4)
    np.testing.assert_allclose(rt.transform.t, np.asarray(rj.transform.t), atol=1e-4)
    return rj, rt


def test_nested_engine_recovers_as_jax(noise_free):
    """``tests/test_bnb.py``'s nested case: the multistart lands in the
    optimum's basin, and both packages certify it alike."""
    src, tgt = noise_free
    jp = JBnbParams(mse_threshold=1e-5, engine="nested", rot_pop=2, inner_cap=16,
                    inner_levels=8, max_rounds=40, bound_backend="exact")
    rj, rt = _solve_both(src, tgt, jp)
    assert (rt.rounds, rt.rot_nodes, rt.trans_nodes) == (rj.rounds, rj.rot_nodes, rj.trans_nodes)
    assert abs(rt.icp_iters - rj.icp_iters) <= 1 and rt.converged == rj.converged
    pts = src @ rt.transform.R.T + rt.transform.t
    assert float(np.sqrt(np.mean(np.sum((pts - tgt) ** 2, axis=1)))) < 2e-3


def test_engines_agree_on_pose_as_jax(noise_free):
    """``tests/test_bnb.py``'s engine comparison: the SE(3) and the nested
    engine reach the same pose, in both packages."""
    src, tgt = noise_free
    ra = register(src, tgt, BnbParams(mse_threshold=1e-5, engine="se3", se3_pop=64,
                                      max_rounds=80, bound_backend="exact"), device="cpu")
    jp = JBnbParams(mse_threshold=1e-5, engine="nested", rot_pop=2, inner_cap=16,
                    inner_levels=8, max_rounds=40, bound_backend="exact")
    rj, rb = _solve_both(src, tgt, jp)
    assert (rb.rounds, rb.rot_nodes, rb.trans_nodes) == (rj.rounds, rj.rot_nodes, rj.trans_nodes)
    assert np.allclose(ra.transform.R, rb.transform.R, atol=2e-3)
    assert np.allclose(ra.transform.t, rb.transform.t, atol=2e-3)
    assert abs(ra.mse - rb.mse) < 1e-6


@pytest.fixture(scope="module")
def noisy():
    rng = np.random.default_rng(11)
    src = rng.uniform(-0.3, 0.3, (100, 3)).astype(np.float32)
    R = random_rotations(1, np.random.default_rng(5))[0]
    tgt = (src @ R.T + np.float32([0.05, -0.02, 0.03])
           + rng.normal(0, 0.01, (100, 3))).astype(np.float32)
    return src, tgt


NOISY = dict(mse_threshold=1e-4, engine="nested", rot_pop=4, inner_cap=16, inner_levels=5,
             max_rounds=8, init_multistart=8, refine_top_k=2)


@pytest.mark.parametrize("kw", [dict(bound_backend="exact"),
                                dict(bound_backend="grid", grid_resolution=32, lookup="nearest"),
                                dict(bound_backend="grid", grid_resolution=32)],
                         ids=["exact", "grid-nearest", "grid-trilinear"])
def test_nested_solve_matches_jax(noisy, kw):
    """A noisy pair whose multistart misses the threshold, so 8 outer rounds
    run: every count equal."""
    src, tgt = noisy
    rj, rt = _solve_both(src, tgt, JBnbParams(**NOISY, **kw))
    assert rt.rounds == rj.rounds == 8
    assert (rt.rot_nodes, rt.trans_nodes, rt.icp_iters) == (rj.rot_nodes, rj.trans_nodes,
                                                            rj.icp_iters)
    assert rt.trans_nodes > 10000 and rt.converged == rj.converged
    np.testing.assert_allclose(rt.sse, rj.sse, rtol=1e-5)
    np.testing.assert_allclose(rt.gap, rj.gap, rtol=1e-5)


def _trimmed_solves_agree(rj, rt):
    assert rt.rounds == rj.rounds == 8
    assert (rt.rot_nodes, rt.trans_nodes, rt.icp_iters) == (rj.rot_nodes, rj.trans_nodes,
                                                            rj.icp_iters)
    assert rt.trans_nodes > 5000
    np.testing.assert_allclose(rt.sse, rj.sse, rtol=1e-5)


def test_trimmed_nested_solve_close_to_jax(noisy):
    """Trimmed on the nearest grid lookup: every count equal."""
    src, tgt = noisy
    _trimmed_solves_agree(*_solve_both(src, tgt, JBnbParams(
        **NOISY, bound_backend="grid", grid_resolution=32, lookup="nearest",
        trim_fraction=0.1)))


def test_trimmed_nested_solve_exact_matches_jax(noisy):
    """Trimmed on the exact expansion: every count equal."""
    src, tgt = noisy
    _trimmed_solves_agree(*_solve_both(src, tgt, JBnbParams(
        **NOISY, bound_backend="exact", trim_fraction=0.1)))


def test_mxu_and_screen_run_the_exact_expansion(noisy, monkeypatch):
    """"mxu"/"screen" have no nested path: the engine runs the exact
    expansion, as the JAX package does, and launches nothing; meshes only
    warn."""
    src, tgt = noisy
    p = BnbParams(**{**NOISY, "max_rounds": 2}, bound_backend="mxu", mesh_cubes=2)
    s = make_solver(src, tgt, p, device="cpu")
    assert isinstance(s, GoIcpSolverNested) and s.grid is None
    warned = []
    monkeypatch.setattr(s.log, "warning", lambda msg, *a: warned.append(msg % a))
    a = s.run()
    b = register(src, tgt, dataclasses.replace(p, bound_backend="exact", mesh_cubes=0),
                 device="cpu")
    assert (a.rot_nodes, a.trans_nodes, a.rounds) == (b.rot_nodes, b.trans_nodes, b.rounds)
    assert any("single-device" in w for w in warned)
