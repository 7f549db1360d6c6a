"""The port's SE(3) rounds and whole solve against the JAX package on the
same numpy inputs.

Parity protocol of the whole solve: 100 points uniform in [−0.3, 0.3]³ from
``default_rng(11)``, target = R·src + t + N(0, 0.01), both packages pinned to
``bound_backend="mxu", screen=True`` (JAX on the CPU would otherwise pick
its exact backend).  The initial ICP misses the threshold, so the BnB runs.
"""

import dataclasses

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
def test_out_of_slice_options_raise(clouds, kw):
    """Options outside the port raise, naming the ROADMAP item.  The trimmed
    path and unscreened R-rounds (K4) are in the port now: those two cases
    must solve on the CPU path instead."""
    src, tgt, _, _ = clouds
    if kw in IN_SLICE:
        res = register(src, tgt, BnbParams(mse_threshold=1e-5, max_rounds=3, se3_pop=64, **kw),
                       device="cpu")
        assert res.rounds > 0 and np.isfinite(res.sse) and res.rot_nodes > 0
        return
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        register(src, tgt, BnbParams(**kw), device="cpu")


IN_SLICE = (dict(trim_fraction=0.1), dict(bound_backend="mxu", screen=False))


def test_default_device_is_cuda(clouds, monkeypatch):
    src, tgt, _, _ = clouds
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        register(src, tgt, BnbParams(max_rounds=1))
