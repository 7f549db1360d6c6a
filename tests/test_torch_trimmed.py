"""The port's trimmed (partial-overlap) path against the JAX package on the
same numpy inputs: the new ``pack_*`` functions, the plain versions of K4
(``min_d2_nodes``), K5 (``bounds_nodes_trimmed``), K6
(``bounds_groups_trimmed``) and K7 (``bounds_groups``) against the Pallas
kernels in interpret mode, the bisection epilogue, trimmed ICP, trimmed
rounds on both backends, and whole solves.

Tolerances: packs bit-identical; K4 distances to rtol 1e-5 + atol 1e-7
(XLA's CPU build of the interpreted kernel rounds some products and sums
differently: 1-ulp differences in the coordinates, in about half the
entries, so K4 is also held bit-equal to a numpy float32 evaluation of the
same formula); bounds and sums rtol 1e-5
+ atol 1e-5, with the screened sets equal.  Whole solves: rounds, node
counts, ICP iterations, converged and gap equal, sse to rtol 1e-5.

Whole-solve protocol: the 100-point clouds of ``tests/test_torch_bnb.py``
with 15 target points replaced by uniform outliers, ``trim_fraction=0.15``
(or untrimmed with ``screen=False``), 30 rounds.
"""

import dataclasses

import numpy as np
import pytest

pytest.importorskip("jax")

import torch  # noqa: E402

from goicp_tpu.bnb import BnbParams as JBnbParams  # noqa: E402
from goicp_tpu.bnb import make_solver as jmake_solver  # noqa: E402
from goicp_tpu.bnb import register as jregister  # noqa: E402
from goicp_tpu.bnb.se3_eval import _trimmed_sum_bisect as jbisect  # noqa: E402
from goicp_tpu.bnb.se3_eval import se3_round as jround  # noqa: E402
from goicp_tpu.bnb.se3_eval import se3_round_grouped as jround_g  # noqa: E402
from goicp_tpu.core.types import RigidTransform as JRT  # noqa: E402
from goicp_tpu.icp import IcpParams as JIcpParams  # noqa: E402
from goicp_tpu.icp import exact_correspondence as jcorr  # noqa: E402
from goicp_tpu.icp import run_icp as jrun  # noqa: E402
from goicp_tpu.icp import trim_weights as jtrim_weights  # noqa: E402
from goicp_tpu.nn import mxu  # noqa: E402
from goicp_tpu_torch import BnbParams, make_solver, register  # noqa: E402
from goicp_tpu_torch.bnb.se3_eval import _trimmed_sum_bisect  # noqa: E402
from goicp_tpu_torch.bnb.se3_eval import se3_round, se3_round_grouped  # noqa: E402
from goicp_tpu_torch.core.types import RigidTransform  # noqa: E402
from goicp_tpu_torch.geo.rotation import random_rotations  # noqa: E402
from goicp_tpu_torch.icp import IcpParams, exact_correspondence, run_icp, trim_weights  # noqa: E402
from goicp_tpu_torch.nn import fused  # noqa: E402

torch.set_num_threads(1)

N, NT, B, G = 300, 700, 12, 4
H = int(round(0.85 * N))
DROP = N - H


def _np(x):
    return np.array(x)  # a writable copy for torch.from_numpy


def _t(x):
    return torch.from_numpy(_np(x))


@pytest.fixture(scope="module")
def scene():
    """Clouds in [−0.3, 0.3]³; a third of the nodes and half of the groups
    sit 1.0 away, so the screened kernels have nodes to screen."""
    rng = np.random.default_rng(77)
    src = rng.uniform(-0.3, 0.3, (N, 3)).astype(np.float32)
    tgt = rng.uniform(-0.3, 0.3, (NT, 3)).astype(np.float32)
    R = random_rotations(B, rng)
    t = rng.uniform(-0.15, 0.15, (B, 3)).astype(np.float32)
    t[::3, 0] += 1.0
    Rg = random_rotations(G, rng)
    t8 = rng.uniform(-0.15, 0.15, (G, 8, 3)).astype(np.float32)
    t8[::2, :, 0] += 1.0
    return dict(
        src=src, tgt=tgt, R=R, t=t, Rg=Rg, t8=t8,
        norms=np.linalg.norm(src, axis=1).astype(np.float32),
        af=rng.uniform(0.0, 0.3, B).astype(np.float32),
        gt=rng.uniform(0.0, 0.05, B).astype(np.float32),
        afg=rng.uniform(0.0, 0.3, G).astype(np.float32),
        gt8=rng.uniform(0.0, 0.05, (G, 8)).astype(np.float32),
    )


def _levels(lb_open):
    """(thresh, thresh', τ) of the trimmed screen for thresh = half the
    median positive lb, in f32 as the JAX package computes them."""
    lb = np.asarray(lb_open)
    thresh = np.float32(0.5 * np.median(lb[lb > 0]))
    tau = np.float32(2.0) * thresh / np.float32(H)
    return thresh, thresh + np.float32(DROP) * tau, tau


def _agree(ub_j, lb_j, ub_t, lb_t, screen):
    ub_j, lb_j = _np(ub_j), _np(lb_j)
    ub_t, lb_t = ub_t.numpy(), lb_t.numpy()
    scr = ub_j >= 1e29
    assert np.array_equal(scr, ub_t >= 1e29)
    if screen:
        assert scr.any() and not scr.all()
    else:
        assert not scr.any()
    np.testing.assert_allclose(lb_t, lb_j, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(ub_t, ub_j, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("which", ["nodes_trimmed", "groups", "groups_trimmed"])
def test_pack_functions_bit_identical(scene, which):
    s = scene
    if which == "nodes_trimmed":
        args = (s["R"], s["t"], s["af"], s["gt"], 0.01, np.float32(0.7), np.float32(0.003))
        ref = mxu.pack_params_bounds_trimmed(*args)
        got = fused.pack_params_bounds_trimmed(*args)
    elif which == "groups":
        args = (s["Rg"], s["t8"], s["afg"], s["gt8"], 0.01, 0.7)
        ref = mxu.pack_group_params_bounds(*args)
        got = fused.pack_group_params_bounds(*args)
    else:
        args = (s["Rg"], s["t8"], s["afg"], s["gt8"], 0.01, np.float32(0.7), np.float32(0.002))
        ref = mxu.pack_group_params_bounds_trimmed(*args)
        got = fused.pack_group_params_bounds_trimmed(*args)
    ref, got = _np(ref), got.numpy()
    assert ref.dtype == got.dtype and ref.shape == got.shape
    assert np.array_equal(ref.view(np.uint32), got.view(np.uint32))


def test_min_d2_nodes_k4_plain_matches_jax(scene):
    s = scene
    srcT, wm = mxu.pack_sources(s["src"]), mxu.pack_targets(s["tgt"])
    P = mxu.pack_params(s["R"], s["t"])
    ref = _np(mxu.min_d2_nodes(srcT, wm, P, interpret=True))
    got = fused.min_d2_nodes(_t(srcT), _t(wm), _t(P)).numpy()
    assert got.shape == ref.shape == (B, srcT.shape[1])
    np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-7)
    # bit-equal to one f32 rounding per operation, in the kernels' order
    f = np.float32
    q = [((s["src"][:, 0] * s["R"][:, r, 0:1] + s["src"][:, 1] * s["R"][:, r, 1:2])
          + s["src"][:, 2] * s["R"][:, r, 2:3]) + s["t"][:, r:r + 1] for r in range(3)]
    d = [s["tgt"][None, None, :, k] - q[k][:, :, None] for k in range(3)]
    d2 = ((d[0] * d[0] + d[1] * d[1]) + d[2] * d[2]).min(-1).astype(f)
    assert np.array_equal(got[:, :N], np.maximum(d2, f(0)))


@pytest.mark.parametrize("screen", [False, True])
def test_bounds_nodes_trimmed_k5_plain_matches_jax(scene, screen):
    s = scene
    srcT = mxu.pack_sources_ext(s["src"], s["norms"])
    wm = mxu.pack_targets(s["tgt"])
    te, tau = np.float32(1e30), np.float32(1e30)
    if screen:
        p_open = mxu.pack_params_bounds_trimmed(s["R"], s["t"], s["af"], s["gt"], 0.0, te, tau)
        _, te, tau = _levels(mxu.bounds_nodes_trimmed(srcT, wm, p_open, h=H, drop=DROP,
                                                       interpret=True)[1])
    pj = mxu.pack_params_bounds_trimmed(s["R"], s["t"], s["af"], s["gt"], 0.0, te, tau)
    ub_j, lb_j = mxu.bounds_nodes_trimmed(srcT, wm, pj, h=H, drop=DROP, interpret=True)
    pt = fused.pack_params_bounds_trimmed(s["R"], s["t"], s["af"], s["gt"], 0.0, te, tau)
    ub_t, lb_t = fused.bounds_nodes_trimmed(_t(srcT), _t(wm), pt, h=H, drop=DROP)
    _agree(ub_j, lb_j, ub_t, lb_t, screen)


@pytest.mark.parametrize("screen", [False, True])
def test_bounds_groups_trimmed_k6_plain_matches_jax(scene, screen):
    s = scene
    srcT = mxu.pack_sources_ext(s["src"], s["norms"])
    wm = mxu.pack_targets(s["tgt"])
    args = (s["Rg"], s["t8"], s["afg"], s["gt8"], 0.0)
    te, tau = np.float32(1e30), np.float32(1e30)
    if screen:
        p_open = mxu.pack_group_params_bounds_trimmed(*args, te, tau)
        _, te, tau = _levels(mxu.bounds_groups_trimmed(srcT, wm, p_open, h=H, drop=DROP,
                                                        interpret=True)[1])
    pj = mxu.pack_group_params_bounds_trimmed(*args, te, tau)
    ub_j, lb_j = mxu.bounds_groups_trimmed(srcT, wm, pj, h=H, drop=DROP, interpret=True)
    ub_t, lb_t = fused.bounds_groups_trimmed(
        _t(srcT), _t(wm), fused.pack_group_params_bounds_trimmed(*args, te, tau),
        h=H, drop=DROP)
    _agree(ub_j, lb_j, ub_t, lb_t, screen)


@pytest.mark.parametrize("screen", [False, True])
def test_bounds_groups_k7_plain_matches_jax(scene, screen):
    s = scene
    srcT = mxu.pack_sources_ext(s["src"], s["norms"])
    wm = mxu.pack_targets(s["tgt"])
    args = (s["Rg"], s["t8"], s["afg"], s["gt8"], 0.0)
    thresh = 1e30
    if screen:
        _, lb = mxu.bounds_groups(srcT, wm, mxu.pack_group_params_bounds(*args, 1e30),
                                  interpret=True)
        thresh = float(np.median(_np(lb).reshape(G, 8).min(1)))
    ub_j, lb_j = mxu.bounds_groups(srcT, wm, mxu.pack_group_params_bounds(*args, thresh),
                                   interpret=True)
    ub_t, lb_t = fused.bounds_groups(_t(srcT), _t(wm),
                                     fused.pack_group_params_bounds(*args, thresh))
    _agree(ub_j, lb_j, ub_t, lb_t, screen)


@pytest.mark.parametrize("upper", [True, False])
def test_trimmed_sum_bisect_matches_jax(upper):
    rng = np.random.default_rng(8)
    x = (rng.random((6, 256)) ** 3).astype(np.float32)
    x[:, 200:] = 1e30                                  # padding
    x[2, :10] = x[2, 10]                               # ties
    ref = _np(jbisect(x, 150, upper))
    got = _trimmed_sum_bisect(_t(x), 150, upper).numpy()
    np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-7)
    exact = np.sort(x, axis=1)[:, :150].sum(1)
    assert np.all(got >= exact - 1e-4) if upper else np.all(got <= exact + 1e-4)


def test_trim_weights_matches_jax():
    rng = np.random.default_rng(9)
    d2 = rng.random((5, 120)).astype(np.float32)
    d2[1, :30] = d2[1, 40]                             # ties at the threshold
    for tf in (0.1, 0.25, 0.5):
        ref = _np(jtrim_weights(d2, tf))
        got = trim_weights(_t(d2), tf).numpy()
        assert np.array_equal(got, ref)
    assert np.array_equal(trim_weights(_t(d2), 0.001).numpy(), np.ones_like(d2))


@pytest.fixture(scope="module")
def outlier_pair():
    """The 100-point pair of tests/test_torch_bnb.py with 15 target points
    replaced by uniform outliers in [−0.6, 0.6]³."""
    rng = np.random.default_rng(11)
    src = rng.uniform(-0.3, 0.3, (100, 3)).astype(np.float32)
    R = random_rotations(1, np.random.default_rng(5))[0]
    tgt = (src @ R.T + np.float32([0.05, -0.02, 0.03])
           + rng.normal(0, 0.01, (100, 3))).astype(np.float32)
    orng = np.random.default_rng(13)
    tgt[orng.choice(100, 15, replace=False)] = orng.uniform(-0.6, 0.6, (15, 3))
    return src, tgt, R


@pytest.mark.parametrize("max_iter", [32, 0])
def test_run_icp_trimmed_matches_jax(outlier_pair, max_iter):
    src, tgt, R = outlier_pair
    R0 = random_rotations(8, np.random.default_rng(3))
    R0[:2] = R
    t0 = np.random.default_rng(4).normal(0, 0.05, (8, 3)).astype(np.float32)
    kw = dict(max_iter=max_iter, rel_tol=1e-4, trim_fraction=0.15)
    rj = jrun(src, jcorr(tgt), JRT(R0, t0), JIcpParams(**kw))
    rt = run_icp(_t(src), exact_correspondence(_t(tgt)), RigidTransform(_t(R0), _t(t0)),
                 IcpParams(**kw))
    np.testing.assert_allclose(rt.transform.R.numpy(), _np(rj.transform.R), rtol=0, atol=1e-5)
    np.testing.assert_allclose(rt.transform.t.numpy(), _np(rj.transform.t), rtol=0, atol=1e-5)
    np.testing.assert_allclose(rt.sse.numpy(), _np(rj.sse), rtol=1e-5)
    assert np.array_equal(rt.iters.numpy(), _np(rj.iters))


def _round_inputs(outlier_pair, M, seed):
    src, tgt, R_true = outlier_pair
    rng = np.random.default_rng(seed)
    norms = np.linalg.norm(src, axis=1).astype(np.float32)
    centers = rng.uniform(-1.0, 1.0, (M, 3)).astype(np.float32)
    spans = np.full(M, np.pi / 64, np.float32)
    R = random_rotations(M, rng)
    R[0] = R_true                                   # one node near the optimum
    return src, tgt, norms, centers, spans, R


def _agree_round(out_j, out_t):
    ub_j, lb_j, R_j, t_j, sse_j, it_j = (_np(x) for x in out_j)
    ub_t, lb_t, R_t, t_t, sse_t, it_t = (x.numpy() for x in out_t)
    np.testing.assert_array_equal(ub_j >= 1e29, ub_t >= 1e29)
    np.testing.assert_allclose(ub_t, ub_j, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(lb_t, lb_j, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(R_t, R_j, rtol=0, atol=1e-5)
    np.testing.assert_allclose(t_t, t_j, rtol=0, atol=1e-5)
    np.testing.assert_allclose(sse_t, sse_j, rtol=1e-5)
    np.testing.assert_array_equal(it_t, it_j)


H_PAIR = 85          # round(100 · (1 − 0.15))
ICP_KW = dict(max_iter=32, rel_tol=1e-4, trim_fraction=0.15)


@pytest.mark.parametrize("backend", ["mxu", "screen"])
def test_se3_round_trimmed_matches_jax(outlier_pair, backend):
    M = 24
    src, tgt, norms, centers, spans, R = _round_inputs(outlier_pair, M, 3)
    rng = np.random.default_rng(4)
    t_c = rng.uniform(-0.1, 0.1, (M, 3)).astype(np.float32)
    t_c[0] = [0.05, -0.02, 0.03]                    # node 0 at the true pose
    t_c[1::3, 0] += 0.6                             # far nodes: the screen fires
    t_span = np.full(M, 0.005, np.float32)
    mask = np.ones(M, bool)
    mask[-3:] = False
    lb_open = se3_round(
        _t(src), _t(norms), _t(tgt), 0.0, 1e30, _t(R), (_t(centers), _t(spans)),
        _t(t_c), _t(t_span), _t(mask), h=H_PAIR, backend="mxu", refine_k=1,
        icp_params=IcpParams(max_iter=0, trim_fraction=0.15),
    )[1].numpy()[:-3]
    thresh = np.float32(0.5 * np.median(lb_open[lb_open > 0]))
    out_j = jround(
        src, norms, None, tgt, None, np.float32(0.0), thresh, R,
        (centers, spans), t_c, t_span, mask, h=H_PAIR, lookup="nearest",
        backend=backend, tile=128, tgt_tile=256, refine_k=4,
        icp_params=JIcpParams(**ICP_KW), icp_backend="exact",
        refine_gate=np.float32(2.0),
    )
    out_t = se3_round(
        _t(src), _t(norms), _t(tgt), 0.0, thresh, _t(R), (_t(centers), _t(spans)),
        _t(t_c), _t(t_span), _t(mask), h=H_PAIR, backend=backend, refine_k=4,
        icp_params=IcpParams(**ICP_KW), refine_gate=2.0,
    )
    _agree_round(out_j, out_t)
    ub = out_t[0].numpy()[:-3]
    if backend == "screen":
        assert (ub == 1e30).any() and (ub < 1e30).any()
    else:
        assert (ub < 1e30).all()


@pytest.mark.parametrize("backend", ["mxu", "screen"])
def test_se3_round_grouped_trimmed_matches_jax(outlier_pair, backend):
    Gr = 5
    src, tgt, norms, centers, spans, R = _round_inputs(outlier_pair, Gr, 6)
    rng = np.random.default_rng(6)
    t8 = rng.uniform(-0.1, 0.1, (Gr, 8, 3)).astype(np.float32)
    t8[1::2, :, 0] += 0.6                           # far groups: the screen fires
    ts8 = np.full((Gr, 8), 0.0125, np.float32)
    mask = np.ones(8 * Gr, bool)
    mask[-8:] = False
    lb_open = se3_round_grouped(
        _t(src), _t(norms), _t(tgt), 0.0, 1e30, _t(R), (_t(centers), _t(spans)),
        _t(t8), _t(ts8), _t(mask), h=H_PAIR, backend="mxu", refine_k=1,
        icp_params=IcpParams(max_iter=0, trim_fraction=0.15),
    )[1].numpy()[:-8]
    thresh = np.float32(0.5 * np.median(lb_open[lb_open > 0]))
    out_j = jround_g(
        src, norms, None, tgt, None, np.float32(0.0), thresh, R,
        (centers, spans), t8, ts8, mask, h=H_PAIR, lookup="nearest",
        backend=backend, tile=128, tgt_tile=256, refine_k=3,
        icp_params=JIcpParams(**ICP_KW), icp_backend="exact",
        refine_gate=np.float32(1.5),
    )
    out_t = se3_round_grouped(
        _t(src), _t(norms), _t(tgt), 0.0, thresh, _t(R), (_t(centers), _t(spans)),
        _t(t8), _t(ts8), _t(mask), h=H_PAIR, backend=backend, refine_k=3,
        icp_params=IcpParams(**ICP_KW), refine_gate=1.5,
    )
    _agree_round(out_j, out_t)
    ub = out_t[0].numpy()[:-8]
    if backend == "screen":
        assert (ub == 1e30).any() and (ub < 1e30).any()


SOLVE = dict(mse_threshold=1e-4, se3_pop=64, init_multistart=8, refine_top_k=2,
             max_rounds=30)


@pytest.mark.parametrize("kw", [
    dict(trim_fraction=0.15, bound_backend="mxu"),
    dict(trim_fraction=0.15, bound_backend="screen"),
    dict(bound_backend="mxu", screen=False),
], ids=["trimmed-mxu", "trimmed-screen", "untrimmed-unscreened"])
def test_whole_solve_parity_with_jax(outlier_pair, kw):
    src, tgt, _ = outlier_pair
    jp = JBnbParams(**SOLVE, **kw)
    rj = jregister(src, tgt, jp)
    rt = register(src, tgt, BnbParams.from_dict(dataclasses.asdict(jp)), device="cpu")
    assert rj.rounds == rt.rounds == 30
    assert rt.converged == rj.converged
    # the initial ICP missed the threshold: the BnB really ran
    assert rt.rot_nodes > 1000 and rt.mse > SOLVE["mse_threshold"]
    assert rt.rot_nodes == rj.rot_nodes
    assert rt.icp_iters == rj.icp_iters
    np.testing.assert_allclose(rt.transform.R, _np(rj.transform.R), atol=1e-4)
    np.testing.assert_allclose(rt.transform.t, _np(rj.transform.t), atol=1e-4)
    np.testing.assert_allclose(rt.sse, rj.sse, rtol=1e-5)
    np.testing.assert_allclose(rt.gap, rj.gap, rtol=1e-5, atol=1e-7)
    np.testing.assert_allclose(rt.mse, rj.mse, rtol=1e-5)


def test_full_cert_trimmed_reports_no_gap(outlier_pair):
    """Under a ``bound_points`` cap a trimmed solve reports the full-cloud
    sse but no full-cloud gap, as the JAX package does
    (``goicp_tpu/bnb/solver.py:423``; tests/test_bnb.py:312)."""
    src, tgt, _ = outlier_pair
    jp = JBnbParams(mse_threshold=1e-3, trim_fraction=0.2, bound_points=60,
                    init_multistart=4, se3_pop=64, max_rounds=5)
    rj = jmake_solver(src, tgt, jp).run()
    rt = make_solver(src, tgt, BnbParams.from_dict(dataclasses.asdict(jp)),
                     device="cpu").run()
    assert rt.sse_full is not None and rt.gap_full is None
    assert rj.gap_full is None
    np.testing.assert_allclose(rt.sse_full, rj.sse_full, rtol=1e-5)
    np.testing.assert_allclose(rt.mse_full, rt.sse_full / 80, rtol=1e-6)
