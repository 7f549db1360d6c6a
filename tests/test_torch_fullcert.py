"""The port's full-cloud certification (``bnb/fullcert.py``) against the JAX
package on the same numpy inputs: the six cases of ``tests/test_fullcert.py``
through both packages (the trimmed one, with its oracle, and the CLI's
``[tpu] full_cert`` are in ``tests/test_torch_fullcert_cli.py``) and the
coverage order.

Tolerances: refinements, subset sizes, rounds and node counts equal;
``gap_full`` and the sse to rtol 1e-5 (the ICP's f32 poses, see ROADMAP
queue 3) and atol 1e-9 (a noise-free pair ends at an sse of f32 rounding,
~1e-14).  Both packages are pinned to ``bound_backend="exact"``, as the JAX
cases are.  The growth case runs its solves on a budget of 20 rounds a
refinement (the JAX test's 6,000 take minutes): the parity of the loop is
checked there, the certificate's target by the JAX test.
"""

import dataclasses

import numpy as np
import pytest

pytest.importorskip("jax")

import torch  # noqa: E402

from goicp_tpu.bnb import BnbParams as JBnbParams  # noqa: E402
from goicp_tpu.bnb import make_solver as jmake  # noqa: E402
from goicp_tpu.bnb import register_full_cert as jfullcert  # noqa: E402
from goicp_tpu.bnb.fullcert import _coverage_order as jcoverage  # noqa: E402
from goicp_tpu_torch.bnb import BnbParams, make_solver, register, register_full_cert  # noqa: E402
from goicp_tpu_torch.bnb.fullcert import _coverage_order, _subset_sizes  # noqa: E402
from goicp_tpu_torch.icp.solver import sse_of_distances  # noqa: E402
from tests.conftest import random_rotation  # noqa: E402

torch.set_num_threads(1)


def _both(src, tgt, jp: JBnbParams, **kw):
    rj = jfullcert(src, tgt, jp, **kw)
    rt = register_full_cert(src, tgt, BnbParams.from_dict(dataclasses.asdict(jp)),
                            device="cpu", **kw)
    for k in ("fullcert_refinements", "fullcert_subset"):
        assert rt.metrics.counters[k] == rj.metrics.counters[k], k
    assert rt.rounds == rj.rounds and rt.rot_nodes == rj.rot_nodes
    assert rt.converged == rj.converged
    np.testing.assert_allclose(rt.sse, rj.sse, rtol=1e-5, atol=1e-9)
    np.testing.assert_allclose(rt.sse_full, rj.sse_full, rtol=1e-5, atol=1e-9)
    np.testing.assert_allclose(rt.gap_full, rj.gap_full, rtol=1e-5, atol=1e-9)
    np.testing.assert_allclose(rt.transform.R, np.asarray(rj.transform.R), atol=1e-4)
    return rj, rt


def test_trimmed_transfer_inequality_property(rng):
    """trimmed_full_{h_f}(T) ≥ trimmed_sub_{h_s}(T) with h_s = N_s − (N_f −
    h_f), with the trimmed sums of the port's ICP (``sse_of_distances``),
    which equal the JAX package's on the same distances."""
    from goicp_tpu.icp.solver import sse_of_distances as jsse

    for _ in range(40):
        N_f = int(rng.integers(20, 60))
        N_s = int(rng.integers(8, N_f))
        trim = float(rng.uniform(0.05, 0.4))
        h_f = max(1, int(round(N_f * (1.0 - trim))))
        h_s = N_s - (N_f - h_f)
        if h_s < 1:
            continue
        full = rng.random((N_f, 3)).astype(np.float32) - 0.5
        sub_idx = rng.choice(N_f, N_s, replace=False)
        tgt = rng.random((30, 3)).astype(np.float32) - 0.5
        moved = full @ random_rotation(rng).T + (rng.random(3) - 0.5).astype(np.float32)
        d2 = ((moved[:, None, :] - tgt[None]) ** 2).sum(-1).min(1).astype(np.float32)
        full_s = float(sse_of_distances(torch.from_numpy(d2), 1.0 - h_f / N_f))
        sub_s = float(sse_of_distances(torch.from_numpy(d2[sub_idx]), 1.0 - h_s / N_s))
        assert full_s >= sub_s - 1e-6
        np.testing.assert_allclose(full_s, float(jsse(d2, 1.0 - h_f / N_f)), rtol=1e-6)


def test_fullcert_untrimmed_meets_target_and_is_sound(rng):
    base = (rng.random((160, 3)).astype(np.float32) - 0.5) * 0.6
    Q = random_rotation(rng)
    tgt = (base @ Q.T + np.float32([0.1, -0.06, 0.12])
           + rng.normal(0, 0.004, base.shape).astype(np.float32))
    jp = JBnbParams(mse_threshold=2e-4, grid_resolution=24, init_multistart=4, se3_pop=64,
                    max_rounds=3000, bound_points=40, bound_backend="exact", trans_span=0.5)
    _, rt = _both(base, tgt, jp, max_refinements=3)
    assert rt.gap_full <= jp.mse_threshold * base.shape[0] + 1e-9
    full = register(base, tgt, BnbParams.from_dict(dataclasses.asdict(
        dataclasses.replace(jp, bound_points=1 << 30))), device="cpu")
    assert full.sse >= rt.sse_full - rt.gap_full - 1e-6


def test_fullcert_growth_on_tight_target():
    """The 16-point subset cannot meet the target, so the loop grows it with
    the worst-covered points; both packages grow it the same way."""
    rng2 = np.random.default_rng(9)
    base = (rng2.random((60, 3)).astype(np.float32) - 0.5) * 0.6
    Q = random_rotation(rng2)
    tgt = (base @ Q.T + np.float32([0.08, -0.04, 0.1])
           + rng2.normal(0, 0.01, base.shape).astype(np.float32))
    jp = JBnbParams(mse_threshold=5e-4, grid_resolution=24, init_multistart=4, se3_pop=64,
                    max_rounds=20, bound_points=16, bound_backend="exact", trans_span=0.5)
    _, rt = _both(base, tgt, jp, target_gap_mse=2.2e-4, max_refinements=3)
    assert rt.metrics.counters["fullcert_refinements"] >= 1
    assert rt.metrics.counters["fullcert_subset"] > 16


def test_fullcert_uncapped_passthrough(rng):
    src = (rng.random((30, 3)).astype(np.float32) - 0.5) * 0.6
    tgt = (src @ random_rotation(rng).T).astype(np.float32)
    jp = JBnbParams(mse_threshold=1e-4, trans_span=0.5, se3_pop=32, init_multistart=4,
                    bound_backend="exact", grid_resolution=24)
    rt = register_full_cert(src, tgt, BnbParams.from_dict(dataclasses.asdict(jp)),
                            device="cpu")
    rj = jfullcert(src, tgt, jp)
    assert rt.converged and rj.converged and rt.gap_full is not None
    assert rt.gap_full <= 1e-4 * src.shape[0] and rt.sse_full == rt.sse
    assert rt.metrics.counters["fullcert_subset"] == rj.metrics.counters["fullcert_subset"] == 30
    assert rt.rounds == rj.rounds and rt.rot_nodes == rj.rot_nodes


def test_full_cert_slack_ladder_is_sound(rng):
    """``_full_cert``'s slack by termination rule, on the port's solver, and
    ``score_full`` (at the solve's trim and at another) against the JAX
    package's."""
    src = (rng.random((80, 3)).astype(np.float32) - 0.5) * 0.6
    tgt = (src @ random_rotation(rng).T).astype(np.float32)
    jp = JBnbParams(mse_threshold=1e-4, bound_points=40, bound_backend="exact",
                    grid_resolution=16, init_multistart=2, trans_span=0.5)
    s = make_solver(src, tgt, BnbParams.from_dict(dataclasses.asdict(jp)), device="cpu")
    sj = jmake(src, tgt, jp)
    eps = s.sse_thresh
    R, t = np.eye(3, dtype=np.float32), np.zeros(3, np.float32)
    sse_full = s.score_full(R, t)
    np.testing.assert_allclose(sse_full, sj.score_full(R, t), rtol=1e-6)
    np.testing.assert_allclose(s.score_full(R, t, 0.3), sj.score_full(R, t, 0.3), rtol=1e-6)
    assert s.score_full(R, t, 0.3) < sse_full

    best = 5.0 * eps
    _, _, gap_inf = s._full_cert(R, t, best, float("-inf"))
    assert abs(gap_inf - (sse_full - max(best - 1.01 * eps, 0.0))) < 1e-6 * max(1.0, sse_full)
    g = 3.0 * eps
    _, _, gap_g = s._full_cert(R, t, best, g)
    assert abs(gap_g - (sse_full - max(best - g - 0.01 * eps, 0.0))) < 1e-6 * max(1.0, sse_full)
    best2 = 0.5 * eps
    _, _, gap_t = s._full_cert(R, t, best2, 3.0 * eps)
    assert abs(gap_t - (sse_full - max(best2 - 1.01 * eps, 0.0))) < 1e-6 * max(1.0, sse_full)
    for b, gp in ((best, float("-inf")), (best, g), (best2, 3.0 * eps)):
        np.testing.assert_allclose(s._full_cert(R, t, b, gp)[2], sj._full_cert(R, t, b, gp)[2],
                                   rtol=1e-6)


@pytest.mark.parametrize("dups", [False, True], ids=["distinct", "duplicated"])
def test_coverage_order_matches_jax(dups):
    """K1's plain version picks the nearest subset point, its distance is
    recomputed in f64: the order equals the cKDTree one, ties (duplicated
    points, equal distances) in index order.  The grown subset too."""
    rng = np.random.default_rng(3)
    full = (rng.random((400, 3)).astype(np.float32) - 0.5)
    if dups:
        full[200:300] = full[:100]               # every point of the subset has a twin
        full[300:320] = full[300]
    idx = np.sort(np.random.default_rng(777).choice(400, 100, replace=False))
    order = _coverage_order(full, full[idx], "cpu")
    np.testing.assert_array_equal(order, jcoverage(full, full[idx]))
    mask = np.zeros(400, bool)
    mask[idx] = True
    assert (order[~mask[order]][:100] == jcoverage(full, full[idx])[~mask[order]][:100]).all()


def test_subset_sizes_follow_the_loop():
    assert _subset_sizes(8192, 40256, 2.0, 3) == [8192, 16384, 32768, 40256]
    assert _subset_sizes(16, 60, 2.0, 3) == [16, 32, 60]
    assert _subset_sizes(100, 100, 2.0, 3) == [100]
