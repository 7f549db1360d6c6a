"""The port's batched multi-pair registration (``goicp_tpu_torch.multipair``
and ``multipair_lockstep``): the cases of ``tests/test_multipair.py`` that
need no mesh and no second process, and parity with the JAX package on the
same numpy inputs.

Parity: the lockstep's bounds on the exact expansion and one
``_pairs_round`` bit-equal in ub and lb (the epilogue sums in XLA's order
and takes glibc's sine); the K4 form's plain version against the JAX
package's Pallas kernel in interpret mode to rtol 1e-5 + atol 1e-7 (K4's
known 1-ulp difference); ``icp_pairs`` poses to 1e-5 with equal
iterations; whole lockstep solves equal in rounds, nodes, ICP iterations,
converged and gap, sse to 1e-5 relative.  The JAX package runs the exact
expansion in its lockstep on the CPU (``use_kernel`` is TPU-only), so the
port's CPU path does too.
"""

import numpy as np
import pytest

pytest.importorskip("jax")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from goicp_tpu import multipair as jmp  # noqa: E402
from goicp_tpu.bnb import BnbParams as JBnbParams  # noqa: E402
from goicp_tpu.core.types import RigidTransform as JRT  # noqa: E402
from goicp_tpu.icp import IcpParams as JIcpParams  # noqa: E402
from goicp_tpu_torch import multipair as mp  # noqa: E402
from goicp_tpu_torch import multipair_lockstep as ml  # noqa: E402
from goicp_tpu_torch.bnb import BnbParams, make_solver  # noqa: E402
from goicp_tpu_torch.core.types import RigidTransform  # noqa: E402
from goicp_tpu_torch.geo.rotation import axis_angle_rotation  # noqa: E402
from goicp_tpu_torch.icp import IcpParams  # noqa: E402
from tests.conftest import random_rotation  # noqa: E402

torch.set_num_threads(1)
CPU = "cpu"


def _rot(v):
    return axis_angle_rotation(torch.as_tensor(np.asarray(v, np.float32))).numpy()


def _rmse(s, R, t, R_gt, t_gt):
    a = s @ np.asarray(R).T + np.asarray(t)
    b = s @ R_gt.T + t_gt
    return float(np.sqrt(np.mean(np.sum((a - b) ** 2, axis=1))))


def _noise(rng, shape, sigma):
    return rng.normal(0, sigma, shape).astype(np.float32) if sigma else 0.0


def _pair(rng, n, angle=0.1, sigma=0.0):
    src = (rng.random((n, 3)).astype(np.float32) - 0.5) * 0.6
    axis = rng.normal(size=3)
    axis /= np.linalg.norm(axis)
    R = _rot(axis * angle)
    t = (rng.random(3).astype(np.float32) - 0.5) * 0.1
    return src, (src @ R.T + t + _noise(rng, src.shape, sigma)).astype(np.float32), R, t


def _rigid_pairs(rng, n_pairs, n, t_scale=0.2):
    pairs, gts = [], []
    for _ in range(n_pairs):
        src = (rng.random((n, 3)).astype(np.float32) - 0.5) * 0.6
        R = random_rotation(rng)
        t = (rng.random(3).astype(np.float32) - 0.5) * t_scale
        pairs.append((src, (src @ R.T + t).astype(np.float32)))
        gts.append((R, t))
    return pairs, gts


def _trimmed_pair(rng, n=90, overlap=60, scale=0.6):
    """Partial overlap: the target is a rigidly moved subset of the source."""
    src = (rng.random((n, 3)).astype(np.float32) - 0.5) * scale
    R = random_rotation(rng)
    t = (rng.random(3).astype(np.float32) - 0.5) * 0.2
    idx = rng.choice(n, overlap, replace=False)
    return src, (src[idx] @ R.T + t).astype(np.float32), R, t


def _surface_pair(rng, n=220, angle_scale=1.0, sigma=0.0):
    """Smooth heightfield pair (meaningful normals)."""
    xy = (rng.random((n, 2)).astype(np.float32) - 0.5) * 0.8
    z = 0.12 * np.sin(4.0 * xy[:, 0]) * np.cos(3.0 * xy[:, 1])
    src = np.column_stack([xy, z]).astype(np.float32)
    axis = rng.normal(size=3)
    axis /= np.linalg.norm(axis)
    R = _rot(axis * angle_scale * rng.random())
    t = (rng.random(3).astype(np.float32) - 0.5) * 0.2
    return src, (src @ R.T + t + _noise(rng, src.shape, sigma)).astype(np.float32), R, t


class _Spy:
    """Wraps ``multipair_lockstep._register_pairs_lockstep`` (which
    ``register_pairs`` looks up at call time) and records each call."""

    def __init__(self, monkeypatch):
        self.calls = []
        orig = ml._register_pairs_lockstep

        def spy(pairs_, p, **kw):
            self.calls.append((len(pairs_), kw))
            return orig(pairs_, p, **kw)

        monkeypatch.setattr(ml, "_register_pairs_lockstep", spy)


# ---------------------------------------------------------------------------
# the cases of tests/test_multipair.py
# ---------------------------------------------------------------------------


def test_icp_pairs_mixed_sizes(rng):
    pairs, gts = [], []
    for n in (150, 230, 310):
        s, t, R, tv = _pair(rng, n)
        pairs.append((s, t))
        gts.append((R, tv))
    T, sse, iters = mp.icp_pairs(pairs, params=IcpParams(max_iter=80, rel_tol=1e-6),
                                 device=CPU)
    for b, ((s, t), (R, tv)) in enumerate(zip(pairs, gts)):
        assert _rmse(s, T.R[b].numpy(), T.t[b].numpy(), R, tv) < 1e-3


def test_register_pairs_lockstep_one_round_for_all_pairs(rng, monkeypatch):
    """Three pairs advance together: every round evaluates all live pairs'
    bounds in one ``_pairs_bounds`` call (the port's form of the JAX
    package's one shared round executable)."""
    pairs, _ = _rigid_pairs(rng, 3, 120)
    spy = _Spy(monkeypatch)
    calls = []
    orig = ml._pairs_bounds

    def count(batch, *a, **kw):
        calls.append(batch.P)
        return orig(batch, *a, **kw)

    monkeypatch.setattr(ml, "_pairs_bounds", count)
    results = mp.register_pairs(
        pairs, BnbParams(mse_threshold=1e-4, se3_pop=32, max_rounds=40), device=CPU
    )
    assert [c[0] for c in spy.calls] == [3]
    assert len(calls) == results[0].rounds and set(calls) <= {3}
    for (s, t), res in zip(pairs, results):
        pts = s @ res.transform.R.T + res.transform.t
        assert float(np.sqrt(np.mean(np.sum((pts - t) ** 2, axis=1)))) < 5e-3
        assert res.rounds >= 1 or res.converged


def test_register_pairs_lockstep_trimmed(rng, monkeypatch):
    pairs, gts = [], []
    for _ in range(3):
        s, t, R, tv = _trimmed_pair(rng)
        pairs.append((s, t))
        gts.append((R, tv))
    spy = _Spy(monkeypatch)
    results = mp.register_pairs(
        pairs,
        BnbParams(mse_threshold=2e-5, trim_fraction=0.4, se3_pop=32, max_rounds=120),
        device=CPU,
    )
    assert [c[0] for c in spy.calls] == [3]
    for (s, _), res, (R, tv) in zip(pairs, results, gts):
        assert res.converged
        assert _rmse(s, res.transform.R, res.transform.t, R, tv) < 5e-3


def test_pairs_round_trimmed_bounds_bracket(rng):
    """Trimmed lockstep bounds are valid: lb ≤ the trimmed SSE of any pose
    in the cube and ub ≥ the trimmed SSE of its center."""
    src, tgt, _, _ = _trimmed_pair(rng, n=50, overlap=35)
    N = src.shape[0]
    h = int(round(N * 0.7))
    norms = np.linalg.norm(src, axis=1).astype(np.float32)

    def trimmed_sse(R, t):
        pts = src @ R.T + t
        d2 = ((pts[:, None, :] - tgt[None]) ** 2).sum(-1).min(1)
        return float(np.sort(d2)[:h].sum())

    M = 8
    r_c = (rng.random((M, 3)).astype(np.float32) - 0.5) * 2.0
    r_s = rng.random(M).astype(np.float32) * 0.4 + 0.05
    t_c = (rng.random((M, 3)).astype(np.float32) - 0.5) * 0.2
    t_s = rng.random(M).astype(np.float32) * 0.08 + 0.01
    R_c = np.stack([_rot(r) for r in r_c])
    ang = np.minimum(np.sqrt(3.0) * r_s, np.pi).astype(np.float32)
    f = torch.from_numpy
    ub, lb = ml._bounds_one_pair(
        f(src), torch.ones(N), f(norms), f(tgt), 0.0, f(R_c), f(ang), f(t_c), f(t_s),
        torch.ones(M, dtype=torch.bool), h, trim=True,
    )
    ub, lb = ub.numpy(), lb.numpy()
    for m in range(M):
        center = trimmed_sse(R_c[m], t_c[m])
        assert ub[m] >= center - 1e-4, (m, ub[m], center)
        assert lb[m] <= center + 1e-4
        for _ in range(6):
            rr = r_c[m] + (rng.random(3).astype(np.float32) - 0.5) * 2 * r_s[m]
            tt = t_c[m] + (rng.random(3).astype(np.float32) - 0.5) * 2 * t_s[m]
            assert lb[m] <= trimmed_sse(_rot(rr), tt) + 1e-4


def test_register_pairs_lockstep_quaternion(rng, monkeypatch):
    pairs, gts = _rigid_pairs(rng, 2, 100)
    spy = _Spy(monkeypatch)
    results = mp.register_pairs(
        pairs,
        BnbParams(mse_threshold=1e-4, rotation_param="quaternion", se3_pop=32,
                  max_rounds=120),
        device=CPU,
    )
    assert [c[0] for c in spy.calls] == [2]
    for (s, t), res, (R, tv) in zip(pairs, results, gts):
        assert res.converged
        assert _rmse(s, res.transform.R, res.transform.t, R, tv) < 5e-3


def test_register_pairs_lockstep_plane_metric(rng, monkeypatch):
    """The plane metric rides the lockstep and matches the solo plane
    solver's pose."""
    pairs, gts = [], []
    for _ in range(3):
        s, t, R, tv = _surface_pair(rng)
        pairs.append((s, t))
        gts.append((R, tv))
    spy = _Spy(monkeypatch)
    params = BnbParams(mse_threshold=1e-5, icp_metric="plane", se3_pop=32, max_rounds=120)
    results = mp.register_pairs(pairs, params, device=CPU)
    assert [c[0] for c in spy.calls] == [3]
    for (s, t), res, (R, tv) in zip(pairs, results, gts):
        assert res.converged
        assert _rmse(s, res.transform.R, res.transform.t, R, tv) < 2e-3
    solo = make_solver(pairs[0][0], pairs[0][1], params, device=CPU).run()
    assert _rmse(pairs[0][0], results[0].transform.R, results[0].transform.t,
                 solo.transform.R, solo.transform.t) < 2e-3


def _priors(rng, n_pairs=3, n=150, sigma=0.0):
    pairs, gts, priors = [], [], []
    for _ in range(n_pairs):
        src = (rng.random((n, 3)).astype(np.float32) - 0.5) * 0.6
        R = random_rotation(rng)
        t = (rng.random(3).astype(np.float32) - 0.5) * 0.3
        pairs.append((src, (src @ R.T + t + _noise(rng, src.shape, sigma)).astype(np.float32)))
        gts.append((R, t))
        d = rng.normal(size=3).astype(np.float32)
        d *= 0.05 / np.linalg.norm(d)
        priors.append(((_rot(d) @ R).astype(np.float32), t))
    return pairs, gts, priors


def test_register_pairs_lockstep_priors(rng):
    """A near-truth prior per pair, pinned as a multistart seed: every pair
    converges in the prior's basin without BnB nodes."""
    pairs, gts, priors = _priors(rng)
    results = mp.register_pairs(
        pairs,
        BnbParams(mse_threshold=1e-5, init_multistart=2, se3_pop=32, max_rounds=120),
        inits=[RigidTransform(R, t) for R, t in priors], device=CPU,
    )
    for (s, t), res, (R, tv) in zip(pairs, results, gts):
        assert res.converged and res.rot_nodes == 0
        assert _rmse(s, res.transform.R, res.transform.t, R, tv) < 2e-3


def test_lockstep_then_single_solver_same_process(rng):
    """A lockstep batch leaves no state behind that a later single-pair solve
    reads."""
    pairs, _ = _rigid_pairs(rng, 2, 100)
    mp.register_pairs(pairs, BnbParams(mse_threshold=1e-4, se3_pop=32, max_rounds=40),
                      device=CPU)
    tgt = (rng.random((120, 3)).astype(np.float32) - 0.5)
    Q = random_rotation(rng)
    src = (tgt[rng.choice(120, 90, replace=False)] @ Q).astype(np.float32)
    res = make_solver(
        src, tgt,
        BnbParams(mse_threshold=1e-4, grid_resolution=24, max_rounds=400,
                  init_multistart=4, se3_pop=64),
        device=CPU,
    ).run()
    assert res.converged


def test_register_pairs_global(rng):
    pairs, gts = _rigid_pairs(rng, 2, 200, t_scale=0.3)
    results = mp.register_pairs(
        pairs, BnbParams(mse_threshold=1e-5, se3_pop=64, max_rounds=200), device=CPU
    )
    for (s, t), res in zip(pairs, results):
        pts = s @ res.transform.R.T + res.transform.t
        assert float(np.sqrt(np.mean(np.sum((pts - t) ** 2, axis=1)))) < 2e-3


def test_lockstep_pipelined_budget_exit(rng):
    """The pipelined driver honours max_rounds, absorbs its queued rounds and
    returns finite, uncertified results with true gaps."""
    pairs = []
    for _ in range(3):
        src = (rng.random((150, 3)).astype(np.float32) - 0.5) * 0.6
        R = random_rotation(rng)
        t = (rng.random(3).astype(np.float32) - 0.5) * 0.2
        tgt = (src @ R.T + t + rng.normal(size=src.shape).astype(np.float32) * 0.02)
        pairs.append((src, tgt.astype(np.float32)))
    res = mp.register_pairs(
        pairs,
        BnbParams(mse_threshold=1e-9, init_multistart=4, se3_pop=16, max_rounds=3,
                  pipeline_depth=3),
        device=CPU,
    )
    assert len(res) == 3
    for r in res:
        assert r.rounds <= 3
        assert np.isfinite(r.sse) and np.isfinite(r.gap) and r.gap >= 0
        assert r.rot_nodes > 0 and not r.converged


def test_mesh_and_distributed_not_ported(rng):
    pairs, _ = _rigid_pairs(rng, 2, 40)
    with pytest.raises(NotImplementedError, match="item 6|Distribution"):
        mp.register_pairs(pairs, BnbParams(), mesh=object(), device=CPU)
    with pytest.raises(NotImplementedError, match="Distribution"):
        ml._register_pairs_lockstep(pairs, BnbParams(), mesh=object(), device=CPU)
    with pytest.raises(NotImplementedError, match="Distribution"):
        mp.register_pairs_distributed(pairs, BnbParams())


# ---------------------------------------------------------------------------
# parity with the JAX package
# ---------------------------------------------------------------------------


def _round_inputs(rng, P=3, M=48, trim=0.0):
    """P pairs of 60-100 points and M random nodes a pair (the last pair
    with fewer live jobs), as the lockstep dispatches them."""
    pairs = [_trimmed_pair(rng, n=n, overlap=n - 15)[:2] for n in (60, 80, 100)][:P]
    N, Nt = 100, max(t.shape[0] for _, t in pairs)
    srcs = np.zeros((P, N, 3), np.float32)
    wts = np.zeros((P, N), np.float32)
    tgts = np.full((P, Nt, 3), 1e15, np.float32)
    for b, (s, t) in enumerate(pairs):
        srcs[b, : s.shape[0]] = s
        wts[b, : s.shape[0]] = 1.0
        tgts[b, : t.shape[0]] = t
    norms = np.linalg.norm(srcs, axis=-1).astype(np.float32)
    r_c = (rng.random((P, M, 3)).astype(np.float32) - 0.5) * 2.0
    r_s = (rng.random((P, M)).astype(np.float32) * 0.4 + 0.05)
    R = np.stack([np.stack([_rot(r) for r in rp]) for rp in r_c])
    ang = np.minimum(np.sqrt(3.0) * r_s, np.pi).astype(np.float32)
    t_c = (rng.random((P, M, 3)).astype(np.float32) - 0.5) * 0.2
    t_s = rng.random((P, M)).astype(np.float32) * 0.08 + 0.01
    mask = np.ones((P, M), bool)
    mask[-1, M // 2:] = False
    h = np.array([max(1, int(round(s.shape[0] * (1.0 - trim)))) for s, _ in pairs],
                 np.float32)
    return pairs, dict(srcs=srcs, wts=wts, norms=norms, tgts=tgts, R=R, ang=ang, t_c=t_c,
                       t_s=t_s, mask=mask, h=h)


@pytest.mark.parametrize("trim", [0.0, 0.25])
def test_bounds_one_pair_bit_equal_to_jax(rng, trim):
    """One pair's bounds on the exact expansion against the jitted JAX
    function (the lockstep round jits it): bit-equal."""
    _, x = _round_inputs(rng, trim=trim)
    f = torch.from_numpy
    jbounds = jax.jit(jmp._bounds_one_pair, static_argnames="trim")
    for b in range(3):
        args = (x["srcs"][b], x["wts"][b], x["norms"][b], x["tgts"][b])
        node = (x["R"][b], x["ang"][b], x["t_c"][b], x["t_s"][b], x["mask"][b])
        ub_j, lb_j = jbounds(
            *map(jnp.asarray, args), jnp.float32(0.0), *map(jnp.asarray, node),
            jnp.float32(x["h"][b]), trim=trim > 0)
        ub_t, lb_t = ml._bounds_one_pair(*map(f, args), 0.0, *map(f, node), int(x["h"][b]),
                                         trim=trim > 0)
        np.testing.assert_array_equal(ub_t.numpy(), np.asarray(ub_j))
        np.testing.assert_array_equal(lb_t.numpy(), np.asarray(lb_j))


@pytest.mark.parametrize("trim", [0.0, 0.25])
def test_k4_form_plain_against_interpreted_jax(rng, trim):
    """The K4 form on the CPU (K4's plain version) against the JAX package's
    Pallas kernel in interpret mode: rtol 1e-5, atol 1e-7 (K4's known
    1-ulp difference from the interpreted kernel)."""
    _, x = _round_inputs(rng, trim=trim)
    f = torch.from_numpy
    b = 1
    args = (x["srcs"][b], x["wts"][b], x["norms"][b], x["tgts"][b])
    node = (x["R"][b], x["ang"][b], x["t_c"][b], x["t_s"][b], x["mask"][b])
    ub_j, lb_j = jax.jit(jmp._bounds_one_pair_mxu, static_argnames="trim")(
        *map(jnp.asarray, args), jnp.float32(0.0), *map(jnp.asarray, node),
        jnp.float32(x["h"][b]), trim=trim > 0)
    ub_t, lb_t = ml._bounds_one_pair_mxu(*map(f, args), 0.0, *map(f, node), int(x["h"][b]),
                                         trim=trim > 0)
    np.testing.assert_allclose(ub_t.numpy(), np.asarray(ub_j), rtol=1e-5, atol=1e-7)
    np.testing.assert_allclose(lb_t.numpy(), np.asarray(lb_j), rtol=1e-5, atol=1e-7)


@pytest.mark.parametrize("trim", [0.0, 0.25])
def test_pairs_round_matches_jax(rng, trim):
    """One lockstep round: ub and lb bit-equal; each live pair's refined
    poses to 1e-5, sse to rtol 1e-5, iterations equal."""
    pairs, x = _round_inputs(rng, trim=trim)
    icp = dict(max_iter=32, rel_tol=1e-4, trim_fraction=trim)
    gate = np.full(3, 0.5, np.float32)
    out_j = jmp._pairs_round(
        *(jnp.asarray(x[k]) for k in ("srcs", "wts", "norms", "tgts")), None,
        jnp.float32(0.0), *(jnp.asarray(x[k]) for k in ("R", "ang", "t_c", "t_s", "mask", "h")),
        jnp.asarray(gate), refine_k=4, icp_params=JIcpParams(**icp), trim=trim > 0)
    batch = ml._PairBatch(pairs, 100, torch.device(CPU))
    out_t = ml._pairs_round(batch, 0.0, *(x[k] for k in ("R", "ang", "t_c", "t_s", "mask",
                                                          "h")),
                            gate, refine_k=4, icp_params=IcpParams(**icp), trim=trim > 0)
    ub_j, lb_j, R_j, t_j, sse_j, it_j = (np.asarray(v) for v in out_j)
    ub_t, lb_t, R_t, t_t, sse_t, it_t = (v.numpy() for v in out_t)
    np.testing.assert_array_equal(ub_t, ub_j)
    np.testing.assert_array_equal(lb_t, lb_j)
    np.testing.assert_allclose(R_t, R_j, rtol=0, atol=1e-5)
    np.testing.assert_allclose(t_t, t_j, rtol=0, atol=1e-5)
    np.testing.assert_allclose(sse_t, sse_j, rtol=1e-5)
    np.testing.assert_array_equal(it_t, it_j)


def test_icp_pairs_match_jax(rng):
    """``icp_pairs`` per pair: poses to 1e-5, iterations equal, sse to rtol
    1e-5, with mixed sizes (padding weights) and two pairs sharing one
    target object.  The targets carry noise: a noise-free pair ends at an
    sse of f32 rounding (~1e-13), which no relative tolerance can hold
    (ROADMAP queue 3)."""
    pairs = []
    for n in (150, 230, 310):
        s, t, _, _ = _pair(rng, n, angle=0.3, sigma=0.005)
        pairs.append((s, t))
    pairs.append((pairs[0][0][:120], pairs[0][1]))           # the first pair's target again
    R0 = np.stack([_rot(v) for v in rng.normal(0, 0.1, (4, 3))]).astype(np.float32)
    t0 = rng.normal(0, 0.02, (4, 3)).astype(np.float32)
    kw = dict(max_iter=60, rel_tol=1e-5)
    Tj, sse_j, it_j = jmp.icp_pairs(pairs, inits=JRT(jnp.asarray(R0), jnp.asarray(t0)),
                                    params=JIcpParams(**kw))
    Tt, sse_t, it_t = mp.icp_pairs(pairs, inits=RigidTransform(R0, t0),
                                   params=IcpParams(**kw), device=CPU)
    np.testing.assert_allclose(Tt.R.numpy(), np.asarray(Tj.R), rtol=0, atol=1e-5)
    np.testing.assert_allclose(Tt.t.numpy(), np.asarray(Tj.t), rtol=0, atol=1e-5)
    np.testing.assert_allclose(sse_t.numpy(), np.asarray(sse_j), rtol=1e-5)
    np.testing.assert_array_equal(it_t.numpy(), np.asarray(it_j))


def _parity_pairs(rng, kind):
    """Three 60-100-point pairs with target noise 0.01 (a noise-free pair
    ends at an sse of f32 rounding, ROADMAP queue 3)."""
    if kind == "plane":
        return [_surface_pair(rng, n=n, angle_scale=0.6, sigma=0.01)[:2]
                for n in (60, 80, 100)], None
    if kind == "priors":
        pairs, _, priors = _priors(rng, 3, 80, sigma=0.01)
        return pairs, priors
    pairs = []
    for n in (60, 80, 100):
        src = (rng.random((n, 3)).astype(np.float32) - 0.5) * 0.6
        R = random_rotation(rng)
        t = (rng.random(3).astype(np.float32) - 0.5) * 0.2
        noise = rng.normal(0, 0.01, src.shape).astype(np.float32)
        pairs.append((src, (src @ R.T + t + noise).astype(np.float32)))
    return pairs, None


@pytest.mark.parametrize("kind,kw", [
    ("untrimmed", {}),
    ("trimmed", dict(trim_fraction=0.2)),
    ("quaternion", dict(rotation_param="quaternion")),
    ("plane", dict(icp_metric="plane")),
    # below the priors' mse, so the BnB runs after the pinned seeds
    ("priors", dict(init_multistart=4, mse_threshold=1e-4)),
])
def test_register_pairs_lockstep_matches_jax(rng, kind, kw):
    """Whole lockstep solves of three 60-100-point pairs in both packages:
    equal rounds, nodes, ICP iterations, converged and gap per pair, sse to
    1e-5 relative (the ICP's f32 sums add in another order)."""
    pairs, priors = _parity_pairs(rng, kind)
    # a threshold just above the noise's mse: some pairs certify in the
    # rounds, the others run to max_rounds
    base = dict(mse_threshold=3.5e-4, se3_pop=32, max_rounds=12, init_multistart=8)
    rj = jmp._register_pairs_lockstep(
        pairs, JBnbParams(**{**base, **kw}),
        inits=None if priors is None else [JRT(R, t) for R, t in priors])
    rt = ml._register_pairs_lockstep(
        pairs, BnbParams(**{**base, **kw}), device=CPU,
        inits=None if priors is None else [RigidTransform(R, t) for R, t in priors])
    for a, b in zip(rj, rt):
        assert (b.rounds, b.rot_nodes, b.icp_iters, b.converged) == \
            (a.rounds, a.rot_nodes, a.icp_iters, a.converged)
        np.testing.assert_allclose(b.sse, a.sse, rtol=1e-5)
        np.testing.assert_allclose(b.gap, a.gap, rtol=1e-5, atol=1e-9)
        np.testing.assert_allclose(b.transform.R, np.asarray(a.transform.R), atol=1e-4)
