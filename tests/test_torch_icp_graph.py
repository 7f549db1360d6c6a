"""The ICP loop as one in-place iteration (``icp/solver.py:_icp_iteration``,
what a CUDA graph of it captures) against the loop it replaced and the JAX
package's ``run_icp``.

At the in-round refine's shape (8 poses x 1,518 points against 1,797
targets) and for one pose, trimmed and untrimmed, with and without
``active0``: ``run_icp`` on the CPU, which drives that iteration in a
loop, gives ``R``, ``t``, ``sse`` and ``iters`` bit-equal to the out-of-place loop
(copied below as it stood before the iteration moved into one function),
and agree with the JAX package as ``tests/test_torch_icp.py`` holds them
(poses to 1e-5, sse to rtol 1e-5, iteration counts equal).  The plane
metric, point weights and the per-iteration record are bit-equal to that
loop too, and :class:`ExactCorrespondence` returns what the closure it
replaced returned.  The graph itself is held against the eager loop on the
card (``tests/test_torch_kernels.py``).
"""

import numpy as np
import pytest

pytest.importorskip("jax")

import torch  # noqa: E402

from goicp_tpu.core.types import RigidTransform as JRT  # noqa: E402
from goicp_tpu.icp import IcpParams as JIcpParams  # noqa: E402
from goicp_tpu.icp import exact_correspondence as jcorr  # noqa: E402
from goicp_tpu.icp import run_icp as jrun  # noqa: E402
from goicp_tpu_torch.core.types import RigidTransform  # noqa: E402
from goicp_tpu_torch.geo.normals import estimate_normals  # noqa: E402
from goicp_tpu_torch.geo.rotation import random_rotations  # noqa: E402
from goicp_tpu_torch.icp import IcpParams, exact_correspondence, run_icp  # noqa: E402
from goicp_tpu_torch.icp import solver as icp_solver  # noqa: E402
from goicp_tpu_torch.icp.solver import (  # noqa: E402
    _gate,
    _gather,
    _split_corr,
    _step,
    _trim_weighted,
    trim_weights,
)
from goicp_tpu_torch.nn.fused import nearest_neighbor_mxu  # noqa: E402

torch.set_num_threads(1)

N_SRC, N_TGT = 1518, 1797      # the in-round refine's shape (8 poses)


def closure_correspondence(targets, normals=None):
    """The exact-NN closure that ``ExactCorrespondence`` replaced (CPU)."""

    def corr(pts):
        d2, idx = nearest_neighbor_mxu(pts, targets)
        if normals is None:
            return _gather(targets, idx), d2
        return _gather(targets, idx), _gather(normals, idx), d2

    return corr


def loop_run_icp(src, corr, R0, t0, params, point_weights=None, active0=None, record=None):
    """The out-of-place loop of ``run_icp`` before its iteration became one
    in-place function; ``R0 [B,3,3]``, ``t0 [B,3]``, ``max_iter > 0``."""
    plane = params.metric == "plane"
    B = t0.shape[0]
    dev = t0.device
    tf = params.trim_fraction
    pw = None if point_weights is None else torch.as_tensor(
        point_weights, dtype=torch.float32, device=dev)

    def _weights(d2):
        if pw is None:
            return trim_weights(d2, tf) if tf > 0.0 else None
        if tf <= 0.0:
            return pw.expand(d2.shape)
        return _trim_weighted(d2, pw, tf)

    if active0 is None:
        active = torch.ones((B,), dtype=torch.bool, device=dev)
    else:
        active = torch.as_tensor(active0, device=dev).to(torch.bool).expand(B)
    R_best, t_best = R0, t0
    R_cur, t_cur = R0, t0
    sse_best = torch.full((B,), float("inf"), dtype=torch.float32, device=dev)
    gate_best = sse_best
    iters = torch.zeros((B,), dtype=torch.int32, device=dev)
    it = 0
    while it < params.max_iter and bool(active.any()):
        pts = RigidTransform(R_cur, t_cur).apply(src)
        dst, nrm, d2 = _split_corr(corr(pts))
        w = _weights(d2)
        sse_cur, gate_cur = _gate(pts, dst, nrm, d2, w, plane)
        if record is not None:
            record.append((R_cur, t_cur, sse_cur, active))
        take = active & (sse_cur < sse_best)
        R_best = torch.where(take[:, None, None], R_cur, R_best)
        t_best = torch.where(take[:, None], t_cur, t_best)
        still = active & (
            gate_best - gate_cur >= params.rel_tol * torch.clamp(gate_cur, min=1e-30)
        )
        sse_best = torch.where(take, sse_cur, sse_best)
        gate_best = (torch.where(active & (gate_cur < gate_best), gate_cur, gate_best)
                     if plane else sse_best)
        R_d, t_d = _step(pts, dst, nrm, w, plane)
        nxt = RigidTransform(R_d, t_d).compose(RigidTransform(R_cur, t_cur))
        R_cur = torch.where(still[:, None, None], nxt.R, R_cur)
        t_cur = torch.where(still[:, None], nxt.t, t_cur)
        iters = iters + active.to(torch.int32)
        active = still
        it += 1
    return R_best, t_best, sse_best, iters


@pytest.fixture(scope="module")
def refine_problem():
    """A noisy bunny-sized pair: 1,518 source points, 1,797 targets (the
    source moved, with noise, and 279 others), and 8 starts: 3 near the
    truth, 5 random rotations."""
    rng = np.random.default_rng(41)
    src = rng.uniform(-0.5, 0.5, (N_SRC, 3)).astype(np.float32)
    R = random_rotations(1, rng)[0]
    t = np.float32([0.05, -0.02, 0.03])
    tgt = rng.uniform(-0.55, 0.55, (N_TGT, 3)).astype(np.float32)
    tgt[:N_SRC] = src @ R.T + t + rng.normal(0, 0.004, (N_SRC, 3)).astype(np.float32)
    R0 = random_rotations(8, np.random.default_rng(43))
    R0[:3] = R
    t0 = rng.normal(0, 0.04, (8, 3)).astype(np.float32)
    return src, tgt, R0, t0


def _case(problem, B, use_active):
    src, tgt, R0, t0 = problem
    active0 = (np.arange(B) % 3 != 1) if use_active else None
    return src, tgt, R0[:B].copy(), t0[:B].copy(), active0


def _bits_equal(got, want):
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and g.shape == w.shape
        assert np.array_equal(np.asarray(g).view(np.uint8), np.asarray(w).view(np.uint8))


CASES = [(B, trim, act) for B in (8, 1) for trim in (0.0, 0.25) for act in (False, True)]
IDS = [f"B{B}-trim{trim}-{'active0' if act else 'all'}" for B, trim, act in CASES]


@pytest.fixture(scope="module")
def port_run(refine_problem):
    """``run_icp`` of a case on the CPU, run once for the two tests of it."""
    done = {}

    def run(B, trim, use_active):
        if (B, trim, use_active) not in done:
            src, tgt, R0, t0, active0 = _case(refine_problem, B, use_active)
            res = run_icp(torch.from_numpy(src), exact_correspondence(torch.from_numpy(tgt)),
                          RigidTransform(torch.from_numpy(R0), torch.from_numpy(t0)),
                          IcpParams(max_iter=32, rel_tol=1e-4, trim_fraction=trim),
                          active0=None if active0 is None else torch.from_numpy(active0))
            done[B, trim, use_active] = [
                x.numpy() for x in (res.transform.R, res.transform.t, res.sse, res.iters)]
        return done[B, trim, use_active]

    return run


@pytest.mark.parametrize("B,trim,use_active", CASES, ids=IDS)
def test_in_place_iteration_is_bit_equal_to_the_loop(refine_problem, port_run, B, trim,
                                                     use_active):
    """``run_icp`` on the CPU drives :func:`_icp_iteration` in a loop, as a
    graph's replays do on the card."""
    src, tgt, R0, t0, active0 = _case(refine_problem, B, use_active)
    params = IcpParams(max_iter=32, rel_tol=1e-4, trim_fraction=trim)
    S, T = torch.from_numpy(src), torch.from_numpy(tgt)
    Rt, tt = torch.from_numpy(R0), torch.from_numpy(t0)
    assert not icp_solver._graphable(S, exact_correspondence(T), Rt, tt, params, None, None)
    want = [x.numpy() for x in loop_run_icp(
        S, closure_correspondence(T), Rt, tt, params,
        active0=None if active0 is None else torch.from_numpy(active0))]
    got = port_run(B, trim, use_active)
    _bits_equal(got, want)
    assert got[3].max() > 1


@pytest.mark.parametrize("B,trim,use_active", CASES, ids=IDS)
def test_in_place_iteration_matches_jax(refine_problem, port_run, B, trim, use_active):
    src, tgt, R0, t0, active0 = _case(refine_problem, B, use_active)
    kw = dict(max_iter=32, rel_tol=1e-4, trim_fraction=trim)
    rj = jrun(src, jcorr(tgt), JRT(R0, t0), JIcpParams(**kw), active0=active0)
    R, t, sse, iters = port_run(B, trim, use_active)
    np.testing.assert_allclose(R, np.asarray(rj.transform.R), rtol=0, atol=1e-5)
    np.testing.assert_allclose(t, np.asarray(rj.transform.t), rtol=0, atol=1e-5)
    np.testing.assert_allclose(sse, np.asarray(rj.sse), rtol=1e-5)
    assert np.array_equal(iters, np.asarray(rj.iters))


@pytest.mark.parametrize("kind", ["plane", "weights", "weights-trim"])
def test_eager_paths_are_bit_equal_to_the_loop(refine_problem, kind):
    """The calls that keep the eager loop: the plane metric (on target
    normals), and point weights with and without the trim (the service's
    padded batches)."""
    src, tgt, R0, t0, active0 = _case(refine_problem, 8, True)
    S, T = torch.from_numpy(src), torch.from_numpy(tgt)
    Rt, tt = torch.from_numpy(R0), torch.from_numpy(t0)
    a0 = torch.from_numpy(active0)
    nrm, pw = None, None
    if kind == "plane":
        nrm = estimate_normals(T)
        params = IcpParams(max_iter=8, rel_tol=1e-4, metric="plane")
    else:
        pw = np.ones((8, N_SRC), np.float32)
        pw[:, -200:] = 0.0                       # padding
        pw[3, :50] = 0.5
        pw = torch.from_numpy(pw)
        params = IcpParams(max_iter=8, rel_tol=1e-4,
                           trim_fraction=0.25 if kind == "weights-trim" else 0.0)
    want = [x.numpy() for x in loop_run_icp(S, closure_correspondence(T, nrm), Rt, tt, params,
                                            point_weights=pw, active0=a0)]
    res = run_icp(S, exact_correspondence(T, normals=nrm), RigidTransform(Rt, tt), params,
                  point_weights=pw, active0=a0)
    _bits_equal([x.numpy() for x in (res.transform.R, res.transform.t, res.sse, res.iters)],
                want)
    assert int(res.iters.max()) > 1


def test_record_is_bit_equal_to_the_loop(refine_problem):
    """``record`` rows (``run_icp_trace`` reads them) hold each iteration's
    poses as they were, not the buffers the iteration goes on to update."""
    src, tgt, R0, t0, active0 = _case(refine_problem, 8, True)
    S, T = torch.from_numpy(src), torch.from_numpy(tgt)
    Rt, tt = torch.from_numpy(R0), torch.from_numpy(t0)
    params = IcpParams(max_iter=8, rel_tol=1e-4, trim_fraction=0.25)
    rows_loop, rows = [], []
    loop_run_icp(S, closure_correspondence(T), Rt, tt, params,
                 active0=torch.from_numpy(active0), record=rows_loop)
    run_icp(S, exact_correspondence(T), RigidTransform(Rt, tt), params,
            active0=torch.from_numpy(active0), record=rows)
    assert len(rows) == len(rows_loop) > 1
    for got, want in zip(rows, rows_loop):
        _bits_equal([x.numpy() for x in got], [x.numpy() for x in want])


@pytest.mark.parametrize("with_normals", [False, True])
def test_exact_correspondence_returns_what_the_closure_did(refine_problem, with_normals):
    src, tgt, R0, t0, _ = _case(refine_problem, 8, False)
    T = torch.from_numpy(tgt)
    nrm = estimate_normals(T) if with_normals else None
    corr = exact_correspondence(T, normals=nrm)
    assert isinstance(corr, icp_solver.ExactCorrespondence)
    assert corr.targets is T and corr.normals is nrm and corr.packed is None   # CPU
    pts = RigidTransform(torch.from_numpy(R0), torch.from_numpy(t0)).apply(torch.from_numpy(src))
    got, want = corr(pts), closure_correspondence(T, nrm)(pts)
    assert len(got) == len(want) == (3 if with_normals else 2)
    _bits_equal([x.numpy() for x in got], [x.numpy() for x in want])


def test_cpu_calls_take_the_eager_loop(refine_problem):
    """The choice reads the arguments only: CPU tensors never take the
    graph, nor do grid correspondences or a plane, weighted or recorded
    call."""
    src, tgt, R0, t0, _ = _case(refine_problem, 8, False)
    S, T = torch.from_numpy(src), torch.from_numpy(tgt)
    Rt, tt = torch.from_numpy(R0), torch.from_numpy(t0)
    corr = exact_correspondence(T)
    point = IcpParams(max_iter=4)
    assert not icp_solver._graphable(S, corr, Rt, tt, point, None, None)
    assert not icp_solver._graphable(S, closure_correspondence(T), Rt, tt, point, None, None)
    assert not icp_solver._graphable(S, corr, Rt, tt, IcpParams(metric="plane"), None, None)
    assert not icp_solver._graphable(S, corr, Rt, tt, point, torch.ones(N_SRC), None)
    assert not icp_solver._graphable(S, corr, Rt, tt, point, None, [])
