"""The port's batched ICP against the JAX package's on the same numpy
inputs: 16 poses, some gated off through ``active0``, the ``max_iter=0``
scoring path and the in-round cap of 32 iterations.  Poses to 1e-5, sse to
rtol 1e-5, iteration counts equal."""

import numpy as np
import pytest

pytest.importorskip("jax")

import torch  # noqa: E402

from goicp_tpu.core.types import RigidTransform as JRT  # noqa: E402
from goicp_tpu.icp import IcpParams as JIcpParams  # noqa: E402
from goicp_tpu.icp import exact_correspondence as jcorr  # noqa: E402
from goicp_tpu.icp import run_icp as jrun  # noqa: E402
from goicp_tpu_torch.core.types import RigidTransform  # noqa: E402
from goicp_tpu_torch.geo.rotation import random_rotations  # noqa: E402
from goicp_tpu_torch.icp import IcpParams, exact_correspondence, run_icp  # noqa: E402

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def problem():
    rng = np.random.default_rng(5)
    src = rng.uniform(-0.3, 0.3, (180, 3)).astype(np.float32)
    R = random_rotations(1, rng)[0]
    tgt = (src @ R.T + np.float32([0.04, -0.03, 0.02])
           + rng.normal(0, 0.005, (180, 3))).astype(np.float32)
    # 16 starts: near the truth, and random rotations
    R0 = random_rotations(16, np.random.default_rng(9))
    R0[:4] = R
    t0 = (rng.normal(0, 0.05, (16, 3))).astype(np.float32)
    return src, tgt, R0, t0


def _both(problem, params_kw, active0=None):
    src, tgt, R0, t0 = problem
    rj = jrun(src, jcorr(tgt), JRT(R0, t0), JIcpParams(**params_kw),
              active0=active0)
    rt = run_icp(torch.from_numpy(src), exact_correspondence(torch.from_numpy(tgt)),
                 RigidTransform(torch.from_numpy(R0), torch.from_numpy(t0)),
                 IcpParams(**params_kw),
                 active0=None if active0 is None else torch.from_numpy(active0))
    return rj, rt


def _agree(rj, rt):
    np.testing.assert_allclose(rt.transform.R.numpy(), np.asarray(rj.transform.R),
                               rtol=0, atol=1e-5)
    np.testing.assert_allclose(rt.transform.t.numpy(), np.asarray(rj.transform.t),
                               rtol=0, atol=1e-5)
    np.testing.assert_allclose(rt.sse.numpy(), np.asarray(rj.sse), rtol=1e-5)
    assert np.array_equal(rt.iters.numpy(), np.asarray(rj.iters))


@pytest.mark.parametrize("max_iter", [32, 100])
def test_run_icp_matches_jax(problem, max_iter):
    rj, rt = _both(problem, dict(max_iter=max_iter, rel_tol=1e-4))
    _agree(rj, rt)
    assert rt.iters.max() <= max_iter


def test_run_icp_active_gate_matches_jax(problem):
    active0 = np.ones(16, bool)
    active0[[1, 5, 6, 12]] = False
    rj, rt = _both(problem, dict(max_iter=32, rel_tol=1e-4), active0)
    _agree(rj, rt)
    off = ~active0
    assert np.all(np.isinf(rt.sse.numpy()[off]))
    assert np.all(rt.iters.numpy()[off] == 0)
    src, tgt, R0, t0 = problem
    assert np.array_equal(rt.transform.R.numpy()[off], R0[off])


def test_run_icp_all_gated_off(problem):
    rj, rt = _both(problem, dict(max_iter=32, rel_tol=1e-4), np.zeros(16, bool))
    _agree(rj, rt)
    assert int(rt.iters.sum()) == 0


def test_run_icp_scoring_path_matches_jax(problem):
    rj, rt = _both(problem, dict(max_iter=0, rel_tol=0.0))
    _agree(rj, rt)


def test_run_icp_unbatched_pose(problem):
    src, tgt, R0, t0 = problem
    rt = run_icp(torch.from_numpy(src), exact_correspondence(torch.from_numpy(tgt)),
                 RigidTransform(torch.from_numpy(R0[0]), torch.from_numpy(t0[0])),
                 IcpParams(max_iter=10))
    assert rt.transform.R.shape == (3, 3) and rt.sse.dim() == 0


def test_out_of_slice_icp_options_raise(problem):
    """Trimmed ICP and the plane metric are in the port now and run (their
    parity: tests/test_torch_trimmed.py, tests/test_torch_plane.py); the
    plane metric without target normals raises ValueError, as in the JAX
    package."""
    src, tgt, R0, t0 = problem
    init = RigidTransform(torch.from_numpy(R0), torch.from_numpy(t0))
    corr = exact_correspondence(torch.from_numpy(tgt))
    res = run_icp(torch.from_numpy(src), corr, init, IcpParams(trim_fraction=0.1))
    assert torch.isfinite(res.sse).all() and (res.iters > 0).all()
    with pytest.raises(ValueError, match="normals"):
        run_icp(torch.from_numpy(src), corr, init, IcpParams(metric="plane"))
    from goicp_tpu_torch.geo.normals import estimate_normals

    t = torch.from_numpy(tgt)
    res = run_icp(torch.from_numpy(src), exact_correspondence(t, normals=estimate_normals(t)),
                  init, IcpParams(metric="plane"))
    assert torch.isfinite(res.sse).all() and (res.iters > 0).all()
