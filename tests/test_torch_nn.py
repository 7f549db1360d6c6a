"""The port's K1/K2/K3 plain versions and pack_* functions against the JAX
package's Pallas kernels (interpret mode) on the same numpy inputs.

Sizes are not multiples of 128 (300 sources, 700 targets) so the padding
paths run.  Tolerance: rtol 1e-5, atol 1e-5 (tests/test_mxu.py:148);
indices and screened-node sets must be equal, packs bit-identical.
"""

import numpy as np
import pytest

pytest.importorskip("jax")

import torch  # noqa: E402

from goicp_tpu.nn import brute as jbrute  # noqa: E402
from goicp_tpu.nn import mxu  # noqa: E402
from goicp_tpu_torch.nn import brute, fused  # noqa: E402

torch.set_num_threads(1)

N, NT, B, G = 300, 700, 12, 3


def _rot(rng, n):
    from goicp_tpu_torch.geo.rotation import random_rotations

    return random_rotations(n, rng)


@pytest.fixture(scope="module")
def scene():
    rng = np.random.default_rng(2024)
    src = (rng.random((N, 3)).astype(np.float32) - 0.5) * 0.6
    tgt = (rng.random((NT, 3)).astype(np.float32) - 0.5) * 0.6
    R = _rot(rng, B)
    t = ((rng.random((B, 3)) - 0.5) * 0.3).astype(np.float32)
    norms = np.linalg.norm(src, axis=1).astype(np.float32)
    af = rng.uniform(0.0, 0.5, B).astype(np.float32)
    gt = rng.uniform(0.0, 0.05, B).astype(np.float32)
    Rg = _rot(rng, G)
    t8 = ((rng.random((G, 8, 3)) - 0.5) * 0.3).astype(np.float32)
    return dict(src=src, tgt=tgt, R=R, t=t, norms=norms, af=af, gt=gt,
                Rg=Rg, t8=t8)


def _np(x):
    return np.array(x)  # a writable copy for torch.from_numpy


def test_pack_functions_bit_identical(scene):
    s = scene
    pairs = [
        (mxu.pack_targets(s["tgt"]), fused.pack_targets(s["tgt"])),
        (mxu.pack_sources(s["src"]), fused.pack_sources(s["src"])),
        (mxu.pack_sources_ext(s["src"], s["norms"]),
         fused.pack_sources_ext(s["src"], s["norms"])),
        (mxu.pack_params(s["R"], s["t"]), fused.pack_params(s["R"], s["t"])),
        (mxu.pack_group_params(s["Rg"], s["t8"]),
         fused.pack_group_params(s["Rg"], s["t8"])),
        (mxu.pack_params_bounds(s["R"], s["t"], s["af"], s["gt"], 0.01, 0.7),
         fused.pack_params_bounds(s["R"], s["t"], s["af"], s["gt"], 0.01, 0.7)),
    ]
    for ref, got in pairs:
        ref, got = _np(ref), got.numpy()
        assert ref.dtype == got.dtype and ref.shape == got.shape
        assert np.array_equal(ref.view(np.uint32), got.view(np.uint32))


def test_pick_tile_matches():
    for n in (128, 384, 768, 1536, 1920, 8192):
        for cap in (384, 512, 2048):
            assert fused._pick_tile(n, cap) == mxu._pick_tile(n, cap)


def test_nearest_neighbor_k1_plain_matches_jax(scene):
    s = scene
    q = np.einsum("bij,nj->bni", s["R"][:2], s["src"]) + s["t"][:2, None]
    q = q.astype(np.float32)                         # [2, 300, 3]
    d2_j, idx_j = mxu.nearest_neighbor_mxu(q, s["tgt"], interpret=True)
    d2_t, idx_t = fused.nearest_neighbor_mxu(torch.from_numpy(q),
                                             torch.from_numpy(s["tgt"]))
    assert idx_t.shape == (2, N) and idx_t.dtype == torch.int32
    assert np.array_equal(_np(idx_j), idx_t.numpy())
    np.testing.assert_allclose(d2_t.numpy(), _np(d2_j), rtol=1e-5, atol=1e-5)
    # the plain version itself against the JAX brute oracle
    d2_b, idx_b = jbrute.nearest_neighbor(q, s["tgt"])
    d2_p, idx_p = brute.nearest_neighbor(torch.from_numpy(q), torch.from_numpy(s["tgt"]))
    assert np.array_equal(_np(idx_b), idx_p.numpy())
    np.testing.assert_allclose(d2_p.numpy(), _np(d2_b), rtol=1e-5, atol=1e-5)


def test_nearest_neighbor_earliest_index_wins_ties():
    tgt = np.array([[1, 0, 0], [0, 1, 0], [1, 0, 0], [0, 0, 0.5]], np.float32)
    q = np.zeros((3, 3), np.float32)
    q[1] = [0.5, 0.5, 0.0]                          # tie between targets 0, 1, 2
    _, idx = fused.nearest_neighbor_mxu(torch.from_numpy(q), torch.from_numpy(tgt))
    _, idx_j = mxu.nearest_neighbor_mxu(q, tgt, interpret=True)
    assert np.array_equal(idx.numpy(), _np(idx_j))
    assert idx.tolist() == [3, 0, 3]


def test_min_d2_groups_k3_plain_matches_jax(scene):
    s = scene
    srcT, wm = mxu.pack_sources(s["src"]), mxu.pack_targets(s["tgt"])
    gp = mxu.pack_group_params(s["Rg"], s["t8"])
    ref = _np(mxu.min_d2_groups(srcT, wm, gp, interpret=True))
    got = fused.min_d2_groups(
        torch.from_numpy(_np(srcT)), torch.from_numpy(_np(wm)),
        torch.from_numpy(_np(gp)),
    ).numpy()
    assert got.shape == ref.shape == (8 * G, srcT.shape[1])
    np.testing.assert_allclose(got[:, :N], ref[:, :N], rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("screen", [False, True])
def test_bounds_nodes_k2_plain_matches_jax(scene, screen):
    s = scene
    srcT = mxu.pack_sources_ext(s["src"], s["norms"])
    wm = mxu.pack_targets(s["tgt"])
    thresh = 1e30
    if screen:
        # a threshold inside the spread of the full lower bounds, so some
        # nodes screen early and some do not
        p_full = mxu.pack_params_bounds(s["R"], s["t"], s["af"], s["gt"], 0.0, 1e30)
        _, lb_full = mxu.bounds_nodes(srcT, wm, p_full, interpret=True)
        thresh = float(np.median(_np(lb_full)))
    pj = mxu.pack_params_bounds(s["R"], s["t"], s["af"], s["gt"], 0.0, thresh)
    ub_j, lb_j = (_np(x) for x in mxu.bounds_nodes(srcT, wm, pj, interpret=True))
    pt = fused.pack_params_bounds(s["R"], s["t"], s["af"], s["gt"], 0.0, thresh)
    ub_t, lb_t = fused.bounds_nodes(
        torch.from_numpy(_np(srcT)), torch.from_numpy(_np(wm)), pt
    )
    ub_t, lb_t = ub_t.numpy(), lb_t.numpy()
    scr_j, scr_t = lb_j >= thresh, lb_t >= thresh
    assert np.array_equal(scr_j, scr_t)
    if screen:
        assert 0 < scr_j.sum() < B
    else:
        assert not scr_j.any()
    np.testing.assert_allclose(lb_t, lb_j, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(ub_t, ub_j, rtol=1e-5, atol=1e-5)
    assert np.all(ub_t[scr_t] == 1e30)


def test_wrappers_reject_mixed_devices(scene):
    s = scene
    srcT = fused.pack_sources(s["src"])
    with pytest.raises(ValueError):
        fused.min_d2_groups(srcT, fused.pack_targets(s["tgt"]).to("meta"),
                            fused.pack_group_params(s["Rg"], s["t8"]))
