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
from tests.test_torch_kernels import earliest_argmin, tie_cloud  # noqa: E402

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


def test_nearest_neighbor_ties_on_duplicated_targets():
    """Queries equidistant from several targets, and targets duplicated far
    apart in the cloud: the earliest index wins in the plain version (the
    rule K1's merge of target splits keeps) and in the JAX package's kernel,
    with the same d2."""
    q, tgt = tie_cloud(np.random.default_rng(9))
    want = earliest_argmin(q, tgt)
    assert np.all(want[:40] == 650)
    assert (want < 300).sum() > 100          # the duplicate at +350 loses
    d2_t, idx_t = fused.nearest_neighbor_mxu(torch.from_numpy(q), torch.from_numpy(tgt))
    assert np.array_equal(idx_t.numpy(), want)
    d2_j, idx_j = mxu.nearest_neighbor_mxu(q, tgt, interpret=True)
    assert np.array_equal(_np(idx_j), want)
    np.testing.assert_allclose(d2_t.numpy(), _np(d2_j), rtol=1e-5, atol=1e-7)
    assert np.all(d2_t.numpy()[:40] == np.float32(0.0625))


def test_pack_nn_targets_is_the_first_four_columns(scene):
    got = fused.pack_nn_targets(scene["tgt"]).numpy()
    ref = _np(mxu.pack_targets(scene["tgt"]))[:, :4]
    assert got.shape == (768, 4) and np.array_equal(got.view(np.uint32), ref.view(np.uint32))


@pytest.mark.parametrize("Q,Mp,want", [
    (8 * 1518, 1920, (8, 1)),      # in-round refine: 380 CTAs of 32 queries
    (1518, 1920, (8, 1)),          # one pose (scoring, polish)
    (64 * 512, 512, (4, 4)),       # coarse multistart: 256 queries a CTA
    (64 * 1518, 1920, (4, 4)),     # full-resolution multistart
    (100, 128, (2, 1)),            # at least 64 targets a split
    (64 * 512, 128, (2, 4)),
    (256, 64, (1, 1)),
])
def test_nn_route(Q, Mp, want):
    assert fused.nn_route(Q, Mp, 132) == want


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


def test_bounds_nodes_k2_plain_matches_jax_long_nodes():
    """K2's plain version against the interpreted JAX kernel with nb = 10
    point blocks a node (Np = 3,840, tq = 384; 500 targets), thresholds per
    node at a chosen block boundary: after the first block, in the middle,
    before the last, after the last (every block runs), and never.  The
    screened sets and the blocks each node ran are equal; ub and lb agree
    to rtol 1e-5 + atol 1e-5."""
    rng = np.random.default_rng(77)
    n, nt, nodes = 3840, 500, 8
    src = (rng.random((n, 3)).astype(np.float32) - 0.5) * 0.6
    tgt = (rng.random((nt, 3)).astype(np.float32) - 0.5) * 0.6
    R = _rot(rng, nodes)
    t = (0.6 + (rng.random((nodes, 3)) - 0.5) * 0.2).astype(np.float32)   # off the target
    norms = np.linalg.norm(src, axis=1).astype(np.float32)
    af = rng.uniform(0.0, 0.2, nodes).astype(np.float32)
    gt = rng.uniform(0.0, 0.02, nodes).astype(np.float32)
    srcT_t = fused.pack_sources_ext(src, norms)
    wm_t = fused.pack_targets(tgt)
    p_open = fused.pack_params_bounds(R, t, af, gt, 0.0, 1e30)
    _, lb_blk = fused.bounds_block_sums_plain(srcT_t, wm_t, p_open)
    nb = lb_blk.shape[1]
    assert nb == 10
    cum = torch.cumsum(lb_blk.double(), 1)
    at = [0, nb // 2, nb - 2, nb - 1, 0, nb // 2, nb - 2, None]     # None: never screened
    thresh = np.array([1e30 if j is None else
                       float(cum[i, j] - (0.5 * lb_blk[i, j] if j < nb - 1 else 0.0))
                       for i, j in enumerate(at)], np.float32)
    thresh[3] = thresh[3] * (1.0 - 1e-3)         # after the last block: crossed there
    pj = np.array(mxu.pack_params_bounds(R, t, af, gt, 0.0, 1e30))
    pj[:, 15] = thresh
    ub_j, lb_j = (_np(x) for x in mxu.bounds_nodes(
        mxu.pack_sources_ext(src, norms), mxu.pack_targets(tgt), pj, interpret=True))
    pt = p_open.clone()
    pt[:, 15] = torch.from_numpy(thresh)
    ub_t, lb_t = fused.bounds_nodes(srcT_t, wm_t, pt)
    ub_blk, lb_blk2 = fused.bounds_block_sums_plain(srcT_t, wm_t, pt)
    _, _, blocks = fused.screen_scan(ub_blk, lb_blk2, pt[:, 15])
    want = [1 if j is None else j + 1 for j in at[:-1]] + [nb]
    assert blocks.tolist() == want
    scr_j, scr_t = lb_j >= thresh, lb_t.numpy() >= thresh
    assert np.array_equal(scr_j, scr_t) and scr_t.tolist() == [True] * 7 + [False]
    np.testing.assert_allclose(lb_t.numpy(), lb_j, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(ub_t.numpy(), ub_j, rtol=1e-5, atol=1e-5)
    assert np.all(ub_t.numpy()[scr_t] == 1e30) and ub_t[7] < 1e29


def test_wrappers_reject_mixed_devices(scene):
    s = scene
    srcT = fused.pack_sources(s["src"])
    with pytest.raises(ValueError):
        fused.min_d2_groups(srcT, fused.pack_targets(s["tgt"]).to("meta"),
                            fused.pack_group_params(s["Rg"], s["t8"]))
