"""Each Hopper kernel against its plain PyTorch version on the card.

Marked ``gpu``: skipped without a CUDA device.  On the card, run with
``python -m pytest --noconftest -m gpu tests/test_torch_kernels.py`` (the
repo's conftest imports jax, which that machine does not have).

Expected agreement: K1, K3 and K4 round exactly as their plain versions
(the kernels use non-contracting intrinsics), so indices and distances are
equal, and K1 keeps the earliest index on every tie, on each of its routes; K2, K5, K6 and K7 reduce their sums in another order, so ub and lb
agree to rtol 1e-5 / atol 1e-5, and the screened sets may differ only for
nodes whose lb lies within that tolerance of the threshold.  The trimmed
kernels' per-point terms are bit-equal, so their bisection thresholds are
too; only the final sums differ by order.
"""

import numpy as np
import pytest
import torch

from goicp_tpu_torch.geo.rotation import axis_angle_rotation
from goicp_tpu_torch.nn import fused
from goicp_tpu_torch.nn.agree import screened_agree, trim_levels
from goicp_tpu_torch.nn.brute import nearest_neighbor

pytestmark = pytest.mark.gpu


@pytest.fixture(scope="module")
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _cloud(rng, n, dev):
    return torch.as_tensor(rng.uniform(-0.5, 0.5, (n, 3)).astype(np.float32), device=dev)


def tie_cloud(rng):
    """700 targets and 300 queries built for ties: targets 350-649 repeat
    0-299, the six axis points at 0.25 sit at 650-655 and again at 660-665
    (1/16 from the origin, exactly), and 40 queries sit at the origin; any
    other target near the origin is moved off to (0.49, 0.49, 0.49)."""
    tgt = rng.uniform(-0.5, 0.5, (700, 3)).astype(np.float32)
    tgt[350:650] = tgt[0:300]
    axes = (0.25 * np.concatenate([np.eye(3), -np.eye(3)])).astype(np.float32)
    tgt[650:656], tgt[660:666] = axes, axes[::-1]
    near = (tgt ** 2).sum(1) < 0.07
    near[650:656] = near[660:666] = False
    tgt[near] = 0.49
    q = rng.uniform(-0.5, 0.5, (300, 3)).astype(np.float32)
    q[:40] = 0.0
    return q, tgt


def earliest_argmin(q, tgt):
    """The earliest nearest target, from f32 distances in the kernels' order."""
    dx, dy, dz = (tgt[None, :, k] - q[:, None, k] for k in range(3))
    return np.argmin((dx * dx + dy * dy) + dz * dz, axis=1)


def _k1_agrees(q, t, d2, idx):
    """K1's output against the plain version: equal indices, bit-equal d2,
    and d2 = _sq3(q − t[idx]) (what the CPU route recomputes)."""
    torch.cuda.synchronize()
    d2_p, idx_p = nearest_neighbor(q, t)
    assert torch.equal(idx, idx_p)
    assert torch.equal(d2, d2_p)
    assert torch.equal(d2, fused._sq3(q - t.index_select(0, idx)))


# random; in-round refine (8 poses x 1,518); coarse multistart (64 x 512
# against 512); full-resolution multistart (64 x 1,518); a million queries
@pytest.mark.parametrize("nq,nt", [(300, 700), (8 * 1518, 1797), (64 * 512, 512),
                                   (64 * 1518, 1797), (1_100_000, 1797)])
def test_k1_nearest_neighbor(cuda, nq, nt):
    rng = np.random.default_rng(1)
    q, t = _cloud(rng, nq, cuda), _cloud(rng, nt, cuda)
    _k1_agrees(q, t, *fused.nearest_neighbor_mxu(q, t))
    _k1_agrees(q, t, *fused.nearest_neighbor_mxu(q, t, packed=fused.pack_nn_targets(t)))


# every route on the tie cloud, and on a target set above the resident limit
@pytest.mark.parametrize("route", [(1, 1), (2, 1), (4, 1), (8, 1), (1, 4), (4, 4), (8, 4)])
@pytest.mark.parametrize("case", ["ties", "ring"])
def test_k1_routes(cuda, route, case):
    rng = np.random.default_rng(8)
    if case == "ties":
        q, t = (torch.as_tensor(x, device=cuda) for x in tie_cloud(rng))
        want = torch.as_tensor(earliest_argmin(q.cpu().numpy(), t.cpu().numpy()), device=cuda)
    else:
        q, t = _cloud(rng, 2000, cuda), _cloud(rng, 20000, cuda)
        t[19000:19100] = q[:100]            # exact hits late, duplicated earlier
        t[7000:7100] = q[:100]
        want = None
    d2, idx = fused._nn_kernel(q, fused.pack_nn_targets(t), t.shape[0], route=route)
    _k1_agrees(q, t, d2, idx)
    if want is not None:
        assert torch.equal(idx.long(), want)
    else:
        assert torch.equal(idx[:100].long(), torch.arange(7000, 7100, device=cuda))


@pytest.mark.parametrize("n_sub", [8192, 32768])
def test_k1_coverage_shape(cuda, n_sub):
    """The full-cloud certificate's coverage order: 40,256 queries against a
    subset of themselves (on the ring route above 6,144 targets), with
    duplicated points, so every subset member and its twins tie at d² = 0
    and the earliest subset index must win."""
    rng = np.random.default_rng(9)
    full = rng.uniform(-0.5, 0.5, (40256, 3)).astype(np.float32)
    full[20000:22000] = full[:2000]
    idx = np.sort(rng.choice(40256, n_sub, replace=False))
    q = torch.as_tensor(full, device=cuda)
    t = q[torch.as_tensor(idx, device=cuda)]
    d2, nn = fused.nearest_neighbor_mxu(q, t)
    _k1_agrees(q, t, d2, nn)
    hits = torch.as_tensor(idx, device=cuda)
    assert bool((d2[hits] == 0).all())


def test_k5_limit_refuses_a_trimmed_screen_full_cert(cuda, monkeypatch):
    """K5 keeps a node's [2, Np] terms in shared memory and refuses a source
    above ~29,000 points; a trimmed full cert on ``bound_backend="screen"``
    that would grow its subset past that raises before the first solve."""
    from goicp_tpu_torch.bnb import BnbParams, fullcert

    with pytest.raises(RuntimeError):
        fused.k5_plan(1, 40320, 1920)
    assert fused.k5_plan(1, 16384, 1920)["smem"] > 0

    def no_solve(*a, **k):
        raise AssertionError("reached a solve")

    monkeypatch.setattr(fullcert, "make_solver", no_solve)
    rng = np.random.default_rng(1)
    src = rng.uniform(-0.5, 0.5, (40256, 3)).astype(np.float32)
    p = BnbParams(trim_fraction=0.25, bound_backend="screen")
    with pytest.raises(ValueError, match="shared-memory"):
        fullcert.register_full_cert(src, src[:1797], p, max_refinements=3)
    with pytest.raises(AssertionError, match="reached a solve"):    # within the limit
        fullcert.register_full_cert(src, src[:1797], p, max_refinements=0)


def _nodes(rng, B, dev):
    R = axis_angle_rotation(torch.as_tensor(
        rng.uniform(-np.pi, np.pi, (B, 3)).astype(np.float32), device=dev))
    t = torch.as_tensor(rng.uniform(-0.2, 0.2, (B, 3)).astype(np.float32), device=dev)
    return R, t


# T-round shapes; the full-cloud certificate's grown subsets (16,384 and the
# whole 40,256-point bunny), with few groups so the plain version stays quick
@pytest.mark.parametrize("G,n,nt", [(5, 300, 700), (263, 1518, 1797), (5, 16384, 1797),
                                    (5, 40256, 1797)])
def test_k3_min_d2_groups(cuda, G, n, nt):
    rng = np.random.default_rng(2)
    src, tgt = _cloud(rng, n, cuda), _cloud(rng, nt, cuda)
    R, _ = _nodes(rng, G, cuda)
    t8 = torch.as_tensor(rng.uniform(-0.2, 0.2, (G, 8, 3)).astype(np.float32), device=cuda)
    srcT, wm = fused.pack_sources(src), fused.pack_targets(tgt)
    gp = fused.pack_group_params(R, t8)
    got = fused.min_d2_groups(srcT, wm, gp)
    torch.cuda.synchronize()
    ref = fused.min_d2_groups_plain(srcT, wm, gp)
    torch.testing.assert_close(got, ref, rtol=1e-6, atol=1e-7)


@pytest.mark.parametrize("B,n,nt", [(37, 300, 700), (2048, 1518, 1797), (16, 16384, 1797),
                                    (16, 40256, 1797)])
@pytest.mark.parametrize("screen", [False, True])
def test_k2_bounds_nodes(cuda, B, n, nt, screen):
    rng = np.random.default_rng(3)
    src, tgt = _cloud(rng, n, cuda), _cloud(rng, nt, cuda)
    R, t = _nodes(rng, B, cuda)
    norms = torch.linalg.vector_norm(src, dim=1)
    af = torch.as_tensor(rng.uniform(0, 0.3, B).astype(np.float32), device=cuda)
    gt = torch.as_tensor(rng.uniform(0, 0.05, B).astype(np.float32), device=cuda)
    srcT, wm = fused.pack_sources_ext(src, norms), fused.pack_targets(tgt)
    thresh = 1e30
    if screen:
        _, lb = fused.bounds_nodes_plain(srcT, wm, fused.pack_params_bounds(R, t, af, gt, 0.0, 1e30))
        thresh = float(lb.median())
    params = fused.pack_params_bounds(R, t, af, gt, 0.0, thresh)
    ub, lb = fused.bounds_nodes(srcT, wm, params)
    torch.cuda.synchronize()
    _agree_screened(ub, lb, *fused.bounds_nodes_plain(srcT, wm, params), thresh, thresh,
                    screen=screen)


def _agree_screened(ub, lb, ub_p, lb_p, thresh, scale, group=1, screen=False):
    """``nn/agree.py``'s rule (the one ``chip_smoke.py`` applies); a
    screened case must screen some units of ``group`` and not others."""
    ok, err, nscr, differ = screened_agree(ub, lb, ub_p, lb_p, thresh, scale, group)
    assert ok, f"max |err| {err}, screened-set differences {differ}"
    if screen:
        assert 0 < nscr < ub_p.numel() // group


# B·Np not a multiple of a CTA's 1,024 queries; the R-round bucket; a
# target set above the resident limit (the ring of target tiles); the
# full-cloud certificate's grown subsets
@pytest.mark.parametrize("B,n,nt", [(37, 300, 700), (21080, 1518, 1797), (16, 1518, 20000),
                                    (16, 16384, 1797), (16, 40256, 1797)])
def test_k4_min_d2_nodes(cuda, B, n, nt):
    rng = np.random.default_rng(4)
    src, tgt = _cloud(rng, n, cuda), _cloud(rng, nt, cuda)
    R, t = _nodes(rng, B, cuda)
    srcT, wm, params = fused.pack_sources(src), fused.pack_targets(tgt), fused.pack_params(R, t)
    got = fused.min_d2_nodes(srcT, wm, params)
    torch.cuda.synchronize()
    assert torch.equal(got, fused.min_d2_nodes_plain(srcT, wm, params))


def test_k4_unpadded_source(cuda):
    """A source of Np = 300 columns (not a multiple of 128)."""
    rng = np.random.default_rng(5)
    srcT = torch.zeros((8, 300), device=cuda)
    srcT[:3] = _cloud(rng, 300, cuda).T
    wm = fused.pack_targets(_cloud(rng, 700, cuda))
    params = fused.pack_params(*_nodes(rng, 7, cuda))
    got = fused.min_d2_nodes(srcT, wm, params)
    torch.cuda.synchronize()
    assert torch.equal(got, fused.min_d2_nodes_plain(srcT, wm, params))


@pytest.mark.parametrize("B,n,nt", [(37, 300, 700), (2048, 1518, 1797)])
@pytest.mark.parametrize("screen", [False, True])
def test_k5_bounds_nodes_trimmed(cuda, B, n, nt, screen):
    rng = np.random.default_rng(5)
    src, tgt = _cloud(rng, n, cuda), _cloud(rng, nt, cuda)
    R, t = _nodes(rng, B, cuda)
    t[::2] += 1.5                       # every other node far off: it screens
    norms = torch.linalg.vector_norm(src, dim=1)
    af = torch.as_tensor(rng.uniform(0, 0.3, B).astype(np.float32), device=cuda)
    gt = torch.as_tensor(rng.uniform(0, 0.05, B).astype(np.float32), device=cuda)
    srcT, wm = fused.pack_sources_ext(src, norms), fused.pack_targets(tgt)
    h = int(round(0.75 * n))
    drop = n - h
    thresh, te, tau = 1e30, 1e30, 1e30
    if screen:
        _, lb = fused.bounds_nodes_trimmed_plain(
            srcT, wm, fused.pack_params_bounds_trimmed(R, t, af, gt, 0.0, 1e30, 1e30),
            h=h, drop=drop)
        thresh, te, tau = trim_levels(lb, h, drop)
    params = fused.pack_params_bounds_trimmed(R, t, af, gt, 0.0, te, tau)
    ub, lb = fused.bounds_nodes_trimmed(srcT, wm, params, h=h, drop=drop)
    torch.cuda.synchronize()
    ub_p, lb_p = fused.bounds_nodes_trimmed_plain(srcT, wm, params, h=h, drop=drop)
    _agree_screened(ub, lb, ub_p, lb_p, thresh, te, screen=screen)


def _groups(rng, G, n, nt, dev):
    src, tgt = _cloud(rng, n, dev), _cloud(rng, nt, dev)
    R, _ = _nodes(rng, G, dev)
    t8 = rng.uniform(-0.3, 0.3, (G, 8, 3)).astype(np.float32)
    t8[::2] += 1.5                      # every other group far off: it screens
    t8 = torch.as_tensor(t8, device=dev)
    af = torch.as_tensor(rng.uniform(0, 0.3, G).astype(np.float32), device=dev)
    gt8 = torch.as_tensor(rng.uniform(0, 0.05, (G, 8)).astype(np.float32), device=dev)
    srcT = fused.pack_sources_ext(src, torch.linalg.vector_norm(src, dim=1))
    return srcT, fused.pack_targets(tgt), R, t8, af, gt8


# (5, 4096, 700): the Np ≥ 4,096 shape (a global scratch, as every K6 launch)
@pytest.mark.parametrize("G,n,nt", [(5, 300, 700), (263, 1518, 1797), (5, 4096, 700)])
@pytest.mark.parametrize("screen", [False, True])
def test_k6_bounds_groups_trimmed(cuda, G, n, nt, screen):
    rng = np.random.default_rng(6)
    srcT, wm, R, t8, af, gt8 = _groups(rng, G, n, nt, cuda)
    Np = srcT.shape[1]
    tq = fused._pick_tile(Np, fused.TQB)
    assert fused._k6_ctas(cuda.index or 0, tq, fused.k6_qr(tq)) > 0
    h = int(round(0.75 * n))
    drop = n - h
    thresh, te, tau = 1e30, 1e30, 1e30
    if screen:
        _, lb = fused.bounds_groups_trimmed_plain(
            srcT, wm, fused.pack_group_params_bounds_trimmed(R, t8, af, gt8, 0.0, 1e30, 1e30),
            h=h, drop=drop)
        thresh, te, tau = trim_levels(lb, h, drop)
    params = fused.pack_group_params_bounds_trimmed(R, t8, af, gt8, 0.0, te, tau)
    ub, lb = fused.bounds_groups_trimmed(srcT, wm, params, h=h, drop=drop)
    torch.cuda.synchronize()
    ub_p, lb_p = fused.bounds_groups_trimmed_plain(srcT, wm, params, h=h, drop=drop)
    _agree_screened(ub, lb, ub_p, lb_p, thresh, te, group=8, screen=screen)


@pytest.mark.parametrize("G,n,nt", [(5, 300, 700), (263, 1518, 1797)])
@pytest.mark.parametrize("screen", [False, True])
def test_k7_bounds_groups(cuda, G, n, nt, screen):
    rng = np.random.default_rng(7)
    srcT, wm, R, t8, af, gt8 = _groups(rng, G, n, nt, cuda)
    thresh = 1e30
    if screen:
        _, lb = fused.bounds_groups_plain(
            srcT, wm, fused.pack_group_params_bounds(R, t8, af, gt8, 0.0, 1e30))
        thresh = float(lb.reshape(G, 8).amin(1).median())
    params = fused.pack_group_params_bounds(R, t8, af, gt8, 0.0, thresh)
    ub, lb = fused.bounds_groups(srcT, wm, params)
    torch.cuda.synchronize()
    ub_p, lb_p = fused.bounds_groups_plain(srcT, wm, params)
    _agree_screened(ub, lb, ub_p, lb_p, thresh, thresh, group=8, screen=screen)


# --- K5 and K6 at every point-block size, batch, screen mode, h and route ---
# n = 100, 1,000, 1,518, 8,192: Np = 128, 1,024, 1,536, 8,192 and tq = 128,
# 256, 384, 256.  Batches of 37 and 1,001 nodes or groups are no multiple of
# what a CTA walks; 2,049 nodes spill past one wave of warps.


def _trimmed_levels(plain, args, h, drop, mode):
    """``(thresh, thresh', τ)`` of a case: "open" screens nothing, "screen"
    puts thresh at half the median positive lb, "masked" gives every row
    thresh' = -inf (as ``bnb/se3_eval.py`` masks rows)."""
    if mode == "open":
        return 1e30, 1e30, 1e30
    if mode == "masked":
        return 0.0, -float("inf"), 0.01
    _, lb = plain(*args(1e30, 1e30), h=h, drop=drop)
    return trim_levels(lb, h, drop)


def _trimmed_agree(kernel, plain, args, h, drop, mode, group=1):
    thresh, te, tau = _trimmed_levels(plain, args, h, drop, mode)
    ub, lb = kernel(*args(te, tau))
    torch.cuda.synchronize()
    ub_p, lb_p = plain(*args(te, tau), h=h, drop=drop)
    if mode == "masked":
        assert bool((ub == 1e30).all()) and torch.equal(lb, lb_p)
        return
    _agree_screened(ub, lb, ub_p, lb_p, thresh, te, group=group, screen=mode == "screen")


def _source(rng, n, dev, dup):
    """A cloud of n points; ``dup``: 10 copies of each of n/10 points, so
    equal terms sit at the bisection's threshold."""
    src = _cloud(rng, n, dev)
    return src[torch.arange(n, device=dev) % max(1, n // 10)] if dup else src


K5_CASES = [(37, 100, 700), (1001, 1000, 1797), (2049, 1518, 1797), (37, 8192, 1797),
            (37, 1518, 6144), (37, 1518, 6145), (16, 1518, 20000)]


# targets resident (Mp ≤ 6,144) and read from global memory (6,145 and
# 20,000 targets), Np = 8,192 (the bound_points cap)
@pytest.mark.parametrize("B,n,nt", K5_CASES)
@pytest.mark.parametrize("mode", ["open", "screen", "masked"])
def test_k5_shapes(cuda, B, n, nt, mode):
    rng = np.random.default_rng(9)
    src, tgt = _source(rng, n, cuda, False), _cloud(rng, nt, cuda)
    R, t = _nodes(rng, B, cuda)
    t[::2] += 1.5
    af = torch.as_tensor(rng.uniform(0, 0.3, B).astype(np.float32), device=cuda)
    gt = torch.as_tensor(rng.uniform(0, 0.05, B).astype(np.float32), device=cuda)
    srcT = fused.pack_sources_ext(src, torch.linalg.vector_norm(src, dim=1))
    wm = fused.pack_targets(tgt)
    plan = fused.k5_plan(B, srcT.shape[1], wm.shape[0])
    assert plan["targets_resident"] == (wm.shape[0] <= 6144)
    h = int(round(0.75 * n))

    def args(te, tau):
        return srcT, wm, fused.pack_params_bounds_trimmed(R, t, af, gt, 0.0, te, tau)

    _trimmed_agree(lambda *a: fused.bounds_nodes_trimmed(*a, h=h, drop=n - h),
                   fused.bounds_nodes_trimmed_plain, args, h, n - h, mode)


# h close to N and h small, on a source of duplicated points.  At h = 5 a
# screened lb = Σl̃ - drop·τ (τ = 2·thresh/h) cancels ~2N/h-fold, so its
# reduction-order error outgrows the rtol: h = 5 runs unscreened and
# masked, and the screen at a small h runs at h = 50.
@pytest.mark.parametrize("h,modes", [(999, ("open", "screen")), (50, ("open", "screen")),
                                     (5, ("open", "masked")), (750, ("open", "screen"))],
                         ids=["h=n-1", "h=50", "h=5", "h=0.75n"])
@pytest.mark.parametrize("kind", ["k5", "k6"])
def test_trimmed_h_and_duplicates(cuda, h, modes, kind):
    rng = np.random.default_rng(10)
    n, nt, count = 1000, 1797, 263
    src = _source(rng, n, cuda, dup=True)
    tgt = _cloud(rng, nt, cuda)
    srcT = fused.pack_sources_ext(src, torch.linalg.vector_norm(src, dim=1))
    wm = fused.pack_targets(tgt)
    if kind == "k5":
        R, t = _nodes(rng, count, cuda)
        t[::2] += 1.5
        af = torch.as_tensor(rng.uniform(0, 0.3, count).astype(np.float32), device=cuda)
        gt = torch.as_tensor(rng.uniform(0, 0.05, count).astype(np.float32), device=cuda)

        def args(te, tau):
            return srcT, wm, fused.pack_params_bounds_trimmed(R, t, af, gt, 0.0, te, tau)

        kernel, plain, group = fused.bounds_nodes_trimmed, fused.bounds_nodes_trimmed_plain, 1
    else:
        _, _, R, t8, af, gt8 = _groups(rng, count, 10, 10, cuda)

        def args(te, tau):
            return srcT, wm, fused.pack_group_params_bounds_trimmed(R, t8, af, gt8, 0.0, te, tau)

        kernel, plain, group = fused.bounds_groups_trimmed, fused.bounds_groups_trimmed_plain, 8
    for mode in modes:
        _trimmed_agree(lambda *a: kernel(*a, h=h, drop=n - h), plain, args, h, n - h, mode,
                       group=group)


K6_CASES = [(5, 100, 700), (1001, 1000, 1797), (263, 1518, 1797), (5, 8192, 700)]


@pytest.mark.parametrize("G,n,nt", K6_CASES)
@pytest.mark.parametrize("mode", ["open", "screen", "masked"])
def test_k6_shapes(cuda, G, n, nt, mode):
    rng = np.random.default_rng(11)
    srcT, wm, R, t8, af, gt8 = _groups(rng, G, n, nt, cuda)
    h = int(round(0.75 * n))

    def args(te, tau):
        return srcT, wm, fused.pack_group_params_bounds_trimmed(R, t8, af, gt8, 0.0, te, tau)

    _trimmed_agree(lambda *a: fused.bounds_groups_trimmed(*a, h=h, drop=n - h),
                   fused.bounds_groups_trimmed_plain, args, h, n - h, mode, group=8)


# every launch route: K5's warps per CTA, K6's points per thread
@pytest.mark.parametrize("route", [("k5", w) for w in range(1, 9)]
                         + [("k6", qr) for qr in (1, 2, 3)])
def test_trimmed_routes(cuda, route):
    kind, r = route
    rng = np.random.default_rng(12)
    n, nt, count = 1518, 1797, 301
    h = int(round(0.75 * n))
    if kind == "k5":
        src, tgt = _cloud(rng, n, cuda), _cloud(rng, nt, cuda)
        R, t = _nodes(rng, count, cuda)
        t[::2] += 1.5
        af = torch.as_tensor(rng.uniform(0, 0.3, count).astype(np.float32), device=cuda)
        gt = torch.as_tensor(rng.uniform(0, 0.05, count).astype(np.float32), device=cuda)
        srcT = fused.pack_sources_ext(src, torch.linalg.vector_norm(src, dim=1))
        wm = fused.pack_targets(tgt)
        assert fused.k5_plan(count, srcT.shape[1], wm.shape[0], r)["warps"] == r

        def args(te, tau):
            return srcT, wm, fused.pack_params_bounds_trimmed(R, t, af, gt, 0.0, te, tau)

        kernel = lambda *a: fused._k5_kernel(*a, h, n - h, warps=r)  # noqa: E731
        plain, group = fused.bounds_nodes_trimmed_plain, 1
    else:
        srcT, wm, R, t8, af, gt8 = _groups(rng, count, n, nt, cuda)

        def args(te, tau):
            return srcT, wm, fused.pack_group_params_bounds_trimmed(R, t8, af, gt8, 0.0, te, tau)

        kernel = lambda *a: fused._k6_kernel(*a, h, n - h, qr=r)  # noqa: E731
        plain, group = fused.bounds_groups_trimmed_plain, 8
    for mode in ("open", "screen"):
        _trimmed_agree(kernel, plain, args, h, n - h, mode, group=group)
