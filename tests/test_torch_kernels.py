"""Each Hopper kernel against its plain PyTorch version on the card.

Marked ``gpu``: skipped without a CUDA device.  On the card, run with
``python -m pytest --noconftest -m gpu tests/test_torch_kernels.py`` (the
repo's conftest imports jax, which that machine does not have).

Expected agreement: K1, K3 and K4 round exactly as their plain versions
(the kernels use non-contracting intrinsics), so indices and distances are
equal, and K1 keeps the earliest index on every tie, on each of its
routes; K2, K5, K6 and K7 reduce their sums in another order, so ub and lb
agree to rtol 1e-5 / atol 1e-5, and the screened sets may differ only for
nodes whose lb lies within that tolerance of the threshold.  K2 is also
bit-equal to ``fused.bounds_nodes_kernel_order``, its arithmetic in its own
summation order, on every launch plan.  The trimmed
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


def test_trimmed_screen_full_cert_reaches_the_whole_source(cuda, monkeypatch):
    """A trimmed full cert on ``bound_backend="screen"`` grows its subset
    from 20,128 points to the whole 40,256 (K5 at Np = 20,224 and 40,320,
    each warp's [2, Np] scratch in global memory)."""
    from goicp_tpu_torch.bnb import BnbParams, fullcert

    rng = np.random.default_rng(1)
    src = rng.uniform(-0.5, 0.5, (40256, 3)).astype(np.float32)
    R = axis_angle_rotation(torch.as_tensor([[0.1, -0.2, 0.05]])).numpy()[0]
    tgt = (src[np.sort(rng.choice(40256, 1797, replace=False))] @ R.T + 0.02).astype(np.float32)
    seen = []
    k5 = fused._k5_kernel

    def spy(srcT_ext, wm, params, *a, **k):
        seen.append(srcT_ext.shape[1])
        return k5(srcT_ext, wm, params, *a, **k)

    monkeypatch.setattr(fused, "_k5_kernel", spy)
    p = BnbParams(trim_fraction=0.25, bound_backend="screen", mse_threshold=1e-9, max_rounds=3,
                  max_wall_s=5.0)
    res = fullcert.register_full_cert(src, tgt, p, max_refinements=3)
    assert res.metrics.counters["fullcert_subset"] == 40256
    assert 40320 in seen and 20224 in seen
    assert np.isfinite(res.sse_full) and res.gap_full is not None


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
    ub_o, lb_o = fused.bounds_nodes_kernel_order(srcT, wm, params)
    assert torch.equal(ub, ub_o) and torch.equal(lb, lb_o)


def _k2_lb_blocks(srcT, wm, params):
    """The lb's block sums in K2's summation order, ``[B, nb]``."""
    tq = fused._pick_tile(srcT.shape[1], fused.TQB)
    return fused._warp_order_sums(fused._k2_terms(srcT, wm, params)[1], tq)


def _k2_boundary_case(rng, B, n, nt, dev):
    """K2's inputs with a threshold per node that makes its screen fall at a
    chosen block boundary, by node index mod 6: before the first block
    (thresh 0), after the first, in the middle, before the last (thresholds
    halfway into the block that crosses them), after the last (thresh equal
    to the whole lb: every block runs, ub = 1e30), never.  The nodes lie
    off the target, so each block adds a positive lb; every seventh point
    is masked (valid = 0).  Returns (srcT, wm, params, blocks each node must
    run)."""
    src, tgt = _cloud(rng, n, dev), _cloud(rng, nt, dev)
    R, t = _nodes(rng, B, dev)
    t += 1.0
    af = torch.as_tensor(rng.uniform(0, 0.3, B).astype(np.float32), device=dev)
    gt = torch.as_tensor(rng.uniform(0, 0.05, B).astype(np.float32), device=dev)
    srcT = fused.pack_sources_ext(src, torch.linalg.vector_norm(src, dim=1))
    srcT[4, ::7] = 0.0
    wm = fused.pack_targets(tgt)
    params = fused.pack_params_bounds(R, t, af, gt, 0.0, 1e30)
    blk = _k2_lb_blocks(srcT, wm, params)
    nb = blk.shape[1]
    cum = torch.cumsum(blk.double(), 1)
    rows = torch.arange(B, device=dev)
    kind = rows % 6
    at = torch.stack([torch.zeros_like(kind), torch.zeros_like(kind),
                      torch.full_like(kind, nb // 2), torch.full_like(kind, max(nb - 2, 0)),
                      torch.full_like(kind, nb - 1), torch.zeros_like(kind)])[kind, rows]
    thresh = (cum[rows, at] - 0.5 * blk[rows, at].double()).float()
    _, lb_all = fused.bounds_nodes_kernel_order(srcT, wm, params)
    thresh = torch.where(kind == 4, lb_all, thresh)
    thresh = torch.where(kind == 0, torch.zeros_like(thresh), thresh)
    thresh = torch.where(kind == 5, torch.full_like(thresh, 1e30), thresh)
    params[:, 15] = thresh
    runs = torch.where(kind == 0, 0, torch.where(kind == 5, nb, at + 1))
    return srcT, wm, params, runs


# (B, n, nt): nb = 1 (tq 384 and 128), 4 (tq 384 and 256) and 105 blocks
# (the full cert's whole source), odd B and B below the SM count
K2_CASES = [(37, 300, 700), (13, 100, 700), (101, 1518, 1797), (21, 1000, 700),
            (7, 40256, 700)]
# the plan's pick; one warp in all (k = 1, the serial scan); few CTAs of a
# few warps; the largest CTA
K2_SCHEDULES = [dict(), dict(warps=1, grid=1), dict(warps=3, grid=5), dict(warps=8)]


@pytest.mark.parametrize("B,n,nt", K2_CASES)
@pytest.mark.parametrize("sched", range(len(K2_SCHEDULES)))
@pytest.mark.parametrize("route", ["resident", "ring"])
def test_k2_plans_and_boundaries(cuda, B, n, nt, sched, route):
    """K2 on every launch route and schedule, screened at each block
    boundary: bit-equal to its plain version in the kernel's summation
    order, within the stated tolerance of the plain version, and every node
    screened where its threshold puts it."""
    rng = np.random.default_rng(13)
    srcT, wm, params, runs = _k2_boundary_case(rng, B, n, nt, cuda)
    kw = dict(K2_SCHEDULES[sched], route=route)
    plan = fused.k2_plan(B, srcT.shape[1], wm.shape[0], **kw)
    assert plan["targets_resident"] == (route == "resident")
    if "warps" in kw:
        assert plan["warps"] == kw["warps"]
    if "grid" in kw:
        assert plan["grid"] <= kw["grid"]
    ub, lb = fused._k2_kernel(srcT, wm, params, **kw)
    torch.cuda.synchronize()
    ub_o, lb_o = fused.bounds_nodes_kernel_order(srcT, wm, params)
    assert torch.equal(ub, ub_o) and torch.equal(lb, lb_o)
    blk = _k2_lb_blocks(srcT, wm, params)
    _, _, blocks = fused.screen_scan(blk, blk, params[:, 15])
    assert torch.equal(blocks, runs)
    th = params[:, 15]
    assert torch.equal(ub == 1e30, th < 1e29)
    _agree_per_node(ub, lb, *fused.bounds_nodes_plain(srcT, wm, params), th)


def _agree_per_node(ub, lb, ub_p, lb_p, th):
    """``nn/agree.py``'s rule with a threshold per node: the screened sets
    may differ only where the lb lies within 1e-5 + 1e-5·|thresh| of the
    node's threshold; elsewhere ub and lb agree to 1e-5 + 1e-5·|ref|."""
    scr, scr_p = ub >= 1e29, ub_p >= 1e29
    differ = scr != scr_p
    near = (torch.where(scr, lb, lb_p) - th).abs() <= 1e-5 * th.abs() + 1e-5
    assert bool(near[differ].all())
    same = ~differ
    torch.testing.assert_close(ub[same], ub_p[same], rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(lb[same], lb_p[same], rtol=1e-5, atol=1e-5)


# above the 6,144 resident targets (the ring) and at mxu_max
@pytest.mark.parametrize("nt", [6145, 8000, 32768])
@pytest.mark.parametrize("sched", [0, 2])
def test_k2_ring_route(cuda, nt, sched):
    rng = np.random.default_rng(14)
    srcT, wm, params, runs = _k2_boundary_case(rng, 12, 1518, nt, cuda)
    assert not fused.k2_plan(12, srcT.shape[1], wm.shape[0])["targets_resident"]
    ub, lb = fused._k2_kernel(srcT, wm, params, **K2_SCHEDULES[sched])
    torch.cuda.synchronize()
    ub_o, lb_o = fused.bounds_nodes_kernel_order(srcT, wm, params)
    assert torch.equal(ub, ub_o) and torch.equal(lb, lb_o)


def test_k2_plan_k(cuda):
    """One block of a node in flight at the R-round bucket; several at the
    full cert's whole source."""
    head = fused.k2_plan(21080, 1536, 1920)
    whole = fused.k2_plan(792, 40320, 1920)
    assert head["k"] == 1 and head["targets_resident"] and head["points_per_lane"] == 12
    assert whole["k"] > 1 and whole["blocks"] == 105


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


# the same inputs at every count of warps per CTA: a node's result is its
# warp's alone, whatever warp of which CTA takes it and wherever its slot of
# the global scratch lies, so the bits are equal
@pytest.mark.parametrize("B,n,nt", [(37, 100, 700), (1001, 1000, 1797), (37, 8192, 1797),
                                    (16, 1518, 20000)])
@pytest.mark.parametrize("mode", ["open", "screen"])
def test_k5_warps(cuda, B, n, nt, mode):
    rng = np.random.default_rng(15)
    src, tgt = _cloud(rng, n, cuda), _cloud(rng, nt, cuda)
    R, t = _nodes(rng, B, cuda)
    t[::2] += 1.5
    af = torch.as_tensor(rng.uniform(0, 0.3, B).astype(np.float32), device=cuda)
    gt = torch.as_tensor(rng.uniform(0, 0.05, B).astype(np.float32), device=cuda)
    srcT = fused.pack_sources_ext(src, torch.linalg.vector_norm(src, dim=1))
    wm = fused.pack_targets(tgt)
    h = int(round(0.75 * n))
    Np, Mp = srcT.shape[1], wm.shape[0]
    picked = fused.k5_plan(B, Np, Mp)["warps"]
    assert all(fused.k5_plan(B, Np, Mp, w)["warps"] == w for w in range(1, 9))

    def args(te, tau):
        return srcT, wm, fused.pack_params_bounds_trimmed(R, t, af, gt, 0.0, te, tau)

    _, te, tau = _trimmed_levels(fused.bounds_nodes_trimmed_plain, args, h, n - h, mode)
    ref = fused._k5_kernel(*args(te, tau), h, n - h)
    for w in range(1, 9):
        out = fused._k5_kernel(*args(te, tau), h, n - h, w)
        torch.cuda.synchronize()
        assert torch.equal(out[0], ref[0]) and torch.equal(out[1], ref[1]), (w, picked)
    _trimmed_agree(lambda *a: fused._k5_kernel(*a, h, n - h, 1),
                   fused.bounds_nodes_trimmed_plain, args, h, n - h, mode)


# the trimmed full cert's whole source: Np = 40,320, 315 KB of scratch a warp
@pytest.mark.parametrize("mode", ["open", "screen", "masked"])
def test_k5_global_scratch_whole_source(cuda, mode):
    rng = np.random.default_rng(16)
    n, nt, B = 40256, 1797, 24
    src, tgt = _cloud(rng, n, cuda), _cloud(rng, nt, cuda)
    R, t = _nodes(rng, B, cuda)
    t[::2] += 1.5
    af = torch.as_tensor(rng.uniform(0, 0.3, B).astype(np.float32), device=cuda)
    gt = torch.as_tensor(rng.uniform(0, 0.05, B).astype(np.float32), device=cuda)
    srcT = fused.pack_sources_ext(src, torch.linalg.vector_norm(src, dim=1))
    wm = fused.pack_targets(tgt)
    plan = fused.k5_plan(B, srcT.shape[1], wm.shape[0])
    assert plan["targets_resident"]
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


# the rotation bound's emulated libm arithmetic (tests/test_torch_rotation.py
# holds the CPU path to the jitted JAX function) gives the same bits on the
# card, eagerly and replayed from its CUDA graph, at two cube counts and on
# new inputs to a graph already captured
@pytest.mark.parametrize("M", [100_000, 2635])
def test_cube_angle_bound_card_equals_cpu(cuda, M):
    from goicp_tpu_torch.geo import rotation

    rng = np.random.default_rng(22)
    for _ in range(2):
        c = rng.uniform(-np.pi, np.pi, (3 * M, 3)).astype(np.float32)
        c = c[np.linalg.norm(c, axis=1) <= np.pi][:M]
        s = (np.pi / 2.0 ** rng.integers(1, 11, M)).astype(np.float32)
        ref = rotation.axis_angle_cube_max_angle(torch.from_numpy(c), torch.from_numpy(s))
        c_d, s_d = torch.as_tensor(c, device=cuda), torch.as_tensor(s, device=cuda)
        got = rotation.axis_angle_cube_max_angle(c_d, s_d)
        eager = rotation._cube_max_angle(c_d, s_d, 40, 12)
        assert torch.equal(got.cpu(), ref) and torch.equal(eager.cpu(), ref)


# the lockstep multipair (multipair_lockstep): its K4 form on the card gives
# the CPU path's K4 form (K4's plain version) bit for bit in ub and lb, the
# epilogue's order and sine being the same on both; the refine's sse to
# rtol 1e-5 (the ICP's step is not bit-equal across devices)
def _lockstep_pairs(rng, P=3, n=300, nt=320):
    from goicp_tpu_torch.geo.rotation import random_rotations

    pairs = []
    for b in range(P):
        src = rng.uniform(-0.5, 0.5, (n - 20 * b, 3)).astype(np.float32)
        R = random_rotations(1, rng)[0]
        tgt = rng.uniform(-0.5, 0.5, (nt, 3)).astype(np.float32)
        tgt[: src.shape[0]] = src @ R.T + rng.normal(0, 0.01, src.shape).astype(np.float32)
        pairs.append((src, tgt))
    return pairs


@pytest.mark.parametrize("trim", [0.0, 0.25])
def test_lockstep_round_card_equals_cpu(cuda, trim):
    from goicp_tpu_torch import multipair_lockstep as ml
    from goicp_tpu_torch.geo.rotation import random_rotations
    from goicp_tpu_torch.icp import IcpParams

    rng = np.random.default_rng(31)
    pairs = _lockstep_pairs(rng)
    P, M = len(pairs), 1024
    R = random_rotations(P * M, rng).reshape(P, M, 3, 3)
    ang = rng.uniform(0.01, 1.0, (P, M)).astype(np.float32)
    t_c = rng.uniform(-0.1, 0.1, (P, M, 3)).astype(np.float32)
    t_s = rng.uniform(0.005, 0.1, (P, M)).astype(np.float32)
    mask = np.ones((P, M), bool)
    mask[1, 700:] = False
    mask[2] = False                                     # a pair with no live job
    h = np.array([max(1, round(s.shape[0] * (1 - trim))) for s, _ in pairs], np.float64)
    gate = np.full(P, 2.0, np.float32)
    outs = []
    for dev in (cuda, torch.device("cpu")):
        batch = ml._PairBatch(pairs, 300, dev)
        outs.append([x.cpu() for x in ml._pairs_round(
            batch, 0.0, R, ang, t_c, t_s, mask, h, gate, refine_k=8,
            icp_params=IcpParams(max_iter=32, rel_tol=1e-4, trim_fraction=trim),
            trim=trim > 0, use_kernel=True)])
    (ub_g, lb_g, _, _, sse_g, _), (ub_c, lb_c, _, _, sse_c, _) = outs
    assert torch.equal(ub_g, ub_c) and torch.equal(lb_g, lb_c)
    assert bool(torch.isinf(ub_g[2]).all()) and bool(torch.isfinite(ub_g[0]).all())
    torch.testing.assert_close(sse_g, sse_c, rtol=1e-5, atol=0)


@pytest.mark.parametrize("shared", [True, False])
def test_lockstep_icp_k1_launches(cuda, shared):
    """The lockstep's batched ICP makes one K1 launch an iteration when every
    pair shares one target object, one per distinct target otherwise."""
    from goicp_tpu_torch.core.types import RigidTransform
    from goicp_tpu_torch.icp import IcpParams
    from goicp_tpu_torch.multipair import PairTargets, _icp_pairs_run

    rng = np.random.default_rng(32)
    pairs = _lockstep_pairs(rng)
    if shared:
        pairs = [(s, pairs[0][1]) for s, _ in pairs]
    P, k = len(pairs), 8
    srcs = np.zeros((P * k, 300, 3), np.float32)
    for b, (s, _) in enumerate(pairs):
        srcs[b * k:(b + 1) * k, : s.shape[0]] = s
    w = torch.as_tensor((np.abs(srcs).sum(-1) > 0).astype(np.float32), device=cuda)
    fused.reset_launch_counts()
    _, _, iters = _icp_pairs_run(
        torch.as_tensor(srcs, device=cuda), PairTargets([t for _, t in pairs], cuda),
        w, RigidTransform.identity((P * k,), device=cuda),
        IcpParams(max_iter=20, rel_tol=1e-6), pair_of_pose=np.repeat(np.arange(P), k))
    torch.cuda.synchronize()
    loops = int(iters.max())
    assert loops > 1
    assert fused.launches["nearest_neighbor_mxu"] == loops * (1 if shared else P)


# distribution (goicp_tpu_torch.dist): the mesh round on one card listed
# twice ([cuda:0] × 2) runs each cube shard's kernels (K4 on "mxu", K2 or
# K5 on "screen") on exactly the nodes of its slice, so its bounds equal
# the single-device round's bit for bit; a point-sharded mesh sums its
# shards' partials and agrees to rtol 1e-5 + atol 1e-5
def _mesh_round_inputs(rng, dev, M=4096, n=1518, nt=1797):
    from goicp_tpu_torch.bnb.bounds import BoundsEvaluator
    from goicp_tpu_torch.geo.rotation import random_rotations

    src = torch.as_tensor(rng.uniform(-0.5, 0.5, (n, 3)).astype(np.float32), device=dev)
    tgt = torch.as_tensor(rng.uniform(-0.5, 0.5, (nt, 3)).astype(np.float32), device=dev)
    jobs = [torch.as_tensor(x, device=dev) for x in (
        random_rotations(M, rng), rng.uniform(0.01, 0.6, M).astype(np.float32),
        rng.uniform(-0.1, 0.1, (M, 3)).astype(np.float32),
        rng.uniform(0.005, 0.1, M).astype(np.float32))]
    mask = torch.ones(M, dtype=torch.bool, device=dev)
    mask[-100:] = False
    return src, BoundsEvaluator(src).norms, tgt, jobs, mask


@pytest.mark.parametrize("backend,shape,trim", [
    ("mxu", (2, 1), 0.0), ("screen", (2, 1), 0.0), ("screen", (4, 1), 0.25),
    ("mxu", (4, 1), 0.25), ("mxu", (1, 2), 0.0), ("mxu", (2, 2), 0.25)])
def test_mesh_round_on_card(cuda, backend, shape, trim):
    from goicp_tpu_torch.bnb import se3_eval
    from goicp_tpu_torch.dist.se3 import make_sharded_se3_round, pad_points
    from goicp_tpu_torch.dist.sharding import make_mesh
    from goicp_tpu_torch.icp import IcpParams

    rng = np.random.default_rng(41)
    src, norms, tgt, (R, ang, t_c, t_s), mask = _mesh_round_inputs(rng, cuda)
    N = src.shape[0]
    h = int(round(N * (1 - trim))) if trim else 0
    _, lb_open = se3_eval.se3_round_bounds(src, norms, tgt, 0.0, float("inf"), R, ang, t_c,
                                           t_s, mask, h=h, backend="mxu")
    thresh = float(lb_open[mask].median()) if backend == "screen" else float("inf")
    ref = se3_eval.se3_round_bounds(src, norms, tgt, 0.0, thresh, R, ang, t_c, t_s, mask, h=h,
                                    backend=backend)
    n_c, n_p = shape
    sp, nrm = pad_points(src.cpu().numpy(), norms.cpu().numpy(), n_p, 128)
    rnd = make_sharded_se3_round(make_mesh(n_c, n_p, devices=[cuda] * (n_c * n_p)), h=h,
                                 n_valid=N, lookup="nearest", backend=backend, tile=128,
                                 refine_k=8, icp_params=IcpParams(max_iter=4),
                                 icp_backend="exact")
    fused.reset_launch_counts()
    got = rnd.bounds(torch.as_tensor(sp, device=cuda), torch.as_tensor(nrm, device=cuda), None,
                     tgt, 0.0, thresh, R, ang, t_c, t_s, mask)
    torch.cuda.synchronize()
    kern = ("bounds_nodes_trimmed" if trim else "bounds_nodes") if backend == "screen" \
        else "min_d2_nodes"
    assert fused.launches[kern] == n_c * n_p
    if n_p == 1:
        for g, r in zip(got, ref):
            assert torch.equal(g, r)
    else:
        for g, r in zip(got, ref):
            fin = torch.isfinite(r)
            assert torch.equal(fin, torch.isfinite(g))
            torch.testing.assert_close(g[fin], r[fin], rtol=1e-5, atol=1e-5)


def test_two_process_solve_on_card(cuda, tmp_path):
    """Two processes of the frontier-sharded solve on the one card (gloo
    for the exchanges): both converge to the same pose at the truth, and
    equal the same two-process solve on the CPU in rounds and local nodes."""
    import json
    import os
    import subprocess
    import sys

    worker = os.path.join(os.path.dirname(os.path.abspath(__file__)), "test_torch_multihost.py")
    runs = {}
    for dev in ("cuda", "cpu"):
        outs = [tmp_path / f"{dev}_{r}.json" for r in range(2)]
        procs = [subprocess.Popen(
            [sys.executable, worker, "solve", str(r), "2", str(tmp_path / f"store_{dev}"),
             str(outs[r]), json.dumps({"device": dev})],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT) for r in range(2)]
        for pr in procs:
            out, _ = pr.communicate(timeout=600)
            assert pr.returncode == 0, out.decode()[-3000:]
        runs[dev] = [json.load(open(o)) for o in outs]
    for r in runs["cuda"]:
        assert r["converged"] and r["rmse_vs_gt"] < 1e-3, r
        assert r["R"] == runs["cuda"][0]["R"]
    for g, c in zip(runs["cuda"], runs["cpu"]):
        assert (g["rounds"], g["local_nodes"]) == (c["rounds"], c["local_nodes"]), (g, c)
