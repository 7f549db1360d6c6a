"""Each Hopper kernel against its plain PyTorch version on the card.

Marked ``gpu``: skipped without a CUDA device.  On the card, run with
``python -m pytest --noconftest -m gpu tests/test_torch_kernels.py`` (the
repo's conftest imports jax, which that machine does not have).

Expected agreement: K1 and K3 round exactly as their plain versions (the
kernels use non-contracting intrinsics), so indices and distances are
equal; K2's block sums are reduced in another order, so ub and lb agree to
rtol 1e-5 / atol 1e-5, and the screened sets may differ only for nodes whose
lb lies within that tolerance of the threshold.
"""

import numpy as np
import pytest
import torch

from goicp_tpu_torch.geo.rotation import axis_angle_rotation
from goicp_tpu_torch.nn import fused
from goicp_tpu_torch.nn.brute import nearest_neighbor

pytestmark = pytest.mark.gpu


@pytest.fixture(scope="module")
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _cloud(rng, n, dev):
    return torch.as_tensor(rng.uniform(-0.5, 0.5, (n, 3)).astype(np.float32), device=dev)


@pytest.mark.parametrize("nq,nt", [(300, 700), (64 * 1518, 1797)])
def test_k1_nearest_neighbor(cuda, nq, nt):
    rng = np.random.default_rng(1)
    q, t = _cloud(rng, nq, cuda), _cloud(rng, nt, cuda)
    d2, idx = fused.nearest_neighbor_mxu(q, t)
    torch.cuda.synchronize()
    d2_p, idx_p = nearest_neighbor(q, t)
    assert torch.equal(idx, idx_p)
    assert torch.equal(d2, d2_p)


def _nodes(rng, B, dev):
    R = axis_angle_rotation(torch.as_tensor(
        rng.uniform(-np.pi, np.pi, (B, 3)).astype(np.float32), device=dev))
    t = torch.as_tensor(rng.uniform(-0.2, 0.2, (B, 3)).astype(np.float32), device=dev)
    return R, t


@pytest.mark.parametrize("G,n,nt", [(5, 300, 700), (263, 1518, 1797)])
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


@pytest.mark.parametrize("B,n,nt", [(37, 300, 700), (2048, 1518, 1797)])
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
    ub_p, lb_p = fused.bounds_nodes_plain(srcT, wm, params)
    scr, scr_p = lb >= thresh, lb_p >= thresh
    differ = scr != scr_p
    assert torch.all(torch.abs(lb_p[differ] - thresh) <= 1e-5 * abs(thresh) + 1e-5)
    same = ~differ
    torch.testing.assert_close(lb[same], lb_p[same], rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(ub[same], ub_p[same], rtol=1e-5, atol=1e-5)
    if screen:
        assert scr.any() and (~scr).any()
