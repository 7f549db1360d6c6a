"""The distance forms of the min-distance kernels (``variant=``) against the
JAX package on the same numpy inputs: the plain versions of K4
(``fused.min_d2_nodes``), K1 over node poses (``fused.min_d2_padded`` with
the index) and K3 (``fused.min_d2_groups``) in the "exp" and "dot" forms
against ``mxu.min_d2_nodes``, ``mxu._min_d2_padded`` and
``mxu.min_d2_groups`` in Pallas interpret mode.

Tolerances: bit-equal d² and equal indices.  XLA's CPU build contracts each
product of the interpreted exp and dot kernels into the sum that follows
(the rotation rows, |q|², the three FMAs of exp, the contraction of dot,
which it sums in column order), and the plain versions round as it does
(``fused.fma``).  The "diff" form is not contracted by the port (its kernels
keep the reference's node counts bit for bit on the card): its indices are
equal and its d² within rtol 1e-5 + atol 1e-7, as in
``tests/test_torch_trimmed.py``.  Against the port's own "diff" form the
exp and dot forms agree within f32 cancellation, 8·ε·(|q|² + |m|²) with
ε = 2⁻²³, for the nearest target m of either form.

Scenes: ``tests/test_mxu.py``'s (220 × 330, 4 nodes), one whose Np and Mp
need padding and whose targets take two blocks of the TPU kernel (300 ×
700: Mp = 768, two blocks of 384), and one of five target blocks (1,000 ×
1,200: Mp = 1,280, blocks of 256).
"""

import numpy as np
import pytest

pytest.importorskip("jax")

import torch  # noqa: E402

from goicp_tpu.nn import mxu  # noqa: E402
from goicp_tpu_torch.nn import fused  # noqa: E402
from tests.conftest import random_rotation  # noqa: E402

torch.set_num_threads(1)

EPS = 2.0 ** -23
SCENES = [(1234, 220, 330, 4), (7, 300, 700, 3), (11, 1000, 1200, 2)]


def _scene(seed, n, m, b):
    """``tests/test_mxu.py:_scene``'s clouds and poses, packed by the JAX
    package, as numpy arrays; the first scene is that test's own."""
    rng = np.random.default_rng(seed)
    src = (rng.random((n, 3)).astype(np.float32) - 0.5) * 0.6
    tgt = (rng.random((m, 3)).astype(np.float32) - 0.5) * 0.6
    R = np.stack([random_rotation(rng) for _ in range(b)])
    t = (rng.random((b, 3)).astype(np.float32) - 0.5) * 0.3
    t8 = ((rng.random((b, 8, 3)) - 0.5) * 0.3).astype(np.float32)
    return dict(src=src, tgt=tgt, R=R, t=t, srcT=np.asarray(mxu.pack_sources(src)),
                wm=np.asarray(mxu.pack_targets(tgt)), P=np.asarray(mxu.pack_params(R, t)),
                gp=np.asarray(mxu.pack_group_params(R, t8)))


@pytest.fixture(scope="module", params=SCENES, ids=lambda s: f"{s[1]}x{s[2]}")
def scene(request):
    return _scene(*request.param)


def _t(x):
    return torch.from_numpy(np.array(x))


def _bits_equal(a, b):
    return np.array_equal(np.asarray(a, np.float32).view(np.int32),
                          np.asarray(b, np.float32).view(np.int32))


@pytest.mark.parametrize("variant", ["exp", "dot"])
def test_min_d2_nodes_forms_match_jax(scene, variant):
    s = scene
    ref = np.asarray(mxu.min_d2_nodes(s["srcT"], s["wm"], s["P"], interpret=True,
                                      variant=variant))
    got = fused.min_d2_nodes(_t(s["srcT"]), _t(s["wm"]), _t(s["P"]), variant=variant).numpy()
    assert got.shape == ref.shape
    assert _bits_equal(got, ref)


@pytest.mark.parametrize("variant", ["exp", "dot"])
def test_min_d2_padded_forms_match_jax(scene, variant):
    s = scene
    d2_j, idx_j = mxu._min_d2_padded(s["P"], s["srcT"], s["wm"], want_idx=True,
                                     interpret=True, variant=variant)
    d2, idx = fused.min_d2_padded(_t(s["P"]), _t(s["srcT"]), _t(s["wm"]), want_idx=True,
                                  variant=variant)
    assert idx.dtype == torch.int32
    assert _bits_equal(d2.numpy(), d2_j)
    np.testing.assert_array_equal(idx.numpy(), np.asarray(idx_j))
    d2_k4, none = fused.min_d2_padded(_t(s["P"]), _t(s["srcT"]), _t(s["wm"]), want_idx=False,
                                      variant=variant)
    assert none is None and torch.equal(d2_k4, d2)


def test_min_d2_padded_diff_matches_jax(scene):
    s = scene
    d2_j, idx_j = mxu._min_d2_padded(s["P"], s["srcT"], s["wm"], want_idx=True,
                                     interpret=True, variant="diff")
    d2, idx = fused.min_d2_padded(_t(s["P"]), _t(s["srcT"]), _t(s["wm"]), want_idx=True,
                                  variant="diff")
    np.testing.assert_array_equal(idx.numpy(), np.asarray(idx_j))
    np.testing.assert_allclose(d2.numpy(), np.asarray(d2_j), rtol=1e-5, atol=1e-7)
    # the default form is the JAX function's: "dot"
    d2_dot, idx_dot = fused.min_d2_padded(_t(s["P"]), _t(s["srcT"]), _t(s["wm"]),
                                          want_idx=True)
    d2_dj, idx_dj = mxu._min_d2_padded(s["P"], s["srcT"], s["wm"], want_idx=True,
                                       interpret=True)
    assert _bits_equal(d2_dot.numpy(), d2_dj)
    np.testing.assert_array_equal(idx_dot.numpy(), np.asarray(idx_dj))


def test_min_d2_groups_exp_matches_jax(scene):
    s = scene
    ref = np.asarray(mxu.min_d2_groups(s["srcT"], s["wm"], s["gp"], interpret=True,
                                       variant="exp"))
    got = fused.min_d2_groups(_t(s["srcT"]), _t(s["wm"]), _t(s["gp"]), variant="exp").numpy()
    assert got.shape == ref.shape
    assert _bits_equal(got, ref)


@pytest.mark.parametrize("variant", ["exp", "dot"])
def test_forms_agree_with_diff_within_cancellation(scene, variant):
    """|d²_form − d²_diff| ≤ 8·ε·(|q|² + |m|²) at either form's nearest
    target m; the grouped exp form against the grouped diff form likewise,
    with q = R·p + t_j, the largest |m|² and |t_j|² (the separable form's
    b_j and a_j)."""
    s = scene
    n = s["src"].shape[0]
    P, srcT, wm = _t(s["P"]), _t(s["srcT"]), _t(s["wm"])
    d_diff, i_diff = fused.min_d2_padded(P, srcT, wm, want_idx=True, variant="diff")
    d_form, i_form = fused.min_d2_padded(P, srcT, wm, want_idx=True, variant=variant)
    q = np.einsum("bij,nj->bni", s["R"].astype(np.float64), s["src"]) + s["t"][:, None]
    qn = (q ** 2).sum(-1)
    mn = (s["tgt"].astype(np.float64) ** 2).sum(-1)
    m2 = np.maximum(mn[i_diff.numpy()[:, :n]], mn[i_form.numpy()[:, :n]])
    bound = 8 * EPS * (qn + m2)
    gap = np.abs(d_form.numpy()[:, :n].astype(np.float64) - d_diff.numpy()[:, :n])
    assert (gap <= bound).all(), (gap - bound).max()
    if variant == "exp":
        g_diff = fused.min_d2_groups(srcT, wm, _t(s["gp"])).numpy()
        g_exp = fused.min_d2_groups(srcT, wm, _t(s["gp"]), variant="exp").numpy()
        t8 = s["gp"][:, 9:33].reshape(-1, 8, 3).astype(np.float64)
        u = np.einsum("bij,nj->bni", s["R"].astype(np.float64), s["src"])
        qg = (u[:, None] + t8[:, :, None]).reshape(-1, n, 3)
        bound = 8 * EPS * ((qg ** 2).sum(-1) + mn.max() + (t8 ** 2).sum(-1).reshape(-1, 1))
        gap = np.abs(g_exp[:, :n].astype(np.float64) - g_diff[:, :n])
        assert (gap <= bound).all(), (gap - bound).max()


def test_unknown_form_raises():
    srcT = fused.pack_sources(torch.zeros((4, 3)))
    wm = fused.pack_targets(torch.ones((4, 3)))
    P = fused.pack_params(torch.eye(3)[None], torch.zeros((1, 3)))
    with pytest.raises(ValueError, match="unknown variant"):
        fused.min_d2_nodes(srcT, wm, P, variant="mxu")
    with pytest.raises(ValueError, match="unknown variant"):
        fused.min_d2_padded(P, srcT, wm, want_idx=True, variant="bf16")
    with pytest.raises(ValueError, match="unknown variant"):
        fused.min_d2_groups(srcT, wm, torch.zeros((1, 48)), variant="dot")


def test_fma_bulk_equals_fma():
    """``fused.fma_bulk`` gives ``fused.fma``'s bits, midpoints of the f64
    sum, f32 subnormal results and broadcast operands included."""
    rng = np.random.default_rng(3)
    a = torch.from_numpy(rng.standard_normal((400, 1)).astype(np.float32))
    b = torch.from_numpy(rng.standard_normal((1, 300)).astype(np.float32))
    c = torch.from_numpy(rng.standard_normal((400, 300)).astype(np.float32))
    assert torch.equal(fused.fma_bulk(a, b, c), fused.fma(a, b, c))
    # a·b = 2⁻²⁴·(1 + 4,688·2⁻⁴⁶): c + a·b lies just above the midpoint
    # between 1 and 1 + 2⁻²³ (and, negated, just below its mirror), and its
    # f64 sum rounds onto that midpoint, where rounding to even goes the
    # wrong way
    a = torch.tensor([2.0 ** -24 * (1 + 2896 * 2.0 ** -23)] * 2)
    b = torch.tensor([1 - 2895 * 2.0 ** -23, -(1 - 2895 * 2.0 ** -23)])
    c = torch.tensor([1.0, -1.0])
    naive = (c.double() + a.double() * b.double()).float()
    want = torch.tensor([1 + 2.0 ** -23, -(1 + 2.0 ** -23)])
    assert torch.equal(fused.fma(a, b, c), want) and not torch.equal(naive, want)
    assert torch.equal(fused.fma_bulk(a, b, c), want)
    tiny = torch.tensor([1e-20, -3e-21, 2e-23, 0.0])
    assert torch.equal(fused.fma_bulk(tiny, tiny, tiny * 1e-19),
                       fused.fma(tiny, tiny, tiny * 1e-19))
