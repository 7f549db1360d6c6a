"""The port's distance grid (``nn/grid.py``), its grid and exact bound
backends (``evaluate_se3_nodes``) and whole solves on them, against the JAX
package on the same numpy inputs.

Tolerances: the EDT build bit-equal with equal indices (its min-plus
candidates round once from f64, as XLA's fused multiply-add does on the
CPU); the brute build to rtol 1e-6 + atol 8·ε_f32·s² (s the largest
coordinate: the |q|² − 2q·t + |t|² expansion's cancellation, which XLA's
matmul rounds otherwise) with equal indices; lookups bit-equal; bounds to
rtol 1e-5 + atol 1e-5; whole solves with rounds, nodes, converged and gap
equal and sse to rtol 1e-5.
"""

import dataclasses

import numpy as np
import pytest

pytest.importorskip("jax")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from goicp_tpu.bnb import BnbParams as JBnbParams  # noqa: E402
from goicp_tpu.bnb import register as jregister  # noqa: E402
from goicp_tpu.bnb.se3_eval import evaluate_se3_nodes as jeval  # noqa: E402
from goicp_tpu.nn import grid as jgrid  # noqa: E402
from goicp_tpu_torch import BnbParams, make_solver, register  # noqa: E402
from goicp_tpu_torch.bnb.params import auto_backend  # noqa: E402
from goicp_tpu_torch.bnb.se3_eval import evaluate_se3_nodes  # noqa: E402
from goicp_tpu_torch.geo.rotation import random_rotations  # noqa: E402
from goicp_tpu_torch.nn import grid as tgrid  # noqa: E402

torch.set_num_threads(1)

EPS32 = float(np.finfo(np.float32).eps)


def _cloud(kind):
    rng = np.random.default_rng(0)
    if kind == "uniform":
        return rng.uniform(-0.5, 0.5, (300, 3)).astype(np.float32)
    # many points per cell: 400 points packed into a few cells of a 32³ grid
    return np.concatenate([rng.uniform(-0.5, 0.5, (50, 3)),
                           rng.uniform(0.0, 0.05, (400, 3))]).astype(np.float32)


@pytest.mark.parametrize("kind", ["uniform", "crowded"])
@pytest.mark.parametrize("n", [32, 64])
@pytest.mark.parametrize("method", ["edt", "brute"])
def test_build_matches_jax(kind, n, method):
    tgt = _cloud(kind)
    J = jgrid.build_distance_grid(tgt, n=n, expand=1.5, method=method, with_index=True)
    T = tgrid.build_distance_grid(torch.from_numpy(tgt), n=n, expand=1.5, method=method,
                                  with_index=True)
    assert T.cell == float(J.cell) and T.raster_err == J.raster_err
    np.testing.assert_array_equal(T.origin.numpy(), np.asarray(J.origin))
    jv = np.asarray(J.values)
    if method == "edt":
        np.testing.assert_array_equal(T.values.numpy(), jv)
    else:
        s = float(np.abs(tgt).max() + np.abs(np.asarray(J.origin)).max()) * 2
        np.testing.assert_allclose(T.values.numpy(), jv, rtol=1e-6, atol=8 * EPS32 * s * s)
    np.testing.assert_array_equal(T.indices.numpy(), np.asarray(J.indices))
    if kind == "crowded" and method == "edt":
        # cells hit by several targets keep the largest index on both sides
        occ = np.floor((tgt - np.asarray(J.origin)) / float(J.cell)).astype(int)
        _, counts = np.unique(occ, axis=0, return_counts=True)
        assert counts.max() > 10


def test_build_without_index_and_domain_cover():
    tgt = _cloud("uniform")
    cover = np.array([[2.0, 0.0, 0.0]], np.float32)
    J = jgrid.build_distance_grid(tgt, n=32, cover=cover, method="edt")
    T = tgrid.build_distance_grid(torch.from_numpy(tgt), n=32, cover=cover, method="edt")
    assert T.indices is None and J.indices is None
    np.testing.assert_array_equal(T.values.numpy(), np.asarray(J.values))
    assert T.cell == float(J.cell)


@pytest.fixture(scope="module")
def grids():
    tgt = _cloud("uniform")
    J = jgrid.build_distance_grid(tgt, n=32, expand=1.5, method="edt", with_index=True)
    T = tgrid.build_distance_grid(torch.from_numpy(tgt), n=32, expand=1.5, method="edt",
                                  with_index=True)
    rng = np.random.default_rng(1)
    # inside the domain, half-way between cell centers (round half to even),
    # and outside it (the escape term)
    inside = rng.uniform(-0.7, 0.7, (400, 3)).astype(np.float32)
    half = (np.asarray(J.origin) + (rng.integers(0, 31, (50, 3)) + 1.0) * float(J.cell)
            ).astype(np.float32)
    outside = rng.uniform(-3.0, 3.0, (200, 3)).astype(np.float32)
    q = np.concatenate([inside, half, outside])
    return J, T, q


@pytest.mark.parametrize("fn", ["lookup_sq_nearest", "lookup_sq_trilinear"])
def test_lookups_match_jax(grids, fn):
    """Against the jitted lookups, as every solve runs them (XLA contracts
    the trilinear blend into fused multiply-adds, which the port rounds the
    same way)."""
    J, T, q = grids
    vj, ej = jax.jit(getattr(jgrid, fn))(J, jnp.asarray(q))
    vt, et = getattr(tgrid, fn)(T, torch.from_numpy(q))
    np.testing.assert_array_equal(vt.numpy(), np.asarray(vj))
    np.testing.assert_allclose(et.numpy(), np.asarray(ej), rtol=1e-6, atol=1e-7)
    assert (et.numpy()[-200:] > 0).any() and (et.numpy()[:400] == 0).all()


def test_lookup_index_and_distance_bounds_match_jax(grids):
    J, T, q = grids
    np.testing.assert_array_equal(tgrid.lookup_index(T, torch.from_numpy(q)).numpy(),
                                  np.asarray(jgrid.lookup_index(J, jnp.asarray(q))))
    for lookup in ("nearest", "trilinear"):
        lo_j, hi_j = jgrid.distance_bounds(J, jnp.asarray(q), lookup)
        lo_t, hi_t = tgrid.distance_bounds(T, torch.from_numpy(q), lookup)
        np.testing.assert_allclose(lo_t.numpy(), np.asarray(lo_j), rtol=1e-6, atol=1e-6)
        np.testing.assert_allclose(hi_t.numpy(), np.asarray(hi_j), rtol=1e-6, atol=1e-6)
    with pytest.raises(ValueError, match="with_index"):
        tgrid.lookup_index(dataclasses.replace(T, indices=None), torch.from_numpy(q))


def _old_exact_min_d2(pts, tiles, norms):
    """The expansion as the port computed it before it rounded like XLA:
    one f32 matmul per tile and plainly summed norms."""
    pn = (pts * pts).sum(-1)
    best = torch.full_like(pn, float("inf"))
    for t_tile, tn in zip(tiles, norms):
        best = torch.minimum(best, (tn[None, :] - 2.0 * (pts @ t_tile.T)).amin(-1))
    return torch.clamp(best + pn, min=0.0)


def _old_trilinear_blend(c, f):
    """The blend ``a·(1−f) + b·f`` with every product and sum rounded."""
    (c000, c100, c010, c110, c001, c101, c011, c111), (fx, fy, fz) = c, f
    c00, c10 = c000 * (1 - fx) + c100 * fx, c010 * (1 - fx) + c110 * fx
    c01, c11 = c001 * (1 - fx) + c101 * fx, c011 * (1 - fx) + c111 * fx
    c0, c1 = c00 * (1 - fy) + c10 * fy, c01 * (1 - fy) + c11 * fy
    return c0 * (1 - fz) + c1 * fz


def test_exact_expansion_and_trilinear_blend_round_as_jitted_jax(grids):
    """Term by term against the jitted JAX functions: every per-point d² of
    the exact expansion (``device_inner._exact_min_d2``) and every
    trilinear lookup is bit-equal, where the plain f32 forms the port used
    before differ in the last bits of many terms."""
    from goicp_tpu.bnb.device_inner import _exact_min_d2 as jexact
    from goicp_tpu_torch.bnb.se3_eval import _exact_min_d2, _target_tiles

    rng = np.random.default_rng(0)
    pts = rng.normal(0.0, 0.3, (3000, 3)).astype(np.float32)
    tgt = rng.normal(0.0, 0.3, (600, 3)).astype(np.float32)
    tiles, norms = _target_tiles(torch.from_numpy(tgt), 256)
    jt = jnp.asarray(tiles.numpy())
    jn = jax.jit(lambda a: jnp.sum(a * a, axis=-1))(jt)
    np.testing.assert_array_equal(norms.numpy(), np.asarray(jn))
    want = np.asarray(jax.jit(jexact)(jnp.asarray(pts), jt, jn))
    got = _exact_min_d2(torch.from_numpy(pts), tiles, norms).numpy()
    old = _old_exact_min_d2(torch.from_numpy(pts), tiles, (tiles * tiles).sum(-1)).numpy()
    assert (old != want).sum() > 100
    np.testing.assert_array_equal(got, want)
    # the rotation of the points (K = 3): the matmul of the SE(3) bounds and
    # of the nested engine rounds as the fused chain that XLA's dot runs
    from goicp_tpu_torch.nn.fused import _dot3_fma

    R = torch.from_numpy(random_rotations(200, rng))
    s = torch.from_numpy(pts[:128])
    chain = _dot3_fma(R[:, None], s[None, :, None])
    np.testing.assert_array_equal((s[None] @ R.transpose(-1, -2)).numpy(), chain.numpy())
    np.testing.assert_array_equal(
        chain.numpy(), np.asarray(jax.jit(lambda r, p: jnp.einsum(
            "mij,tj->mti", r, p, precision=jax.lax.Precision.HIGHEST))(R.numpy(), pts[:128])))

    J, T, q = grids
    vj = np.asarray(jax.jit(jgrid.lookup_sq_trilinear)(J, jnp.asarray(q))[0])
    vt = tgrid.lookup_sq_trilinear(T, torch.from_numpy(q))[0].numpy()
    np.testing.assert_array_equal(vt, vj)
    # the plain blend of the same corners and fractions
    n = T.n
    x = (torch.from_numpy(q) - T.origin) / T.cell - 0.5
    xc = torch.clamp(x, 0.0, n - 1.0)
    f = xc - torch.floor(xc)
    i0 = torch.clamp(torch.floor(xc).to(torch.int64), 0, n - 1)
    i1 = torch.clamp(i0 + 1, 0, n - 1)
    corners = [torch.take(T.values, ((a[:, 0] * n + b[:, 1]) * n + c[:, 2]))
               for c in (i0, i1) for b in (i0, i1) for a in (i0, i1)]
    old = _old_trilinear_blend(corners, (f[:, 0], f[:, 1], f[:, 2])).numpy()
    assert (old != vj).sum() > 10


def test_roots_and_norms_round_as_jitted_jax():
    """Term by term: ATen's vectorized CPU ``sqrt`` of f32 is off by one ulp
    for some values, where XLA's is correctly rounded; ``fused.sqrt_rn``
    equals the jitted ``jnp.sqrt`` on every value, and the source norms
    equal the jitted ``jnp.linalg.norm``."""
    from goicp_tpu_torch.bnb.bounds import BoundsEvaluator
    from goicp_tpu_torch.nn.fused import sqrt_rn

    rng = np.random.default_rng(5)
    x = rng.uniform(0.0, 0.3, 100_000).astype(np.float32)
    want = np.asarray(jax.jit(jnp.sqrt)(jnp.asarray(x)))
    assert (torch.sqrt(torch.from_numpy(x)).numpy() != want).sum() > 100
    np.testing.assert_array_equal(sqrt_rn(torch.from_numpy(x)).numpy(), want)
    src = rng.uniform(-0.5, 0.5, (20_000, 3)).astype(np.float32)
    np.testing.assert_array_equal(
        BoundsEvaluator(torch.from_numpy(src)).norms.numpy(),
        np.asarray(jax.jit(lambda a: jnp.linalg.norm(a, axis=-1))(jnp.asarray(src))))


@pytest.mark.parametrize("trim", [0.0, 0.2, 0.7])
@pytest.mark.parametrize("lookup", ["nearest", "trilinear"])
def test_bounds_evaluator_matches_jax(trim, lookup):
    """The constants the SE(3) engine reads: inlier count, lattice slack
    (to 1e-12) and source norms (rtol 1e-6)."""
    from goicp_tpu.bnb.bounds import BoundsEvaluator as JEval
    from goicp_tpu_torch.bnb.bounds import BoundsEvaluator

    src, tgt = _nodes(37, 300)[:2]
    J = jgrid.build_distance_grid(tgt, n=32, expand=1.5, method="edt")
    T = tgrid.build_distance_grid(torch.from_numpy(tgt), n=32, expand=1.5, method="edt")
    je = JEval(src, J, trim_fraction=trim, lookup=lookup, conservative=True)
    te = BoundsEvaluator(torch.from_numpy(src), T, trim_fraction=trim, lookup=lookup,
                         conservative=True)
    assert te.h == je.h and te.slack == pytest.approx(je.slack, rel=1e-12)
    np.testing.assert_allclose(te.norms.numpy(), np.asarray(je.norms), rtol=1e-6)
    assert BoundsEvaluator(torch.from_numpy(src), T, lookup=lookup, conservative=False).slack == 0.0


def _nodes(M, N):
    rng = np.random.default_rng(3)
    src = rng.uniform(-0.3, 0.3, (N, 3)).astype(np.float32)
    tgt = rng.uniform(-0.35, 0.35, (260, 3)).astype(np.float32)
    R = random_rotations(M, rng)
    ang = rng.uniform(0.0, 0.4, M).astype(np.float32)
    t_c = rng.uniform(-0.1, 0.1, (M, 3)).astype(np.float32)
    t_span = rng.uniform(0.0, 0.05, M).astype(np.float32)
    mask = np.ones(M, bool)
    mask[-2:] = False
    return src, tgt, R, ang, t_c, t_span, mask


@pytest.mark.parametrize("trim", [0.0, 0.2])
@pytest.mark.parametrize("backend,lookup", [("grid", "nearest"), ("grid", "trilinear"),
                                            ("exact", "nearest")])
def test_evaluate_se3_nodes_matches_jax(backend, trim, lookup):
    M, N = 37, 300                      # N not a multiple of the 128-point tile
    src, tgt, R, ang, t_c, t_span, mask = _nodes(M, N)
    norms = np.linalg.norm(src, axis=1).astype(np.float32)
    h = int(round(N * (1 - trim))) if trim else 0
    J = jgrid.build_distance_grid(tgt, n=32, expand=1.5, method="edt")
    T = tgrid.build_distance_grid(torch.from_numpy(tgt), n=32, expand=1.5, method="edt")
    slack = np.float32(0.01)
    ub_j, lb_j = jeval(src, norms, J, tgt, slack, R, ang, t_c, t_span, mask, h=h,
                       lookup=lookup, backend=backend, tile=128, tgt_tile=256)
    ub_t, lb_t = evaluate_se3_nodes(
        *(torch.from_numpy(x) for x in (src, norms)), T, torch.from_numpy(tgt), float(slack),
        *(torch.from_numpy(x) for x in (R, ang, t_c, t_span, mask)), h=h, lookup=lookup,
        backend=backend, tile=128, tgt_tile=256)
    # the sums add in XLA's CPU order and the roots round correctly, as
    # XLA's do: every bound is bit-equal
    np.testing.assert_array_equal(ub_t.numpy(), np.asarray(ub_j))
    np.testing.assert_array_equal(lb_t.numpy(), np.asarray(lb_j))
    assert (lb_t.numpy()[:-2] > 0).any() and (lb_t.numpy()[:-2] < ub_t.numpy()[:-2]).all()


@pytest.fixture(scope="module")
def clouds():
    rng = np.random.default_rng(11)
    src = rng.uniform(-0.3, 0.3, (100, 3)).astype(np.float32)
    R = random_rotations(1, np.random.default_rng(5))[0]
    tgt = (src @ R.T + np.float32([0.05, -0.02, 0.03])
           + rng.normal(0, 0.01, (100, 3))).astype(np.float32)
    return src, tgt


PARITY = dict(mse_threshold=1e-4, se3_pop=64, init_multistart=8, refine_top_k=2,
              max_rounds=30, grid_resolution=32)


@pytest.mark.parametrize("kw", [dict(bound_backend="grid"), dict(bound_backend="exact"),
                                dict(bound_backend="grid", icp_exact_max=50,
                                     trim_fraction=0.1, lookup="trilinear")],
                         ids=["grid", "exact", "grid-icp-trimmed"])
def test_whole_solve_parity_with_jax(clouds, kw):
    src, tgt = clouds
    jp = JBnbParams(**PARITY, **kw)
    rj = jregister(src, tgt, jp)
    rt = register(src, tgt, BnbParams.from_dict(dataclasses.asdict(jp)), device="cpu")
    assert rj.rounds == rt.rounds and rt.rounds > 0
    assert rt.rot_nodes == rj.rot_nodes and rt.rot_nodes > 500
    assert rt.converged == rj.converged
    assert rt.icp_iters == rj.icp_iters
    np.testing.assert_allclose(rt.transform.R, np.asarray(rj.transform.R), atol=1e-4)
    np.testing.assert_allclose(rt.transform.t, np.asarray(rj.transform.t), atol=1e-4)
    np.testing.assert_allclose(rt.sse, rj.sse, rtol=1e-5)
    np.testing.assert_allclose(rt.gap, rj.gap, rtol=1e-5, atol=1e-7)


def test_trimmed_nearest_grid_solve_close_to_jax(clouds):
    """Trimmed grid bounds on the nearest lookup: the sums add in the JAX
    package's jitted CPU order and round ``S + rem·τ`` once, so the per-node
    bounds agree bit for bit and this solve evaluates the same nodes.
    Rounds, nodes, converged and ICP iterations equal, sse rtol 1e-5."""
    src, tgt = clouds
    jp = JBnbParams(**PARITY, bound_backend="grid", icp_exact_max=50, trim_fraction=0.1)
    rj = jregister(src, tgt, jp)
    rt = register(src, tgt, BnbParams.from_dict(dataclasses.asdict(jp)), device="cpu")
    assert rj.rounds == rt.rounds == 30 and rt.converged == rj.converged
    assert rt.icp_iters == rj.icp_iters
    assert rt.rot_nodes == rj.rot_nodes, (rt.rot_nodes, rj.rot_nodes)
    np.testing.assert_allclose(rt.transform.R, np.asarray(rj.transform.R), atol=1e-4)
    np.testing.assert_allclose(rt.sse, rj.sse, rtol=1e-5)


def test_auto_backend_picks_grid_above_mxu_max(clouds):
    src, tgt = clouds
    p = BnbParams(mse_threshold=1e-4, mxu_max=50, icp_exact_max=50, max_rounds=2, se3_pop=64,
                  grid_resolution=32, init_multistart=8)
    assert auto_backend(p, 50) == "mxu" and auto_backend(p, 51) == "grid"
    s = make_solver(src, tgt, p, device="cpu")
    assert s._backend == "grid" and s._icp_backend == "grid"
    assert s.grid.n == 32 and s.grid.indices is not None and s.ev.slack == 0.0
    res = s.run()
    assert res.rounds == 2 and np.isfinite(res.sse)
    # an "mxu" solve builds no grid
    assert make_solver(src, tgt, BnbParams(), device="cpu").grid is None
