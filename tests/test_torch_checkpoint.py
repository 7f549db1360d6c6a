"""The port's checkpoint/resume against the JAX package on the same numpy
inputs: the four cases of ``tests/test_checkpoint.py`` through both packages
(SE(3) and nested engines, and a snapshot taken with rounds in flight), the
frontier snapshots of both frontier classes, and resuming a snapshot written
by either package in the other.

Tolerances: rounds and node counts equal, sse to rtol 1e-5 (atol 1e-9 for
the noise-free pair, which converges to an sse of f32 rounding, ~1e-13),
poses to 1e-4.
The SE(3) cases are pinned to ``bound_backend="exact"``, which the JAX
package picks on the CPU for these sizes; the nested engine runs the exact
expansion on every backend.
"""

import dataclasses
import os
import shutil

import numpy as np
import pytest

pytest.importorskip("jax")

import torch  # noqa: E402

from goicp_tpu.bnb import BnbParams as JBnbParams  # noqa: E402
from goicp_tpu.bnb import make_solver as jmake  # noqa: E402
from goicp_tpu_torch.bnb import BnbParams, make_solver  # noqa: E402
from goicp_tpu_torch.bnb.frontier import (  # noqa: E402
    NativeFrontier,
    PyFrontier,
    make_cube_frontier,
)
from goicp_tpu_torch.bnb.solver import load_checkpoint  # noqa: E402
from tests.conftest import random_rotation  # noqa: E402

torch.set_num_threads(1)


def _unrelated():
    rng = np.random.default_rng(4)
    src = (rng.random((150, 3)).astype(np.float32) - 0.5) * 0.6
    tgt = (rng.random((150, 3)).astype(np.float32) - 0.5) * 0.6
    return src, tgt


def _run(src, tgt, jp: JBnbParams, which: str):
    if which == "jax":
        return jmake(src, tgt, jp).run()
    return make_solver(src, tgt, BnbParams.from_dict(dataclasses.asdict(jp)), device="cpu").run()


def _agree(rt, rj, sse_atol=0.0):
    assert rt.rounds == rj.rounds and rt.converged == rj.converged
    assert rt.rot_nodes == rj.rot_nodes and rt.trans_nodes == rj.trans_nodes
    np.testing.assert_allclose(rt.sse, rj.sse, rtol=1e-5, atol=sse_atol)
    np.testing.assert_allclose(rt.transform.R, np.asarray(rj.transform.R), atol=1e-4)


SE3_HARD = dict(mse_threshold=1e-9, init_multistart=1, se3_pop=32, refine_top_k=2,
                bound_backend="exact")
NESTED_HARD = dict(engine="nested", mse_threshold=1e-9, init_multistart=1, rot_pop=4,
                   inner_levels=3, refine_top_k=2, bound_backend="exact")


@pytest.mark.parametrize("engine", ["se3", "nested"])
def test_checkpoint_resume_matches_jax(tmp_path, engine):
    """Unrelated clouds, so no pose meets the threshold and ``max_rounds``
    interrupts the search; the resume continues from the snapshot's
    frontier, incumbent and round counter, never regressing.  Both packages
    write and resume their own snapshots alike."""
    src, tgt = _unrelated()
    hard, (n1, n2, every) = (
        (SE3_HARD, (6, 12, 2)) if engine == "se3" else (NESTED_HARD, (3, 6, 1))
    )
    out = {}
    for which in ("jax", "torch"):
        ck = str(tmp_path / f"{which}.npz")
        kw = dict(hard, checkpoint_path=ck, checkpoint_every=every)
        r1 = _run(src, tgt, JBnbParams(**kw, max_rounds=n1), which)
        assert not r1.converged and os.path.exists(ck)
        r2 = _run(src, tgt, JBnbParams(**kw, max_rounds=n2), which)
        assert r2.rounds > n1 and r2.sse <= r1.sse + 1e-6
        out[which] = (r1, r2, load_checkpoint(ck))
    for a, b in zip(out["torch"][:2], out["jax"][:2]):
        _agree(a, b)
    ckt, ckj = out["torch"][2], out["jax"][2]
    for k in ("rounds", "nodes"):
        assert int(ckt[k]) == int(ckj[k]), k
    assert ckt["payload"].shape == ckj["payload"].shape
    np.testing.assert_allclose(np.sort(ckt["lb"]), np.sort(ckj["lb"]), rtol=1e-5, atol=1e-7)


def test_checkpoint_covers_inflight_rounds_matches_jax(tmp_path, monkeypatch):
    """A snapshot taken while pipelined rounds are in flight (the first such
    one; a run's last snapshot, taken after its queue drains, holds none,
    and so do those before the frontier fills).  It holds the frontiers plus
    the queued rounds' popped parents, and the node count less their
    already-counted children; it equals the JAX package's snapshot at the
    same point, and resuming either package's in either package finds the
    same optimum with the same counts."""
    import goicp_tpu_torch.bnb.se3 as se3

    rng = np.random.default_rng(11)
    src = (rng.random((60, 3)).astype(np.float32) - 0.5) * 0.6
    tgt = (src @ random_rotation(rng).T + np.float32([0.12, -0.07, 0.1])).astype(np.float32)
    hard = dict(mse_threshold=1e-6, init_multistart=1, refine_top_k=1, se3_pop=16,
                pipeline_depth=3, bound_backend="exact", checkpoint_every=1)
    written, seen = {}, []
    real_replace, real_snapshot = os.replace, se3.inflight_snapshot

    def keep_all(a, b, *args, **kw):         # both packages write tmp, then rename
        real_replace(a, b, *args, **kw)
        if str(b).endswith(".npz"):
            k = written[b] = written.get(b, -1) + 1
            shutil.copy(b, f"{str(b)[:-4]}_{k}.npz")

    def spy(drv, inflight, nodes):
        out = real_snapshot(drv, inflight, nodes)
        seen.append(dict(frontier=drv.dump_frontiers()[0].shape[0], nodes=nodes,
                         parents=sum(w["parents"][0].shape[0] for w in inflight),
                         children=sum(pt[-1] for w in inflight for pt in w["parts"]),
                         size=out[0].shape[0], out_nodes=out[3]))
        return out

    monkeypatch.setattr(os, "replace", keep_all)
    monkeypatch.setattr(se3, "inflight_snapshot", spy)
    r1 = {}
    for which in ("jax", "torch"):
        ck = str(tmp_path / f"{which}.npz")
        r1[which] = _run(src, tgt, JBnbParams(**hard, max_rounds=5, checkpoint_path=ck), which)
        assert not r1[which].converged
    _agree(r1["torch"], r1["jax"])
    assert len(seen) == written[str(tmp_path / "torch.npz")] + 1
    k = next(i for i, s in enumerate(seen) if s["parents"])
    s0 = seen[k]
    assert s0["parents"] > 0 and s0["children"] > 0, s0
    assert s0["size"] == s0["frontier"] + s0["parents"], s0
    assert s0["out_nodes"] == s0["nodes"] - s0["children"], s0
    for which in ("jax", "torch"):
        shutil.copy(str(tmp_path / f"{which}_{k}.npz"), str(tmp_path / f"{which}_first.npz"))
    snap_t, snap_j = (load_checkpoint(str(tmp_path / f"{w}_first.npz")) for w in ("torch", "jax"))
    assert snap_t["payload"].shape[0] == s0["size"] and int(snap_t["nodes"]) == s0["out_nodes"]
    assert not seen[-1]["parents"]          # the last snapshot: the queue has drained
    for k in ("rounds", "nodes"):
        assert int(snap_t[k]) == int(snap_j[k]), k
    assert snap_t["payload"].shape == snap_j["payload"].shape
    np.testing.assert_allclose(np.sort(snap_t["lb"]), np.sort(snap_j["lb"]), rtol=1e-5, atol=1e-7)
    res = {}
    for writer in ("jax", "torch"):
        for which in ("jax", "torch"):
            ck = str(tmp_path / f"{writer}_by_{which}.npz")
            shutil.copy(str(tmp_path / f"{writer}_first.npz"), ck)
            r2 = _run(src, tgt, JBnbParams(**hard, max_rounds=100000, checkpoint_path=ck), which)
            assert r2.converged
            pts = src @ np.asarray(r2.transform.R).T + np.asarray(r2.transform.t)
            assert float(np.sqrt(np.mean(np.sum((pts - tgt) ** 2, axis=1)))) < 5e-3
            res[writer, which] = r2
    for writer in ("jax", "torch"):    # a noise-free pair: both end at f32 rounding
        _agree(res[writer, "torch"], res[writer, "jax"], sse_atol=1e-9)


@pytest.mark.parametrize("writer", ["jax", "torch"])
@pytest.mark.parametrize("engine", ["se3", "nested"])
def test_snapshot_resumes_in_the_other_package(tmp_path, writer, engine):
    """A snapshot written by one package resumes in the other with the same
    rounds, nodes and sse as the writer resuming it itself."""
    src, tgt = _unrelated()
    hard, (n1, n2, every) = (
        (SE3_HARD, (6, 10, 2)) if engine == "se3" else (NESTED_HARD, (2, 3, 1))
    )
    ck = str(tmp_path / "snap.npz")
    _run(src, tgt, JBnbParams(**hard, max_rounds=n1, checkpoint_path=ck,
                              checkpoint_every=every), writer)
    res = {}
    for which in ("jax", "torch"):
        mine = str(tmp_path / f"{which}.npz")
        shutil.copy(ck, mine)
        res[which] = _run(src, tgt, JBnbParams(**hard, max_rounds=n2, checkpoint_path=mine,
                                               checkpoint_every=every), which)
    assert res["torch"].rounds == n2
    _agree(res["torch"], res["jax"])


@pytest.mark.parametrize("cls", [PyFrontier, NativeFrontier])
def test_frontier_dump_roundtrip(rng, cls):
    f = cls(8)
    pay = rng.random((40, 8)).astype(np.float32)
    lb = rng.random(40).astype(np.float32)
    ub = rng.random(40).astype(np.float32)
    f.push(pay, lb, ub)
    p2, l2, u2 = f.dump()
    assert len(f) == 40                      # dump is non-destructive
    order = np.argsort(l2)
    np.testing.assert_array_equal(l2[order], np.sort(lb))
    np.testing.assert_array_equal(p2[order], pay[np.argsort(lb)])
    np.testing.assert_array_equal(u2[order], ub[np.argsort(lb)])
    assert cls(8).dump()[0].shape == (0, 8)


def test_cube_frontier_matches_jax(rng):
    """The nested engine's cube frontier pops, prunes and dumps like the JAX
    package's."""
    from goicp_tpu.bnb.frontier import make_cube_frontier as jmake_cube

    cen = rng.random((50, 3)).astype(np.float32)
    spn = rng.random(50).astype(np.float32)
    lb = np.round(rng.random(50), 1).astype(np.float32)      # ties
    ub = rng.random(50).astype(np.float32)
    ft, fj = make_cube_frontier(), jmake_cube()
    for f in (ft, fj):
        f.push(cen, spn, lb, ub)
    for k in (5, 7):
        for a, b in zip(ft.pop_best(k), fj.pop_best(k)):
            np.testing.assert_array_equal(a, b)
    assert ft.prune(0.5) == fj.prune(0.5) and len(ft) == len(fj)
    for a, b in zip(ft.dump(), fj.dump()):
        np.testing.assert_array_equal(a, b)
    assert ft.min_lb() == fj.min_lb()
