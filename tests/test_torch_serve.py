"""The port's registration service (``goicp_tpu_torch.serve``): the cases of
``tests/test_serve.py`` on the CPU path (``device="cpu"``), at the same
small size (120-point target, ``grid_resolution=24``), and parity with the
JAX package's ``serve_stdio`` on the same requests."""

import io
import json
import socket
import subprocess
import sys
import threading
import time

import numpy as np
import pytest

pytest.importorskip("jax")

import torch  # noqa: E402

from goicp_tpu_torch import multipair_lockstep as ml  # noqa: E402
from goicp_tpu_torch.bnb import BnbParams  # noqa: E402
from goicp_tpu_torch.serve import (  # noqa: E402
    Batcher,
    RegistrationService,
    handle_request,
    serve_stdio,
    serve_tcp,
)
from tests.conftest import random_rotation  # noqa: E402

torch.set_num_threads(1)
CPU = "cpu"


PARAMS = BnbParams(
    mse_threshold=1e-4,
    grid_resolution=24,
    max_rounds=400,
    init_multistart=4,
    se3_pop=64,
)


@pytest.fixture(scope="module")
def service():
    rng = np.random.default_rng(7)
    tgt = (rng.random((120, 3)).astype(np.float32) - 0.5)
    return RegistrationService(tgt, PARAMS, name="unit-target", device=CPU)


def _query(service, rng, n=90):
    """A source that is a rigidly-moved target subsample + its GT pose."""
    Q = random_rotation(rng)
    t = (rng.random(3).astype(np.float32) - 0.5) * 0.3
    idx = rng.choice(service.tgt.shape[0], n, replace=False)
    # src such that src @ Q.T + t lands on the target subset
    src = ((service.tgt[idx] - t) @ Q).astype(np.float32)
    return src, Q, t


def test_register_single(service, rng):
    src, Q, t = _query(service, rng)
    res = service.register(src)
    assert res.converged
    assert np.allclose(np.asarray(res.transform.R), Q, atol=5e-3)
    assert np.allclose(np.asarray(res.transform.t), t, atol=5e-3)


def test_register_batch_matches_singles(service, rng):
    queries = [_query(service, rng, n=80) for _ in range(3)]
    batch = service.register_batch([q[0] for q in queries])
    assert len(batch) == 3
    for res, (src, Q, t) in zip(batch, queries):
        assert res.converged
        a = src @ np.asarray(res.transform.R).T + np.asarray(res.transform.t)
        b = src @ Q.T + t
        assert float(np.sqrt(np.mean(np.sum((a - b) ** 2, 1)))) < 5e-3


def test_param_override_whitelist(service, rng):
    src, _, _ = _query(service, rng)
    res = service.register(src, mse_threshold=1e-2)
    assert res.converged
    with pytest.raises(ValueError, match="forbidden"):
        service.register(src, engine="nested")


def test_handle_request_points_and_errors(service, rng):
    src, Q, t = _query(service, rng)
    resp = handle_request(
        service, {"id": 42, "points": src.tolist()}
    )
    assert resp["ok"] and resp["id"] == 42 and resp["converged"]
    assert np.allclose(np.array(resp["R"]), Q, atol=5e-3)

    bad = handle_request(service, {"id": 7, "source": "/nonexistent.ply"})
    assert bad == {"id": 7, "ok": False, "error": bad["error"]}
    assert "id" in bad and not bad["ok"]

    info = handle_request(service, {"cmd": "info"})
    assert info["ok"] and info["target_points"] == service.tgt.shape[0]


def test_handle_request_batch_isolates_bad_items(service, rng):
    g1, g2 = _query(service, rng, n=70), _query(service, rng, n=70)
    resp = handle_request(service, {"batch": [
        {"id": 1, "points": g1[0].tolist()},
        {"id": 2, "source": "/nope.ply"},
        {"id": 3, "points": g2[0].tolist()},
    ]})
    assert [r["id"] for r in resp] == [1, 2, 3]
    assert resp[0]["ok"] and resp[2]["ok"] and not resp[1]["ok"]
    assert resp[0]["converged"] and resp[2]["converged"]


def test_serve_stdio_roundtrip(service, rng):
    src, Q, t = _query(service, rng)
    lines = [
        json.dumps({"id": "a", "points": src.tolist()}),
        json.dumps({"cmd": "info"}),
        "this is not json",
        json.dumps({"cmd": "shutdown"}),
        json.dumps({"id": "never", "points": src.tolist()}),
    ]
    out = io.StringIO()
    n = serve_stdio(service, io.StringIO("\n".join(lines) + "\n"), out)
    resp = [json.loads(l) for l in out.getvalue().splitlines()]
    assert n == 2  # register + info; bad json answered but not counted
    assert resp[0]["ok"] and resp[0]["id"] == "a"
    assert resp[1]["ok"] and "target_points" in resp[1]
    assert not resp[2]["ok"]
    assert resp[3].get("shutdown") is True
    assert len(resp) == 4  # nothing served after shutdown


def test_tcp_concurrent_queries_microbatch(service, rng):
    ready = threading.Event()
    bound: list = []
    srv = threading.Thread(
        target=serve_tcp,
        kwargs=dict(service=service, port=0, max_batch=4, window_s=0.25,
                    ready=ready, bound=bound),
        daemon=True,
    )
    srv.start()
    assert ready.wait(10)
    port = bound[0]

    queries = [_query(service, rng, n=60) for _ in range(3)]
    results = [None] * 3

    def client(i):
        with socket.create_connection(("127.0.0.1", port), timeout=60) as s:
            f = s.makefile("rw")
            f.write(json.dumps(
                {"id": i, "points": queries[i][0].tolist()}) + "\n")
            f.flush()
            results[i] = json.loads(f.readline())

    threads = [threading.Thread(target=client, args=(i,)) for i in range(3)]
    for th in threads:
        th.start()
        time.sleep(0.02)  # arrive within one gather window
    for th in threads:
        th.join(timeout=120)
    for i, r in enumerate(results):
        assert r is not None and r["ok"] and r["id"] == i, r
        src, Q, t = queries[i]
        a = src @ np.array(r["R"]).T + np.array(r["t"])
        b = src @ Q.T + t
        assert float(np.sqrt(np.mean(np.sum((a - b) ** 2, 1)))) < 5e-3

    with socket.create_connection(("127.0.0.1", port), timeout=10) as s:
        f = s.makefile("rw")
        f.write(json.dumps({"cmd": "shutdown"}) + "\n")
        f.flush()
        assert json.loads(f.readline())["shutdown"] is True
    srv.join(timeout=10)


def test_batcher_groups_uniform_requests(service, rng):
    b = Batcher(service, max_batch=4, window_s=0.2)
    b.start()
    reqs = [
        {"id": i, "points": _query(service, rng, n=50)[0].tolist()}
        for i in range(3)
    ]
    pend = [b.submit(r) for r in reqs]
    for p in pend:
        assert p.event.wait(120)
        assert p.resp["ok"], p.resp
    assert 3 in b.batches  # the three uniform queries shared one lockstep
    b.stop()


def test_refine_tracking_path(service, rng):
    """mode=icp: local refinement from a prior — converges from a nearby
    init, reports icp_iters, and never opens a BnB tree."""
    from goicp_tpu_torch.core.types import RigidTransform
    from goicp_tpu_torch.geo.rotation import axis_angle_rotation

    src, Q, t = _query(service, rng)
    # perturb the GT pose slightly: the tracking prior
    dR = axis_angle_rotation(torch.tensor([0.05, -0.03, 0.02])).numpy()
    init = RigidTransform((dR @ Q).astype(np.float32), t + 0.01)
    res = service.refine(src, init)
    assert res.converged and res.rot_nodes == 0 and res.icp_iters > 0
    assert np.allclose(np.asarray(res.transform.R), Q, atol=5e-3)

    # far-off init: honest failure (no global search in icp mode)
    bad = service.refine(src, None)
    assert isinstance(bad.converged, bool)


def test_refine_batch_matches_singles(service, rng):
    from goicp_tpu_torch.core.types import RigidTransform

    queries = [_query(service, rng, n=60) for _ in range(3)]
    inits = [RigidTransform(Q.astype(np.float32), t) for _, Q, t in queries]
    batch = service.refine_batch([q[0] for q in queries], inits=inits)
    singles = [
        service.refine(q[0], i) for q, i in zip(queries, inits)
    ]
    for b, s in zip(batch, singles):
        assert b.converged == s.converged
        assert np.allclose(
            np.asarray(b.transform.R), np.asarray(s.transform.R), atol=1e-4
        )


def test_refine_batch_grid_path_and_padding(rng):
    """Batched tracking through the resident GRID correspondence (large-
    target path) with mixed source sizes (padding weights)."""
    import dataclasses

    from goicp_tpu_torch.core.types import RigidTransform
    tgt = (np.random.default_rng(21).random((140, 3)).astype(np.float32)
           - 0.5)
    # force the grid correspondence (as if the target were huge) and use a
    # fine grid so the index lookups resolve the true neighbors
    params = dataclasses.replace(PARAMS, icp_exact_max=10,
                                 grid_resolution=64)
    svc = RegistrationService(tgt, params, name="grid-track", device=CPU)
    queries, inits = [], []
    for n in (60, 90):
        Q = random_rotation(rng)
        t = (rng.random(3).astype(np.float32) - 0.5) * 0.1
        idx = rng.choice(140, n, replace=False)
        queries.append(((tgt[idx] - t) @ Q).astype(np.float32))
        inits.append(RigidTransform(Q, t))   # perfect prior: must converge
    out = svc.refine_batch(queries, inits=inits)
    assert len(out) == 2
    for res, q, T in zip(out, queries, inits):
        assert res.converged, (res.mse,)
        a = q @ np.asarray(res.transform.R).T + np.asarray(res.transform.t)
        b = q @ np.asarray(T.R).T + np.asarray(T.t)
        assert float(np.abs(a - b).max()) < 1e-2


def test_wire_init_and_mode(service, rng):
    src, Q, t = _query(service, rng, n=70)
    req = {
        "id": "trk",
        "points": src.tolist(),
        "mode": "icp",
        "init": {"R": Q.tolist(), "t": t.tolist()},
    }
    resp = handle_request(service, req)
    assert resp["ok"] and resp["converged"] and resp["nodes"] == 0
    assert resp["icp_iters"] > 0
    assert np.allclose(np.array(resp["R"]), Q, atol=5e-3)

    bad = handle_request(
        service,
        {"points": src.tolist(), "init": {"R": np.eye(3)[:2].tolist()}},
    )
    assert not bad["ok"] and "init" in bad["error"]
    bad2 = handle_request(
        service,
        {"points": src.tolist(),
         "init": {"R": (2 * np.eye(3)).tolist(), "t": [0, 0, 0]}},
    )
    assert not bad2["ok"] and "rotation" in bad2["error"]
    bad3 = handle_request(service, {"points": src.tolist(), "mode": "warp"})
    assert not bad3["ok"] and "mode" in bad3["error"]


def test_wire_batch_mixed_lanes(service, rng):
    g1, g2, g3 = (_query(service, rng, n=60) for _ in range(3))
    resp = handle_request(service, {"batch": [
        {"id": 0, "points": g1[0].tolist()},                       # goicp lane
        {"id": 1, "points": g2[0].tolist(), "mode": "icp",
         "init": {"R": g2[1].tolist(), "t": g2[2].tolist()}},      # icp lane
        {"id": 2, "points": g3[0].tolist(),
         "init": {"R": g3[1].tolist(), "t": g3[2].tolist()}},      # solo
    ]})
    assert [r["id"] for r in resp] == [0, 1, 2]
    assert all(r["ok"] and r["converged"] for r in resp), resp
    for r, (srcq, Q, t) in zip(resp, (g1, g2, g3)):
        a = srcq @ np.array(r["R"]).T + np.array(r["t"])
        b = srcq @ Q.T + t
        assert float(np.sqrt(np.mean(np.sum((a - b) ** 2, 1)))) < 5e-3


def test_wire_per_item_batch_overrides_and_unknown_keys(service, rng):
    src, Q, t = _query(service, rng, n=60)
    init = {"R": Q.tolist(), "t": t.tolist()}
    resp = handle_request(service, {"batch": [
        {"id": 0, "points": src.tolist(), "mode": "icp", "init": init},
        # per-item override: impossible threshold -> honest converged=False
        {"id": 1, "points": src.tolist(), "mode": "icp", "init": init,
         "mse_threshold": 1e-22},
    ]})
    assert resp[0]["ok"] and resp[0]["converged"]
    assert resp[1]["ok"] and not resp[1]["converged"]

    bad = handle_request(service, {"points": src.tolist(), "subsmaple": 0.5})
    assert not bad["ok"] and "subsmaple" in bad["error"]
    badcmd = handle_request(service, {"cmd": "reboot"})
    assert not badcmd["ok"] and "reboot" in badcmd["error"]


def test_source_root_policy(service, rng, tmp_path):
    import dataclasses as _d

    # paths disabled (the TCP default)
    service.source_root = ""
    try:
        r = handle_request(service, {"id": 1, "source": "x.ply"})
        assert not r["ok"] and "disabled" in r["error"]
        # confined: escapes rejected, relative paths resolve under the root
        service.source_root = str(tmp_path)
        r = handle_request(service, {"id": 2, "source": "../../etc/passwd"})
        assert not r["ok"] and "escapes" in r["error"]
        src, Q, t = _query(service, rng, n=50)
        with open(tmp_path / "q.txt", "w") as f:
            f.write(f"{len(src)}\n")
            for row in src:
                f.write(f"{row[0]} {row[1]} {row[2]}\n")
        r = handle_request(service, {"id": 3, "source": "q.txt"})
        assert r["ok"] and r["converged"]
        assert np.allclose(np.array(r["R"]), Q, atol=5e-3)
    finally:
        service.source_root = None


def test_warmup_oversampled_query_shape(service):
    # n_src > target size: warms the exact requested shape via resampling
    res = service.warmup(service.tgt.shape[0] + 30)
    assert res.converged


def test_grid_reuse_matches_fresh_solver(service, rng):
    from goicp_tpu_torch.bnb import make_solver

    src, Q, t = _query(service, rng)
    fresh = make_solver(src, service.tgt, PARAMS, device=CPU).run()
    reused = make_solver(src, service.tgt, PARAMS, grid=service.grid, device=CPU).run()
    assert np.allclose(
        np.asarray(fresh.transform.R), np.asarray(reused.transform.R),
        atol=1e-5,
    )
    assert np.allclose(
        np.asarray(fresh.transform.t), np.asarray(reused.transform.t),
        atol=1e-5,
    )


def test_multi_target_service(service, rng):
    """Model zoo: queries pick a resident target by name; lanes group per
    target; unknown names are rejected."""
    from goicp_tpu_torch.serve import MultiTargetService

    tgt_b = (rng.random((110, 3)).astype(np.float32) - 0.5) * 0.8 + 2.0
    svc_b = RegistrationService(tgt_b, PARAMS, name="b", device=CPU)
    zoo = MultiTargetService({"a": service, "b": svc_b})

    # a query cut from target b must be solved against b, not the default a
    Q = random_rotation(rng)
    t = (rng.random(3).astype(np.float32) - 0.5) * 0.2
    idx = rng.choice(110, 80, replace=False)
    src_b = ((tgt_b[idx] - t) @ Q).astype(np.float32)
    r = handle_request(
        zoo, {"id": 1, "points": src_b.tolist(), "target": "b"}
    )
    assert r["ok"] and r["converged"]
    assert np.allclose(np.array(r["R"]), Q, atol=5e-3)

    bad = handle_request(zoo, {"points": src_b.tolist(), "target": "zzz"})
    assert not bad["ok"] and "zzz" in bad["error"]

    info = handle_request(zoo, {"cmd": "info"})
    assert set(info["targets"]) == {"a", "b"} and info["default"] == "a"

    # mixed-target batch: each lane solves against its own target
    src_a, Qa, ta = _query(service, rng, n=70)
    resp = handle_request(zoo, {"batch": [
        {"id": 0, "points": src_a.tolist(), "target": "a"},
        {"id": 1, "points": src_b.tolist(), "target": "b"},
    ]})
    assert all(x["ok"] and x["converged"] for x in resp), resp
    assert np.allclose(np.array(resp[0]["R"]), Qa, atol=5e-3)
    assert np.allclose(np.array(resp[1]["R"]), Q, atol=5e-3)

    # single-target services reject foreign target names
    solo = handle_request(
        service, {"points": src_a.tolist(), "target": "other"}
    )
    assert not solo["ok"] and "other" in solo["error"]


def test_multi_target_tcp(service, rng):
    """Regression: serve_tcp must start with a MultiTargetService (it reads
    service.name) and route per-target queries over the wire."""
    from goicp_tpu_torch.serve import MultiTargetService

    tgt_c = (rng.random((90, 3)).astype(np.float32) - 0.5) * 0.5 - 1.5
    zoo = MultiTargetService(
        {"a": service, "c": RegistrationService(tgt_c, PARAMS, name="c", device=CPU)}
    )
    ready = threading.Event()
    bound: list = []
    srv = threading.Thread(
        target=serve_tcp,
        kwargs=dict(service=zoo, port=0, window_s=0.01, ready=ready,
                    bound=bound),
        daemon=True,
    )
    srv.start()
    assert ready.wait(10), "multi-target TCP server failed to start"

    Q = random_rotation(rng)
    t = (rng.random(3).astype(np.float32) - 0.5) * 0.2
    idx = rng.choice(90, 70, replace=False)
    src_c = ((tgt_c[idx] - t) @ Q).astype(np.float32)
    with socket.create_connection(("127.0.0.1", bound[0]), timeout=60) as s:
        f = s.makefile("rw")
        f.write(json.dumps(
            {"id": 1, "points": src_c.tolist(), "target": "c"}) + "\n")
        f.flush()
        r = json.loads(f.readline())
        assert r["ok"] and r["converged"], r
        assert np.allclose(np.array(r["R"]), Q, atol=5e-3)
        info = json.loads((f.write(json.dumps({"cmd": "info"}) + "\n"),
                           f.flush(), f.readline())[-1])
        assert set(info["targets"]) == {"a", "c"}
        assert "defaults" in info  # single-target response shape preserved
        f.write(json.dumps({"cmd": "shutdown"}) + "\n")
        f.flush()
        assert json.loads(f.readline())["shutdown"] is True
    srv.join(timeout=10)


def test_batch_envelope_unknown_keys_rejected(service, rng):
    src, _, _ = _query(service, rng, n=50)
    r = handle_request(service, {
        "batch": [{"points": src.tolist()}], "mse_treshold": 1e-6,
    })
    assert isinstance(r, dict) and not r["ok"] and "mse_treshold" in r["error"]


def test_warmup_runs(service):
    res = service.warmup(64)
    assert res.converged


def test_serve_main_stdio_honors_toml(tmp_path, monkeypatch, rng):
    """End-to-end CLI main(): --toml defaults must actually load (regression:
    Config(args.toml) put the path into cfg.mode and ignored the file)."""
    import io
    import sys

    from goicp_tpu_torch import serve as serve_mod

    tgt = (rng.random((100, 3)).astype(np.float32) - 0.5)
    with open(tmp_path / "tgt.txt", "w") as f:
        f.write(f"{len(tgt)}\n")
        for row in tgt:
            f.write(f"{row[0]} {row[1]} {row[2]}\n")
    (tmp_path / "cfg.toml").write_text(
        "[params]\nmode = 4\nmse_threshold = 0.123\nsubsample = 1.0\n"
        "[tpu]\ngrid_resolution = 16\n"
    )
    Q = random_rotation(rng)
    src = (tgt @ Q).astype(np.float32)
    lines = [
        json.dumps({"cmd": "info"}),
        json.dumps({"id": 9, "points": src.tolist()}),
    ]
    monkeypatch.setattr(sys, "stdin", io.StringIO("\n".join(lines) + "\n"))
    out = io.StringIO()
    monkeypatch.setattr(sys, "stdout", out)
    rc = serve_mod.main([
        str(tmp_path / "tgt.txt"), "--toml", str(tmp_path / "cfg.toml"),
        "--device", "cpu",
    ])
    assert rc == 0
    info, resp = (json.loads(l) for l in out.getvalue().splitlines())
    # the distinctive TOML values must round-trip into the live service
    assert info["defaults"]["mse_threshold"] == 0.123
    assert info["grid_resolution"] == 16
    assert resp["ok"] and resp["id"] == 9 and resp["converged"]


def test_batch_goicp_priors_share_one_lockstep_dispatch(service, rng):
    """Prior-bearing goicp queries join the lockstep lane: 8 queries with
    per-query init priors run as ONE lockstep batch, each prior honored
    (still optimal)."""
    queries = [_query(service, rng, n=80) for _ in range(8)]
    subs = []
    for i, (src, Q, t) in enumerate(queries):
        subs.append({
            "id": i, "points": src.tolist(),
            "init": {"R": np.asarray(Q, np.float64).tolist(),
                     "t": np.asarray(t, np.float64).tolist()},
        })

    calls = []
    orig = ml._register_pairs_lockstep

    def spy(pairs_, p, mesh=None, **kw):
        calls.append((len(pairs_), kw.get("inits")))
        return orig(pairs_, p, mesh=mesh, **kw)

    ml._register_pairs_lockstep = spy
    try:
        resp = handle_request(service, {"batch": subs})
    finally:
        ml._register_pairs_lockstep = orig
    assert len(calls) == 1 and calls[0][0] == 8      # ONE lockstep dispatch
    assert calls[0][1] is not None and len(calls[0][1]) == 8
    assert all(T is not None for T in calls[0][1])   # per-query priors rode
    for r, (src, Q, t) in zip(resp, queries):
        assert r["ok"] and r["converged"]
        a = src @ np.array(r["R"]).T + np.array(r["t"])
        b = src @ Q.T + t
        assert float(np.sqrt(np.mean(np.sum((a - b) ** 2, 1)))) < 5e-3


def test_refine_escalates_on_tracking_loss(service, rng):
    """A tracking refine that lands above escalate_mse
    re-queues into the prior-seeded goicp lane and returns the certified
    pose with escalated=True; converged tracking never escalates."""
    from goicp_tpu_torch.core.types import RigidTransform

    src, Q, t = _query(service, rng, n=80)
    # hopeless prior: identity on a far-rotated query → refine diverges
    far = RigidTransform(np.eye(3, dtype=np.float32), np.zeros(3, np.float32))
    res = service.refine(src, far, escalate_mse=1e-3)
    assert res.escalated and res.converged and res.rot_nodes >= 0
    assert np.allclose(np.asarray(res.transform.R), Q, atol=5e-3)
    assert np.allclose(np.asarray(res.transform.t), t, atol=5e-3)

    # good prior: refine converges, NO escalation (nodes stay 0)
    good = RigidTransform(Q.astype(np.float32), t)
    res2 = service.refine(src, good, escalate_mse=1e-3)
    assert res2.converged and not res2.escalated and res2.rot_nodes == 0

    # no threshold set: the old honest-failure contract is unchanged
    res3 = service.refine(src, far)
    assert not res3.converged and not res3.escalated
    # observability: escalations surface in the info record
    assert service.info()["escalations_served"] >= 1


def test_refine_batch_escalation_one_extra_lockstep(service, rng):
    """Diverged queries in a tracking batch share ONE extra lockstep goicp
    dispatch; converged ones pass through untouched."""
    from goicp_tpu import multipair as mp
    from goicp_tpu_torch.core.types import RigidTransform

    queries = [_query(service, rng, n=80) for _ in range(3)]
    far = RigidTransform(np.eye(3, dtype=np.float32), np.zeros(3, np.float32))
    inits = [
        RigidTransform(queries[0][1].astype(np.float32), queries[0][2]),
        far,    # diverges → escalates
        far,    # diverges → escalates
    ]
    calls = []
    orig = ml._register_pairs_lockstep

    def spy(pairs_, p, mesh=None, **kw):
        calls.append(len(pairs_))
        return orig(pairs_, p, mesh=mesh, **kw)

    ml._register_pairs_lockstep = spy
    try:
        out = service.refine_batch(
            [q[0] for q in queries], inits=inits, escalate_mse=1e-3
        )
    finally:
        ml._register_pairs_lockstep = orig
    assert calls == [2]                      # ONE extra dispatch, 2 pairs
    assert not out[0].escalated and out[0].converged
    for i in (1, 2):
        assert out[i].escalated and out[i].converged
        src, Q, t = queries[i]
        a = src @ np.asarray(out[i].transform.R).T + np.asarray(
            out[i].transform.t)
        b = src @ Q.T + t
        assert float(np.sqrt(np.mean(np.sum((a - b) ** 2, 1)))) < 5e-3


def test_wire_escalation_flag(service, rng):
    """escalate_mse rides the wire whitelist; escalated responses carry
    'escalated': true; bad values are rejected with an error record."""
    src, Q, t = _query(service, rng, n=70)
    r = handle_request(service, {
        "id": "e", "points": src.tolist(), "mode": "icp",
        "init": {"R": np.eye(3).tolist(), "t": [0.0, 0.0, 0.0]},
        "escalate_mse": 1e-3,
    })
    assert r["ok"] and r["converged"] and r.get("escalated") is True
    assert np.allclose(np.array(r["R"]), Q, atol=5e-3)

    ok = handle_request(service, {
        "id": "ne", "points": src.tolist(), "mode": "icp",
        "init": {"R": Q.tolist(), "t": t.tolist()},
        "escalate_mse": 1e-3,
    })
    assert ok["ok"] and ok["converged"] and "escalated" not in ok

    bad = handle_request(service, {
        "points": src.tolist(), "mode": "icp", "escalate_mse": -1.0,
    })
    assert not bad["ok"] and "escalate_mse" in bad["error"]


def test_tcp_auth_token(service, rng):
    """With an auth token set, unauthenticated
    connections get ONE error record and a close (shutdown included);
    the {"auth": token} first-line handshake unlocks normal service."""
    ready = threading.Event()
    bound: list = []
    srv = threading.Thread(
        target=serve_tcp,
        kwargs=dict(service=service, port=0, window_s=0.01, ready=ready,
                    bound=bound, auth_token="s3cret-token"),
        daemon=True,
    )
    srv.start()
    assert ready.wait(10)
    port = bound[0]
    src, Q, t = _query(service, rng, n=60)

    def _conn():
        s = socket.create_connection(("127.0.0.1", port), timeout=60)
        return s, s.makefile("rw")

    # no handshake → one error record, closed (query never served)
    s, f = _conn()
    f.write(json.dumps({"id": 1, "points": src.tolist()}) + "\n")
    f.flush()
    r = json.loads(f.readline())
    assert not r["ok"] and "auth" in r["error"]
    assert f.readline() == ""        # server closed the connection
    s.close()

    # wrong token → same; shutdown must NOT be honored unauthenticated
    s, f = _conn()
    f.write(json.dumps({"auth": "wrong", "cmd": "shutdown"}) + "\n")
    f.flush()
    r = json.loads(f.readline())
    assert not r["ok"] and f.readline() == ""
    s.close()

    # correct token → handshake ack, then normal service
    s, f = _conn()
    f.write(json.dumps({"auth": "s3cret-token"}) + "\n")
    f.flush()
    assert json.loads(f.readline())["auth"] is True
    f.write(json.dumps({"id": 2, "points": src.tolist()}) + "\n")
    f.flush()
    r = json.loads(f.readline())
    assert r["ok"] and r["converged"], r
    assert np.allclose(np.array(r["R"]), Q, atol=5e-3)
    f.write(json.dumps({"cmd": "shutdown"}) + "\n")
    f.flush()
    assert json.loads(f.readline())["shutdown"] is True
    s.close()
    srv.join(timeout=10)


def test_register_batch_plane_metric_rides_lockstep(service, rng):
    """icp_metric='plane' batches stay on
    the lockstep path with the RESIDENT normals (no silent point-to-point
    downgrade, no per-query PCA)."""
    queries = [_query(service, rng, n=80) for _ in range(3)]

    calls = []
    orig = ml._register_pairs_lockstep

    def spy(pairs_, p, mesh=None, **kw):
        calls.append(kw.get("tgt_normals"))
        return orig(pairs_, p, mesh=mesh, **kw)

    ml._register_pairs_lockstep = spy
    try:
        batch = service.register_batch(
            [q[0] for q in queries], icp_metric="plane"
        )
    finally:
        ml._register_pairs_lockstep = orig
    assert len(calls) == 1 and calls[0] is not None  # resident normals rode
    assert np.asarray(calls[0]).shape == (service.tgt.shape[0], 3)
    for res, (src, Q, t) in zip(batch, queries):
        assert res.converged
        a = src @ np.asarray(res.transform.R).T + np.asarray(res.transform.t)
        b = src @ Q.T + t
        assert float(np.sqrt(np.mean(np.sum((a - b) ** 2, 1)))) < 5e-3


def test_tcp_auth_non_ascii_token(service, rng):
    """Non-ASCII tokens must authenticate (bytes
    compare) and wrong tokens still get ONE error record + close."""
    ready = threading.Event()
    bound: list = []
    token = "pässwörd-日本"
    srv = threading.Thread(
        target=serve_tcp,
        kwargs=dict(service=service, port=0, window_s=0.01, ready=ready,
                    bound=bound, auth_token=token),
        daemon=True,
    )
    srv.start()
    assert ready.wait(10)
    port = bound[0]
    src, Q, t = _query(service, rng, n=50)

    s = socket.create_connection(("127.0.0.1", port), timeout=60)
    f = s.makefile("rw", encoding="utf-8")
    f.write(json.dumps({"auth": "wröng"}) + "\n")
    f.flush()
    r = json.loads(f.readline())
    assert not r["ok"] and f.readline() == ""
    s.close()

    s = socket.create_connection(("127.0.0.1", port), timeout=60)
    f = s.makefile("rw", encoding="utf-8")
    f.write(json.dumps({"auth": token}) + "\n")
    f.flush()
    assert json.loads(f.readline())["auth"] is True
    f.write(json.dumps({"id": 1, "points": src.tolist()}) + "\n")
    f.flush()
    assert json.loads(f.readline())["ok"]
    f.write(json.dumps({"cmd": "shutdown"}) + "\n")
    f.flush()
    assert json.loads(f.readline())["shutdown"] is True
    s.close()
    srv.join(timeout=10)


def test_batch_lane_failure_isolated_per_item(service, rng, monkeypatch):
    """A lane dispatch that RAISES must error only its
    own items — the batch response stays one record per request."""
    g1, g2 = _query(service, rng, n=60), _query(service, rng, n=60)

    def boom(*a, **k):
        raise RuntimeError("device fell over")

    monkeypatch.setattr(type(service), "register_batch", boom)
    resp = handle_request(service, {"batch": [
        {"id": 0, "points": g1[0].tolist()},                       # goicp lane
        {"id": 1, "points": g2[0].tolist(), "mode": "icp",
         "init": {"R": g2[1].tolist(), "t": g2[2].tolist()}},      # icp lane
    ]})
    assert [r["id"] for r in resp] == [0, 1]
    assert not resp[0]["ok"] and "device fell over" in resp[0]["error"]
    assert resp[1]["ok"] and resp[1]["converged"]                  # isolated


def test_tcp_single_query_falls_back_to_the_solver(rng, monkeypatch):
    """Without shape buckets a lone TCP query leaves the lockstep for the
    single-pair solver, which then runs on the Batcher's thread."""
    from goicp_tpu_torch.bnb import solver as solver_mod

    tgt = (np.random.default_rng(8).random((100, 3)).astype(np.float32) - 0.5)
    svc = RegistrationService(tgt, PARAMS, name="solo", bucket_shapes=False, device=CPU)
    made = []
    orig = solver_mod.make_solver

    def spy(*a, **kw):
        made.append(threading.current_thread().name)
        return orig(*a, **kw)

    monkeypatch.setattr("goicp_tpu_torch.serving.service.make_solver", spy)
    ready = threading.Event()
    bound: list = []
    srv = threading.Thread(
        target=serve_tcp,
        kwargs=dict(service=svc, port=0, window_s=0.01, ready=ready, bound=bound),
        daemon=True,
    )
    srv.start()
    assert ready.wait(10)
    Q = random_rotation(rng)
    t = (rng.random(3).astype(np.float32) - 0.5) * 0.2
    src = ((tgt[rng.choice(100, 70, replace=False)] - t) @ Q).astype(np.float32)
    with socket.create_connection(("127.0.0.1", bound[0]), timeout=60) as s:
        f = s.makefile("rw")
        f.write(json.dumps({"id": 1, "points": src.tolist()}) + "\n")
        f.flush()
        r = json.loads(f.readline())
        f.write(json.dumps({"cmd": "shutdown"}) + "\n")
        f.flush()
        assert json.loads(f.readline())["shutdown"] is True
    srv.join(timeout=10)
    assert r["ok"] and r["converged"], r
    assert np.allclose(np.array(r["R"]), Q, atol=5e-3)
    assert len(made) == 1 and made[0] != threading.main_thread().name


def test_serve_stdio_matches_jax(rng):
    """The same JSON-lines session through both packages' ``serve_stdio``
    (goicp queries with and without a prior, an explicit batch, a
    tracking query): equal converged, nodes and ICP iterations, R and t to
    1e-5; and the lockstep batch's rounds equal through ``register_batch``.
    The queries carry noise 0.005, so the BnB runs and the sse stays above
    f32 rounding."""
    from goicp_tpu.bnb import BnbParams as JBnbParams
    from goicp_tpu.serve import RegistrationService as JService
    from goicp_tpu.serve import serve_stdio as jserve_stdio

    tgt = (np.random.default_rng(7).random((120, 3)).astype(np.float32) - 0.5)
    kw = dict(mse_threshold=1e-4, grid_resolution=24, max_rounds=20, init_multistart=4,
              se3_pop=64)
    jsvc = JService(tgt, JBnbParams(**kw), name="t")
    tsvc = RegistrationService(tgt, BnbParams(**kw), name="t", device=CPU)
    queries = []
    for n in (80, 90, 70):
        Q = random_rotation(rng)
        t = (rng.random(3).astype(np.float32) - 0.5) * 0.3
        idx = rng.choice(120, n, replace=False)
        src = ((tgt[idx] - t) @ Q + rng.normal(0, 0.005, (n, 3))).astype(np.float32)
        queries.append((src, Q, t))
    init = {"R": queries[1][1].tolist(), "t": queries[1][2].tolist()}
    lines = [
        json.dumps({"id": 0, "points": queries[0][0].tolist()}),
        json.dumps({"id": 1, "points": queries[1][0].tolist(), "init": init}),
        json.dumps({"batch": [{"id": 2, "points": q[0].tolist()} for q in queries]}),
        json.dumps({"id": 3, "points": queries[1][0].tolist(), "mode": "icp", "init": init}),
        json.dumps({"cmd": "shutdown"}),
    ]
    outs = []
    for svc, fn in ((jsvc, jserve_stdio), (tsvc, serve_stdio)):
        out = io.StringIO()
        fn(svc, io.StringIO("\n".join(lines) + "\n"), out)
        outs.append([json.loads(x) for x in out.getvalue().splitlines()])
    assert len(outs[0]) == len(outs[1]) == 7
    assert any(r.get("nodes", 0) > 0 for r in outs[0])
    for a, b in zip(*outs):
        assert a.get("id") == b.get("id") and a["ok"] and b["ok"]
        if "R" not in a:
            continue
        assert (a["converged"], a["nodes"], a["icp_iters"]) == \
            (b["converged"], b["nodes"], b["icp_iters"]), (a, b)
        np.testing.assert_allclose(b["R"], a["R"], atol=1e-5)
        np.testing.assert_allclose(b["t"], a["t"], atol=1e-5)
    srcs = [q[0] for q in queries]
    rj, rt = jsvc.register_batch(srcs), tsvc.register_batch(srcs)
    assert [r.rounds for r in rt] == [r.rounds for r in rj]
    assert [r.rot_nodes for r in rt] == [r.rot_nodes for r in rj]


def test_module_serve_entry_point():
    """``python -m goicp_tpu_torch serve`` dispatches to the service's CLI."""
    out = subprocess.run([sys.executable, "-m", "goicp_tpu_torch", "serve", "--help"],
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert "--port" in out.stdout and "--auth-token" in out.stdout
