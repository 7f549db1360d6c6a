"""The port's multi-process solve (``goicp_tpu_torch.dist.multihost``) and
``register_pairs_distributed``: real processes under gloo on the CPU, the
cases of ``tests/test_multihost.py`` on ``tests/multihost_worker.py``'s
problem (seed 77, 150 points), beside the JAX package's own worker.

This file is also its own worker: ``python tests/test_torch_multihost.py
solve|pairs <rank> <nproc> <store> <out.json> [options]`` joins a gloo
group through a ``file://`` store (no TCP port to collide with other
tests) with a timeout, so a mismatched collective fails instead of hanging.
"""

import json
import os
import subprocess
import sys

_HERE = os.path.dirname(os.path.abspath(__file__))
_ROOT = os.path.dirname(_HERE)
_TIMEOUT_S = 300


def _problem(trim: float):
    """``tests/multihost_worker.py``'s problem, noise-free."""
    import numpy as np

    rng = np.random.default_rng(77)
    src = (rng.random((150, 3)).astype(np.float32) - 0.5) * 0.6
    A = rng.normal(size=(3, 3))
    Q, Ru = np.linalg.qr(A)
    Q = (Q * np.sign(np.diag(Ru))).astype(np.float32)
    if np.linalg.det(Q) < 0:
        Q[:, 0] *= -1
    t = np.float32([0.12, -0.07, 0.09])
    tgt = (src @ Q.T + t).astype(np.float32)
    if trim > 0:
        k = max(1, int(tgt.shape[0] * trim / 2))
        tgt[:k] += rng.normal(size=(k, 3)).astype(np.float32) * 2.0
    return src, tgt, Q, t


def _pairs(n):
    """``tests/multipair_worker.py``'s pairs."""
    import numpy as np

    out = []
    rng = np.random.default_rng(5)
    for k in range(n):
        src = (rng.random((40 + 8 * k, 3)).astype(np.float32) - 0.5)
        A = rng.normal(size=(3, 3))
        Q, Ru = np.linalg.qr(A)
        Q = (Q * np.sign(np.diag(Ru))).astype(np.float32)
        if np.linalg.det(Q) < 0:
            Q[:, 0] *= -1
        t = (rng.random(3).astype(np.float32) - 0.5) * 0.3
        out.append(((src, (src @ Q.T + t).astype(np.float32)), (Q, t)))
    return out


def _worker(argv):
    """One process of a port run: ``solve`` (the multi-process engine
    through ``make_solver``) or ``pairs`` (``register_pairs_distributed``)."""
    import datetime

    import numpy as np
    import torch
    import torch.distributed as dist

    sys.path.insert(0, _ROOT)
    from goicp_tpu_torch.bnb import BnbParams, make_solver
    from goicp_tpu_torch.multipair import register_pairs_distributed

    torch.set_num_threads(1)
    mode, rank, nproc, store, out_path = argv[0], int(argv[1]), int(argv[2]), argv[3], argv[4]
    opts = json.loads(argv[5]) if len(argv) > 5 else {}
    if nproc > 1:
        dist.init_process_group("gloo", init_method=f"file://{store}", rank=rank,
                                world_size=nproc, timeout=datetime.timedelta(seconds=120))
    try:
        if mode == "pairs":
            data = _pairs(3)
            params = BnbParams(mse_threshold=1e-4, bound_backend="exact", se3_pop=32,
                               init_multistart=8, refine_top_k=4, max_rounds=400,
                               max_wall_s=180.0)
            results = register_pairs_distributed([d[0] for d in data], params, device="cpu")
            rec = []
            for ((src, _), (Q, t_true)), res in zip(data, results):
                pts = src @ np.asarray(res.transform.R).T + np.asarray(res.transform.t)
                rec.append({
                    "converged": bool(res.converged),
                    "rmse_vs_gt": float(np.sqrt(np.mean(np.sum((pts - (src @ Q.T + t_true)) ** 2,
                                                               axis=1)))),
                    "R": np.asarray(res.transform.R).tolist(),
                    "rot_nodes": res.rot_nodes, "rounds": res.rounds,
                })
            out = rec
        else:
            trim = float(opts.get("trim", 0.0))
            src, tgt, Q, t_true = _problem(trim)
            params = BnbParams(
                mse_threshold=1e-4 if trim else 1e-5, bound_backend="exact", se3_pop=32,
                init_multistart=1, refine_top_k=4, max_rounds=int(opts.get("max_rounds", 600)),
                trim_fraction=trim, max_wall_s=240.0, mesh_cubes=int(opts.get("mesh_cubes", 1)),
                checkpoint_path=opts.get("checkpoint") or None, checkpoint_every=3,
            )
            res = make_solver(src, tgt, params, device=opts.get("device", "cpu")).run()
            pts = src @ np.asarray(res.transform.R).T + np.asarray(res.transform.t)
            out = {
                "pid": rank, "converged": bool(res.converged), "mse": float(res.mse),
                "rmse_vs_gt": float(np.sqrt(np.mean(np.sum((pts - (src @ Q.T + t_true)) ** 2,
                                                           axis=1)))),
                "rounds": res.rounds, "local_nodes": res.rot_nodes,
                "rebalances": int(res.metrics.counters.get("rebalances", 0)),
                "R": np.asarray(res.transform.R).tolist(),
                "t": np.asarray(res.transform.t).tolist(),
            }
        with open(out_path, "w") as f:
            json.dump(out, f)
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


if __name__ == "__main__":
    _worker(sys.argv[1:])
    sys.exit(0)


import numpy as np  # noqa: E402
import pytest  # noqa: E402

pytest.importorskip("jax")

import torch  # noqa: E402

torch.set_num_threads(1)


def _env():
    env = dict(os.environ)
    env["PYTHONPATH"] = _ROOT + os.pathsep + env.get("PYTHONPATH", "")
    env["OMP_NUM_THREADS"] = "1"
    return env


def _collect(procs, outs):
    results = []
    for pr, out in zip(procs, outs):
        try:
            stdout, _ = pr.communicate(timeout=_TIMEOUT_S)
        except subprocess.TimeoutExpired:
            for q in procs:
                q.kill()
            raise
        assert pr.returncode == 0, stdout.decode()[-3000:]
        with open(out) as f:
            results.append(json.load(f))
    return results


def _run(nproc, tmp_path, tag, mode="solve", **opts):
    """The port's worker at ``nproc`` processes."""
    store = tmp_path / f"store_{tag}"
    outs = [tmp_path / f"port_{tag}_{r}.json" for r in range(nproc)]
    procs = [subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), mode, str(r), str(nproc), str(store),
         str(outs[r]), json.dumps(opts)],
        env=_env(), stdout=subprocess.PIPE, stderr=subprocess.STDOUT) for r in range(nproc)]
    return _collect(procs, outs)


def _free_port() -> int:
    import socket

    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def _run_jax(nproc, tmp_path, tag, worker="multihost_worker.py", args=(), extra_env=None):
    """The JAX package's own worker, unchanged, at ``nproc`` processes."""
    env = _env()
    env.update(extra_env or {})
    port = _free_port()
    outs = [tmp_path / f"jax_{tag}_{r}.json" for r in range(nproc)]
    procs = [subprocess.Popen(
        [sys.executable, os.path.join(_HERE, worker), str(r), str(nproc), str(port),
         str(outs[r]), *map(str, args)],
        env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT) for r in range(nproc)]
    return _collect(procs, outs)


def _same_pose(runs, atol=1e-6):
    for r in runs:
        assert np.allclose(r["R"], runs[0]["R"], atol=atol)


def test_two_processes_match_single_process(tmp_path):
    single = _run(1, tmp_path, "single")[0]
    duo = _run(2, tmp_path, "duo")
    assert single["converged"] and single["rmse_vs_gt"] < 1e-3
    for r in duo:
        assert r["converged"] and r["rmse_vs_gt"] < 1e-3, r
        assert abs(r["mse"] - single["mse"]) < 1e-9
    _same_pose(duo)
    # the work was split: both processes expanded nodes of their own slices
    assert min(r["local_nodes"] for r in duo) > 0


def test_two_processes_match_jax_package(tmp_path):
    """The port and the JAX package's ``tests/multihost_worker.py`` at two
    processes each: same converged flag, pose (1e-6), mse, rounds and
    per-rank local nodes."""
    port = _run(2, tmp_path, "pj")
    jax_runs = _run_jax(2, tmp_path, "pj")
    for a, b in zip(port, jax_runs):
        assert a["converged"] == b["converged"]
        np.testing.assert_allclose(a["R"], b["R"], atol=1e-6)
        assert abs(a["mse"] - b["mse"]) < 1e-9
        assert (a["rounds"], a["local_nodes"]) == (b["rounds"], b["local_nodes"]), (a, b)


def test_two_processes_with_local_mesh(tmp_path):
    """Both axes: 2 processes × a local (2 cubes × 1) mesh of CPU shards."""
    duo = _run(2, tmp_path, "mesh", mesh_cubes=2)
    for r in duo:
        assert r["converged"] and r["rmse_vs_gt"] < 1e-3, r
    _same_pose(duo)
    assert min(r["local_nodes"] for r in duo) > 0


def test_checkpoint_resume_two_processes(tmp_path):
    """Stop a 2-process solve at max_rounds 6, resume from the per-process
    slices and converge; the resumed solve continues the snapshot."""
    ck = str(tmp_path / "mh.ck")
    first = _run(2, tmp_path, "ck_a", checkpoint=ck, max_rounds=6)
    assert not any(r["converged"] for r in first), first
    for pid in range(2):
        assert os.path.exists(f"{ck}.p{pid}of2")
    resumed = _run(2, tmp_path, "ck_b", checkpoint=ck, max_rounds=600)
    for r in resumed:
        assert r["converged"] and r["rmse_vs_gt"] < 1e-3, r
    _same_pose(resumed)
    assert min(r["rounds"] for r in resumed) > 6


def test_two_processes_trimmed_robust(tmp_path):
    """10 % far outliers, trim 0.2: both slices drive the trimmed path to
    the truth."""
    duo = _run(2, tmp_path, "trim", trim=0.2)
    for r in duo:
        assert r["converged"] and r["rmse_vs_gt"] < 2e-3, r
    _same_pose(duo)


def test_checkpoint_mixed_cut_starts_fresh(tmp_path):
    """Slices of different iterations are no consistent cut: the solve
    starts afresh (from round 0) and still converges."""
    ck = str(tmp_path / "mh.ck")
    first = _run(2, tmp_path, "mx_a", checkpoint=ck, max_rounds=6)
    assert not any(r["converged"] for r in first)
    f1 = f"{ck}.p1of2"
    with np.load(f1) as f:
        d = {k: f[k] for k in f.files}
    d["it"] = np.int64(int(d["it"]) - 3)
    np.savez(f1 + ".tmp.npz", **d)
    os.replace(f1 + ".tmp.npz", f1)
    resumed = _run(2, tmp_path, "mx_b", checkpoint=ck, max_rounds=600)
    for r in resumed:
        assert r["converged"] and r["rmse_vs_gt"] < 1e-3, r


def test_port_resumes_jax_slices(tmp_path):
    """A 2-process JAX run stopped at 6 rounds writes its per-process
    slices; the port's 2-process run resumes them and converges."""
    ck = str(tmp_path / "x.ck")
    first = _run_jax(2, tmp_path, "x_a", args=(1, ck, 6))
    assert not any(r["converged"] for r in first)
    resumed = _run(2, tmp_path, "x_b", checkpoint=ck, max_rounds=600)
    for r in resumed:
        assert r["converged"] and r["rmse_vs_gt"] < 1e-3, r
    _same_pose(resumed)
    assert min(r["rounds"] for r in resumed) > 6


def test_register_pairs_distributed_two_processes(tmp_path):
    """Pairs split over two processes: every process gets the whole result
    list, equal on both, and equal in pose to the JAX package's
    ``tests/multipair_worker.py`` at two processes."""
    duo = _run(2, tmp_path, "pairs", mode="pairs")
    jax_runs = _run_jax(2, tmp_path, "pairs", worker="multipair_worker.py")
    assert duo[0] == duo[1]
    assert len(duo[0]) == 3
    for a, b in zip(duo[0], jax_runs[0]):
        assert a["converged"] and a["rmse_vs_gt"] < 1e-3, a
        assert a["converged"] == b["converged"]
        np.testing.assert_allclose(a["R"], b["R"], atol=1e-5)
