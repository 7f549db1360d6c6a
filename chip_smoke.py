#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port (``goicp_tpu_torch``) on one GPU.

Run from the repository root with no arguments::

    python3 chip_smoke.py

Phases, each of which fails the run:

1. the device, and ``nvidia-smi``'s name and power limit;
2. building the CUDA kernels from ``goicp_tpu_torch/csrc`` (timed);
3. each kernel (K1 nearest neighbour, K2 screened bounds unscreened and
   screened, K3 grouped distances) against its plain PyTorch version on the
   card, on random inputs and on the bunny inputs at the solve's shapes,
   with kernel, plain and (K1) library times;
4. a certified solve of the in-repo bunny pair through ``register``, with
   every kernel's launch count during the solve and the pose error against
   the ground truth;
5. the same small solve on the card and on the CPU path, which must agree;
6. with ``--profile`` only: the bunny solve once more under
   ``torch.profiler`` (device activity), for the device's busy share of the
   solve and its device time by kernel.

The last lines are the ``kernels`` JSON line and the device JSON line.
Details go to ``chiprun_out/chip_smoke.json``.  Without CUDA, or outside the
repository, it exits non-zero and prints no result.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time
import tomllib

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
OUT_DIR = os.path.join(HERE, "chiprun_out")
PEAK_BYTES_S = 3.35e12          # H100 SXM HBM3 (NVIDIA's data sheet)
SMS, LANES = 132, 128           # H100 SXM: FP32 lanes per SM
N_SRC, N_TGT = 1518, 1797       # the headline's subsample sizes
SOLVE_WALL_S = 150.0            # BnB budget: keeps the run inside its limit
MSE_FACTOR = 0.5                # mse_threshold = MSE_FACTOR · mse at the true pose


def smi(query: str) -> str:
    out = subprocess.run(
        ["nvidia-smi", f"--query-gpu={query}", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout
    return out.strip().splitlines()[0]


def timed_ms(fn, reps: int) -> float:
    """Median CUDA-event time of ``fn()`` in ms, after one warm-up call."""
    import torch

    fn()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return float(np.median(times))


class Checks:
    def __init__(self):
        self.failed = []

    def expect(self, ok: bool, what: str):
        print(("ok   " if ok else "FAIL ") + what, flush=True)
        if not ok:
            self.failed.append(what)


def load_bunny():
    """The in-repo bunny pair: target = rotated_bunny.ply, source =
    Rᵀ(target − t), each subsampled with its own seed, both scaled by one
    factor into [−1, 1]³."""
    from goicp_tpu_torch.io import read_ply

    tgt_full = read_ply(os.path.join(HERE, "data_generated", "rotated_bunny.ply"))
    with open(os.path.join(HERE, "data_generated", "rotated_bunny_gt.toml"), "rb") as f:
        gt = tomllib.load(f)
    R = np.asarray(gt["rotation"], np.float64)
    t = np.asarray(gt["translation"], np.float64)
    src_full = (tgt_full.astype(np.float64) - t) @ R          # Rᵀ(x − t)
    n = tgt_full.shape[0]
    src = src_full[np.sort(np.random.default_rng(1).choice(n, N_SRC, replace=False))]
    tgt = tgt_full[np.sort(np.random.default_rng(2).choice(n, N_TGT, replace=False))]
    scale = 1.0 / max(np.abs(src).max(), np.abs(tgt).max())
    return (
        (src * scale).astype(np.float32), (tgt * scale).astype(np.float32),
        R.astype(np.float32), (t * scale).astype(np.float32), n,
    )


def bound_ms(byts: float, instr: float, clock_hz: float):
    """Least time for the work: bytes over the memory rate, FP32
    instructions over 132 SMs × 128 lanes × clock; the larger wins."""
    t_b = byts / PEAK_BYTES_S * 1e3
    t_o = instr / (SMS * LANES * clock_hz) * 1e3
    return (t_b, "bytes") if t_b >= t_o else (t_o, "operations")


def report(key: str, rec: dict):
    lib = "" if rec["library_ms"] is None else f", library {rec['library_ms']:.4g} ms"
    print(f"{key} times: kernel {rec['ms']:.4g} ms, plain {rec['plain_ms']:.4g} ms{lib}, "
          f"bound {rec['bound_ms']:.4g} ms ({rec['bound_by']}) at {rec['shape']}", flush=True)


def kernel_checks(chk, dev, src, tgt, clock_hz, se3_pop):
    """Phase 3.  Returns the per-kernel records (without launch counts)."""
    import torch

    from goicp_tpu_torch.geo.rotation import axis_angle_rotation
    from goicp_tpu_torch.nn import fused
    from goicp_tpu_torch.nn.brute import nearest_neighbor

    rng = np.random.default_rng(7)
    S = torch.as_tensor(src, device=dev)
    T = torch.as_tensor(tgt, device=dev)
    N, NT = S.shape[0], T.shape[0]
    rec = {}

    # -- K1 at the multistart refine shape: icp_cap (64) poses x N queries
    R64 = axis_angle_rotation(torch.as_tensor(
        rng.uniform(-0.2, 0.2, (64, 3)).astype(np.float32), device=dev))
    Q = (S[None] @ R64.transpose(1, 2)).reshape(-1, 3).contiguous()
    for name, q, t in (
        ("random 300x700", torch.rand(300, 3, device=dev) - 0.5, torch.rand(700, 3, device=dev) - 0.5),
        (f"bunny {Q.shape[0]}x{NT}", Q, T),
    ):
        d2, idx = fused.nearest_neighbor_mxu(q, t)
        torch.cuda.synchronize()
        d2_p, idx_p = nearest_neighbor(q, t)
        err = float((d2 - d2_p).abs().max())
        chk.expect(bool(torch.equal(idx, idx_p)) and err == 0.0,
                   f"K1 {name}: indices equal, max |d2 err| {err:.3g} (tol 0: same rounding)")
    ms = timed_ms(lambda: fused.nearest_neighbor_mxu(Q, T), 20)
    plain = timed_ms(lambda: nearest_neighbor(Q, T), 5)
    lib = timed_ms(lambda: torch.cdist(Q, T).min(dim=1), 20)
    pairs = Q.shape[0] * NT
    b, by = bound_ms(4.0 * (3 * Q.shape[0] + 3 * NT + 2 * Q.shape[0]), 7.0 * pairs, clock_hz)
    rec["K1"] = dict(name="K1 nearest_neighbor_mxu (exact NN + argmin)", route="cuda",
                     source="goicp_tpu_torch/csrc/nn_min_d2.cu",
                     replaces="goicp_tpu/nn/mxu.py:152", max_abs_err=err, ms=ms,
                     plain_ms=plain, bound_ms=b, bound_by=by, library_ms=lib,
                     library_call="torch.cdist + min (two calls)",
                     shape=f"{Q.shape[0]} queries x {NT} targets")
    report("K1", rec["K1"])

    # -- K3 at the T-round shape: se3_pop groups of 8 siblings
    G = se3_pop
    Rg = axis_angle_rotation(torch.as_tensor(
        rng.uniform(-np.pi, np.pi, (G, 3)).astype(np.float32), device=dev))
    t8 = torch.as_tensor(rng.uniform(-0.3, 0.3, (G, 8, 3)).astype(np.float32), device=dev)
    srcT, wm = fused.pack_sources(S), fused.pack_targets(T)
    gp = fused.pack_group_params(Rg, t8)
    err = 0.0
    for name, args in (
        ("random 5 groups 300x700", (fused.pack_sources(torch.rand(300, 3, device=dev) - 0.5),
                                     fused.pack_targets(torch.rand(700, 3, device=dev) - 0.5),
                                     gp[:5].contiguous())),
        (f"bunny {G} groups {N}x{NT}", (srcT, wm, gp)),
    ):
        got = fused.min_d2_groups(*args)
        torch.cuda.synchronize()
        ref = fused.min_d2_groups_plain(*args)
        err = float((got - ref).abs().max())
        chk.expect(err == 0.0, f"K3 {name}: max |d2 err| {err:.3g} (tol 0: same rounding)")
    ms = timed_ms(lambda: fused.min_d2_groups(srcT, wm, gp), 10)
    plain = timed_ms(lambda: fused.min_d2_groups_plain(srcT, wm, gp), 2)
    b, by = bound_ms(4.0 * (3 * N + 3 * NT + 48 * G + 8 * G * N), 22.0 * G * N * NT, clock_hz)
    rec["K3"] = dict(name="K3 min_d2_groups (8-sibling grouped distances)", route="cuda",
                     source="goicp_tpu_torch/csrc/min_d2_grouped.cu",
                     replaces="goicp_tpu/nn/mxu.py:265", max_abs_err=err, ms=ms,
                     plain_ms=plain, bound_ms=b, bound_by=by, library_ms=None,
                     shape=f"{G} groups x {N} points x {NT} targets")
    report("K3", rec["K3"])

    # -- K2 at the largest R-round bucket (8·se3_pop nodes)
    B = 8 * se3_pop
    centers = rng.uniform(-np.pi, np.pi, (B, 3)).astype(np.float32)
    Rb = axis_angle_rotation(torch.as_tensor(centers, device=dev))
    tb = torch.as_tensor(rng.uniform(-0.3, 0.3, (B, 3)).astype(np.float32), device=dev)
    span_r = np.pi / 2 ** rng.integers(3, 6, B)
    af = torch.as_tensor((2 * np.sin(np.minimum(np.sqrt(3) * span_r, np.pi) / 2)).astype(np.float32), device=dev)
    gt = torch.as_tensor((np.sqrt(3) * 0.5 / 2 ** rng.integers(2, 5, B)).astype(np.float32), device=dev)
    norms = torch.linalg.vector_norm(S, dim=1)
    srcX = fused.pack_sources_ext(S, norms)
    p_open = fused.pack_params_bounds(Rb, tb, af, gt, 0.0, 1e30)
    _, lb_open = fused.bounds_nodes_plain(srcX, wm, p_open)
    thresh = float(lb_open.median())
    p_scr = fused.pack_params_bounds(Rb, tb, af, gt, 0.0, thresh)
    tq = fused._pick_tile(srcX.shape[1], fused.TQB)
    k2 = {}
    for label, params, th in (("unscreened", p_open, 1e30), ("screened", p_scr, thresh)):
        worst = 0.0
        for name, args in (
            ("random 37 nodes 300x700", None),
            (f"bunny {B} nodes {N}x{NT}", (srcX, wm, params)),
        ):
            if args is None:
                s_r = torch.rand(300, 3, device=dev) - 0.5
                args = (fused.pack_sources_ext(s_r, torch.linalg.vector_norm(s_r, dim=1)),
                        fused.pack_targets(torch.rand(700, 3, device=dev) - 0.5),
                        params[:37].contiguous())
            ub, lb = fused.bounds_nodes(*args)
            torch.cuda.synchronize()
            ub_p, lb_p = fused.bounds_nodes_plain(*args)
            differ = (lb >= th) != (lb_p >= th)
            near = torch.abs(lb_p - th) <= 1e-5 * abs(th) + 1e-5
            same = ~differ
            rel = lambda a, r: float(((a - r).abs() - 1e-5 * r.abs()).max())  # noqa: E731
            err = max(float((ub[same] - ub_p[same]).abs().max()),
                      float((lb[same] - lb_p[same]).abs().max()))
            ok = (bool(torch.all(near[differ]))
                  and rel(ub[same], ub_p[same]) <= 1e-5 and rel(lb[same], lb_p[same]) <= 1e-5)
            worst = max(worst, err)
            chk.expect(ok, f"K2 {label} {name}: max |err| {err:.3g} (tol 1e-5 + 1e-5·|ref|), "
                           f"screened-set differences {int(differ.sum())} (all within tol of thresh)")
        ms = timed_ms(lambda: fused.bounds_nodes(srcX, wm, params), 10)
        plain = timed_ms(lambda: fused.bounds_nodes_plain(srcX, wm, params), 2)
        ub_blk, lb_blk = fused.bounds_block_sums_plain(srcX, wm, params)
        _, _, blocks = fused.screen_scan(ub_blk, lb_blk, params[:, 15])
        pts = torch.clamp(blocks * tq, max=N).sum().item()   # valid points the rule evaluates
        b, by = bound_ms(4.0 * (16 * B + 5 * N + 3 * NT + 2 * B), 7.0 * pts * NT, clock_hz)
        k2[label] = dict(ms=ms, plain_ms=plain, bound_ms=b, bound_by=by, max_abs_err=worst,
                         blocks_run=int(blocks.sum().item()), blocks_total=B * (srcX.shape[1] // tq))
    s = k2["screened"]
    rec["K2"] = dict(name="K2 bounds_nodes (screened fused bounds)", route="cuda",
                     source="goicp_tpu_torch/csrc/bounds.cu",
                     replaces="goicp_tpu/nn/mxu.py:479",
                     max_abs_err=max(k2["screened"]["max_abs_err"], k2["unscreened"]["max_abs_err"]),
                     ms=s["ms"], plain_ms=s["plain_ms"], bound_ms=s["bound_ms"],
                     bound_by=s["bound_by"], library_ms=None,
                     shape=f"{B} nodes x {N} points x {NT} targets, thresh = median lb "
                           f"({s['blocks_run']} of {s['blocks_total']} blocks run)",
                     unscreened=k2["unscreened"])
    report("K2 screened", rec["K2"])
    report("K2 unscreened", dict(k2["unscreened"], library_ms=None,
                                 shape=f"{B} nodes x {N} points x {NT} targets"))
    return rec


def solve_params(dev, src, tgt, R_gt, t_gt):
    """The solve's parameters: ``mse_threshold`` below the mse at the true
    pose, so the multistart ICP alone cannot end the solve."""
    import torch

    from goicp_tpu_torch import BnbParams
    from goicp_tpu_torch.nn.brute import nearest_neighbor

    S, T = torch.as_tensor(src, device=dev), torch.as_tensor(tgt, device=dev)
    d2, _ = nearest_neighbor(S @ torch.as_tensor(R_gt, device=dev).T
                             + torch.as_tensor(t_gt, device=dev), T)
    mse_true = float(d2.mean())
    return BnbParams(mse_threshold=MSE_FACTOR * mse_true, max_wall_s=SOLVE_WALL_S), mse_true


def solve_bunny(chk, dev, src, tgt, R_gt, t_gt):
    """Phase 4: the certified solve through the public entry point."""
    import torch

    from goicp_tpu_torch import register
    from goicp_tpu_torch.nn import fused

    params, mse_true = solve_params(dev, src, tgt, R_gt, t_gt)
    print(f"solve: {src.shape[0]} source / {tgt.shape[0]} target points, mse at the "
          f"true pose {mse_true:.6g}, mse_threshold {params.mse_threshold:.6g}", flush=True)
    torch.cuda.synchronize()
    fused.reset_launch_counts()
    t0 = time.perf_counter()
    res = register(src, tgt, params, device=dev)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(fused.launches)
    R, t = np.asarray(res.transform.R), np.asarray(res.transform.t)
    cos = np.clip((np.trace(R.T @ R_gt) - 1.0) / 2.0, -1.0, 1.0)
    rot_err = float(np.degrees(np.arccos(cos)))
    extent = float(np.linalg.norm(tgt.max(0) - tgt.min(0)))
    t_err = float(np.linalg.norm(t - t_gt))
    timers = dict(res.metrics.timers)
    info = dict(
        rounds=res.rounds, nodes=res.rot_nodes, nodes_per_s=res.rot_nodes / max(timers.get("bnb", 0.0), 1e-9),
        converged=bool(res.converged), gap=res.gap, sse=res.sse, mse=res.mse,
        mse_true=mse_true, mse_threshold=params.mse_threshold, wall_s=wall,
        rot_err_deg=rot_err, t_err=t_err, t_err_over_extent=t_err / extent,
        icp_iters=res.icp_iters, launches=launches, timers=timers,
        counters={k: float(v) for k, v in res.metrics.counters.items()},
    )
    print("solve: " + json.dumps({k: info[k] for k in (
        "rounds", "nodes", "nodes_per_s", "converged", "gap", "mse", "wall_s",
        "rot_err_deg", "t_err", "t_err_over_extent", "launches")}), flush=True)
    for k, v in launches.items():
        chk.expect(v > 0, f"solve launched {k} {v} times")
    chk.expect(res.rot_nodes > 0, f"solve evaluated {res.rot_nodes} nodes")
    chk.expect(rot_err < 0.5 and t_err < 0.01 * extent,
               f"pose: rotation error {rot_err:.4f} deg (< 0.5), translation error "
               f"{t_err:.3g} = {100 * t_err / extent:.3f}% of the extent (< 1%)")
    chk.expect(bool(np.isfinite(res.sse)) and R.shape == (3, 3), "result finite, R 3x3")
    return info


def small_agreement(chk, dev):
    """Phase 5: the 100-point parity protocol of tests/test_torch_bnb.py on
    the card and on the CPU path."""
    from goicp_tpu_torch import BnbParams, register
    from goicp_tpu_torch.geo.rotation import random_rotations

    rng = np.random.default_rng(11)
    src = rng.uniform(-0.3, 0.3, (100, 3)).astype(np.float32)
    R = random_rotations(1, np.random.default_rng(5))[0]
    tgt = (src @ R.T + np.float32([0.05, -0.02, 0.03])
           + rng.normal(0, 0.01, (100, 3))).astype(np.float32)
    p = BnbParams(mse_threshold=1e-4, se3_pop=64, init_multistart=8,
                  refine_top_k=2, max_rounds=30)
    rg = register(src, tgt, p, device=dev)
    rc = register(src, tgt, p, device="cpu")
    dR = float(np.abs(rg.transform.R - rc.transform.R).max())
    ok = dR < 1e-4 and abs(rg.sse - rc.sse) <= 1e-5 * abs(rc.sse) and rg.rounds == rc.rounds
    chk.expect(ok, f"small solve card vs CPU: |dR| {dR:.3g}, sse {rg.sse:.7g} vs {rc.sse:.7g}, "
                   f"nodes {rg.rot_nodes} vs {rc.rot_nodes}")
    return dict(nodes_gpu=rg.rot_nodes, nodes_cpu=rc.rot_nodes, dR=dR,
                sse_gpu=rg.sse, sse_cpu=rc.sse)


def profile_solve(chk, dev, src, tgt, R_gt, t_gt):
    """``--profile``: the bunny solve once more under ``torch.profiler``,
    tracing device activity only (no host-op recording, so the host runs
    almost as fast as untraced).  Reports the device's busy share of the
    solve's wall (union of kernel and copy intervals) and device time by
    kernel; the table goes to ``chiprun_out/chip_smoke_profile.json``."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from goicp_tpu_torch import register

    params, _ = solve_params(dev, src, tgt, R_gt, t_gt)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        res = register(src, tgt, params, device=dev)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    spans = sorted((e.time_range.start, e.time_range.end, e.name)
                   for e in prof.events() if e.device_type == DeviceType.CUDA)
    busy_us, end = 0.0, -1.0
    by_name = {}
    for s, e, name in spans:
        busy_us += max(0.0, e - max(s, end))
        end = max(end, e)
        n, us = by_name.get(name, (0, 0.0))
        by_name[name] = (n + 1, us + (e - s))
    top = sorted(by_name.items(), key=lambda kv: -kv[1][1])
    info = dict(wall_s=wall, rounds=res.rounds, nodes=res.rot_nodes,
                device_events=len(spans), device_busy_s=busy_us * 1e-6,
                device_busy_share=busy_us * 1e-6 / wall,
                by_kernel=[dict(name=k[:120], launches=n, device_s=us * 1e-6)
                           for k, (n, us) in top])
    print("profile: " + json.dumps({k: info[k] for k in (
        "wall_s", "rounds", "nodes", "device_events", "device_busy_s",
        "device_busy_share")}), flush=True)
    for row in info["by_kernel"][:12]:
        print(f"profile:   {row['device_s']:9.4f} s  {row['launches']:7d}x  {row['name']}",
              flush=True)
    chk.expect(len(spans) > 0, f"profile traced {len(spans)} device events")
    return info


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    if not os.path.isdir(os.path.join(HERE, "goicp_tpu_torch")):
        print("chip_smoke: run from the repository root", file=sys.stderr)
        return 2
    sys.path.insert(0, HERE)
    import goicp_tpu_torch  # noqa: F401  (sets the f32 precision policy)
    from goicp_tpu_torch.nn import kernels

    chk = Checks()
    t_start = time.perf_counter()
    kind = torch.cuda.get_device_name(0)
    card = smi("name,power.limit")
    clock_mhz = float(smi("clocks.max.sm").split()[0])
    print(f"device: {kind}, torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"max SM clock {clock_mhz:.0f} MHz", flush=True)
    print(card, flush=True)

    t0 = time.perf_counter()
    kernels.lib()
    print(f"build: {time.perf_counter() - t0:.1f} s for {len(kernels.sources())} sources", flush=True)

    src, tgt, R_gt, t_gt, n_full = load_bunny()
    se3_pop = max(64, min(4096, int(32e6 / (8 * src.shape[0]))))   # bnb/se3.py auto
    dev = torch.device("cuda")
    recs = kernel_checks(chk, dev, src, tgt, clock_mhz * 1e6, se3_pop)
    solve = solve_bunny(chk, dev, src, tgt, R_gt, t_gt)
    small = small_agreement(chk, dev)
    prof = profile_solve(chk, dev, src, tgt, R_gt, t_gt) if "--profile" in sys.argv[1:] else None

    kernels_line = []
    for key, launch_name in (("K1", "nearest_neighbor_mxu"), ("K2", "bounds_nodes"),
                             ("K3", "min_d2_groups")):
        r = dict(recs[key])
        r["launches"] = solve["launches"][launch_name]
        r["check"] = "fail" if any(f.startswith(key) for f in chk.failed) else "pass"
        kernels_line.append(r)
    os.makedirs(OUT_DIR, exist_ok=True)
    with open(os.path.join(OUT_DIR, "chip_smoke.json"), "w") as f:
        json.dump(dict(card=card, kind=kind, clock_mhz=clock_mhz, kernels=kernels_line,
                       solve=solve, small=small, failed=chk.failed,
                       total_s=time.perf_counter() - t_start), f, indent=1)
    if prof is not None:
        with open(os.path.join(OUT_DIR, "chip_smoke_profile.json"), "w") as f:
            json.dump(dict(card=card, **prof), f, indent=1)
    print(f"total: {time.perf_counter() - t_start:.1f} s", flush=True)
    if chk.failed:
        print("chip_smoke: FAILED: " + "; ".join(chk.failed), file=sys.stderr)
        return 1
    print(json.dumps({"kernels": kernels_line}), flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
