#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port (``goicp_tpu_torch``) on one GPU.

Run from the repository root with no arguments::

    python3 chip_smoke.py

Phases, each of which fails the run:

1. the device, and ``nvidia-smi``'s name and power limit;
2. building the CUDA kernels from ``goicp_tpu_torch/csrc`` (timed);
3. each kernel against its plain PyTorch version on the card, on random
   inputs and at the bunny solves' shapes, with kernel, plain, bound and
   (K1, K3, K4) library times: K1 nearest neighbour at each of its shapes
   on the solve's path (in-round refine, coarse and full multistart; device
   time per call, and on a doubled target cloud whose ties the earlier twin
   must win); K3 grouped distances; K2 screened bounds and K4 per-node
   distances at the largest R-round bucket (K4 also on its ring route, above
   6,144 targets); K5 screened trimmed bounds there too (and on its route
   above 6,144 targets); K6 screened trimmed grouped bounds at se3_pop
   groups and at 263 groups of Np = 4,096; K7 screened grouped bounds (no
   solver path calls K7);
4. a certified solve of the in-repo bunny pair through ``register`` (K1,
   K2, K3 must launch), with the pose error against the ground truth;
4b. a trimmed (trim 0.25) certified solve of a partial-overlap bunny pair
   (the target lacks the 20 % of points of largest x): K1, K4, K3 must
   launch, and the pose must be within the same limits; then the same solve
   with ``bound_backend="screen"`` on a 30 s budget: K1, K5, K6 must
   launch;
5. the same small solve on the card and on the CPU path, which must agree;
5b. three small solves of 300-point subsets of the partial-overlap pair on
   the card and on the CPU path: trimmed (K4), trimmed with
   ``bound_backend="screen"`` (K5 and K6 must launch), untrimmed with
   ``screen=False`` (K4);
6. with ``--profile`` only: the bunny solve, the trimmed solve and the
   trimmed solve on ``bound_backend="screen"`` (each trimmed one with a 30 s
   budget) once more under ``torch.profiler`` (device activity), for the
   device's busy share of each solve, its device time by kernel and the
   launches of K5 and K6.

Each solve's launch counts are reset just before it and read just after;
K1's are also counted by (queries, targets), and the ``kernels`` line has a
K1 row per shape with that shape's launches in the certified solve.
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
TRIM = 0.25                     # trim_fraction of the partial-overlap solves
SCREEN_WALL_S = 30.0            # BnB budget of the trimmed solve on the screen backend
PROFILE_TRIM_WALL_S = 30.0      # BnB budget of the traced trimmed solve (--profile)


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


def device_ms(fn, reps: int, clock_hz: float) -> float:
    """Device time per call of ``fn()`` in ms, for calls too short to time
    one by one: a ``torch.cuda._sleep`` holds the stream while the host
    queues up to ``reps`` calls between two events, so the host's launch
    cost stays out of the number (the gaps between the queued kernels stay
    in).  Until the queueing ends inside the sleep, the sleep doubles and
    the calls halve (a stream queues about a thousand launches at most)."""
    import torch

    fn()
    sleep_s = 2e-3
    for _ in range(10):
        torch.cuda.synchronize()
        torch.cuda._sleep(int(sleep_s * clock_hz))
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        t0 = time.perf_counter()
        a.record()
        for _ in range(reps):
            fn()
        b.record()
        queued = time.perf_counter() - t0
        b.synchronize()
        if queued < sleep_s:
            return a.elapsed_time(b) / reps
        sleep_s, reps = 2 * sleep_s, max(1, reps // 2)
    raise RuntimeError("device_ms: the host could not queue the calls ahead of the card")


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


def library_min_ms(Q, T, chunk: int = 1 << 19) -> float:
    """One PyTorch call pair computing min over targets of |q − m|:
    ``torch.cdist`` + ``amin`` over the queries ``Q [n, 3]``, in chunks of
    ``chunk`` queries (a 2^19 x 1,797 distance block is 3.8 GB), timed as
    one run over all chunks."""
    import torch

    chunks = [Q[i:i + chunk] for i in range(0, Q.shape[0], chunk)]
    return timed_ms(lambda: [torch.cdist(c, T).amin(1) for c in chunks], 3)


def _rec(name, source, replaces, err, ms, plain, b, by, lib, shape, **extra):
    return dict(name=name, route="cuda", source=source, replaces=replaces,
                max_abs_err=err, ms=ms, plain_ms=plain, bound_ms=b, bound_by=by,
                library_ms=lib, shape=shape, **extra)


def k1_shapes(N: int, NT: int):
    """K1's shapes on the solve's path: (key, poses, source points, target
    points).  The in-round refine runs refine_top_k = 8 poses on the whole
    source; the multistart first runs its 64 seeds on init_coarse_n = 512
    points of each cloud, then pads its best seeds to icp_cap = 64 poses on
    the whole clouds."""
    return (("K1 refine", 8, N, NT), ("K1 coarse", 64, 512, 512), ("K1 multistart", 64, N, NT))


def check_k1(chk, dev, S, T, rng, clock_hz):
    """K1 at each shape of ``k1_shapes``, on random inputs and on the
    shape's targets twice over (every nearest target has a twin, and the
    earlier must win); tol 0.  Returns one record per shape."""
    import torch

    from goicp_tpu_torch.geo.rotation import axis_angle_rotation
    from goicp_tpu_torch.nn import fused
    from goicp_tpu_torch.nn.brute import nearest_neighbor

    def agree(name, q, t, d2, idx):
        torch.cuda.synchronize()
        d2_p, idx_p = nearest_neighbor(q, t)
        err = float((d2 - d2_p).abs().max())
        won = bool(torch.equal(d2, fused._sq3(q - t.index_select(0, idx))))
        chk.expect(bool(torch.equal(idx, idx_p)) and bool(torch.equal(d2, d2_p)) and won,
                   f"K1 {name}: indices equal, max |d2 err| {err:.3g}, d2 = |q - m_idx|^2 "
                   f"{won} (tol 0: same rounding, bit-equal)")
        return err

    q_r, t_r = torch.rand(300, 3, device=dev) - 0.5, torch.rand(700, 3, device=dev) - 0.5
    agree("random 300x700", q_r, t_r, *fused.nearest_neighbor_mxu(q_r, t_r))
    recs = {}
    for key, poses, n, nt in k1_shapes(S.shape[0], T.shape[0]):
        Sx = S[torch.as_tensor(np.sort(rng.choice(S.shape[0], n, replace=False)), device=dev)]
        Tx = T[torch.as_tensor(np.sort(rng.choice(T.shape[0], nt, replace=False)), device=dev)]
        Rp = axis_angle_rotation(torch.as_tensor(
            rng.uniform(-0.2, 0.2, (poses, 3)).astype(np.float32), device=dev))
        tp = torch.as_tensor(rng.uniform(-0.02, 0.02, (poses, 3)).astype(np.float32), device=dev)
        Q = (Sx[None] @ Rp.transpose(1, 2) + tp[:, None]).reshape(-1, 3).contiguous()
        t4 = fused.pack_nn_targets(Tx)
        name = f"{key[3:]} {poses}x{n} queries x {nt} targets"
        err = agree(name, Q, Tx, *fused.nearest_neighbor_mxu(Q, Tx, packed=t4))
        T2 = torch.cat([Tx, Tx])
        d2, idx = fused.nearest_neighbor_mxu(Q, T2)
        agree(f"{key[3:]} against the doubled targets", Q, T2, d2, idx)
        chk.expect(bool((idx < nt).all()), f"K1 {key[3:]}: the earlier twin wins every tie")
        route = fused.nn_route(Q.shape[0], t4.shape[0], fused._sm_count(Q.device.index))
        ms = device_ms(lambda: fused.nearest_neighbor_mxu(Q, Tx, packed=t4), 100, clock_hz)
        call = timed_ms(lambda: fused.nearest_neighbor_mxu(Q, Tx, packed=t4), 20)
        plain = device_ms(lambda: nearest_neighbor(Q, Tx), 5, clock_hz)
        lib = device_ms(lambda: torch.cdist(Q, Tx).min(dim=1), 20, clock_hz)
        nq = Q.shape[0]
        b, by = bound_ms(4.0 * (3 * nq + 3 * nt + 2 * nq), 7.0 * nq * nt, clock_hz)
        recs[key] = _rec(
            f"{key} nearest_neighbor_mxu (exact NN + argmin), {poses} x {n} queries x {nt} targets",
            "goicp_tpu_torch/csrc/nn_min_d2.cu", "goicp_tpu/nn/mxu.py:152", err, ms, plain, b, by,
            lib, f"{nq} queries x {nt} targets", library_call="torch.cdist + min (two calls)",
            shape_key=[nq, nt], launch_route=dict(splits=route[0], queries_per_thread=route[1]),
            call_ms=call, timing="device time per call (device_ms), targets packed once")
        report(key, recs[key])
    return recs


def check_k3(chk, dev, S, T, rng, clock_hz, G):
    """K3 at the T-round shape: se3_pop groups of 8 siblings."""
    import torch

    from goicp_tpu_torch.geo.rotation import axis_angle_rotation
    from goicp_tpu_torch.nn import fused

    N, NT = S.shape[0], T.shape[0]
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
    Q = ((S @ Rg.transpose(1, 2))[:, None] + t8[:, :, None]).reshape(-1, 3)   # [8G·N, 3]
    lib = library_min_ms(Q, T)
    del Q
    b, by = bound_ms(4.0 * (3 * N + 3 * NT + 48 * G + 8 * G * N), 22.0 * G * N * NT, clock_hz)
    return _rec("K3 min_d2_groups (8-sibling grouped distances)",
                "goicp_tpu_torch/csrc/min_d2_grouped.cu", "goicp_tpu/nn/mxu.py:265",
                err, ms, plain, b, by, lib, f"{G} groups x 8 x {N} points x {NT} targets",
                library_call=f"torch.cdist + amin over the {8 * G * N} transformed queries, "
                             "in chunks of 2^19")


def node_batch(rng, B, dev):
    """B random nodes at the R-round shape: poses, rotation deflation af
    for cube spans π/8..π/32 and translation radii γt."""
    import torch

    from goicp_tpu_torch.geo.rotation import axis_angle_rotation

    Rb = axis_angle_rotation(torch.as_tensor(
        rng.uniform(-np.pi, np.pi, (B, 3)).astype(np.float32), device=dev))
    tb = torch.as_tensor(rng.uniform(-0.3, 0.3, (B, 3)).astype(np.float32), device=dev)
    span_r = np.pi / 2 ** rng.integers(3, 6, B)
    af = torch.as_tensor((2 * np.sin(np.minimum(np.sqrt(3) * span_r, np.pi) / 2)).astype(np.float32), device=dev)
    gt = torch.as_tensor((np.sqrt(3) * 0.5 / 2 ** rng.integers(2, 5, B)).astype(np.float32), device=dev)
    return Rb, tb, af, gt


def check_k2(chk, dev, S, T, rng, clock_hz, B):
    """K2 at the largest R-round bucket (8·se3_pop nodes)."""
    import torch

    from goicp_tpu_torch.nn import fused
    from goicp_tpu_torch.nn.agree import screened_agree

    N, NT = S.shape[0], T.shape[0]
    Rb, tb, af, gt = node_batch(rng, B, dev)
    srcX = fused.pack_sources_ext(S, torch.linalg.vector_norm(S, dim=1))
    wm = fused.pack_targets(T)
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
            ok, err, _, differ = screened_agree(ub, lb, *fused.bounds_nodes_plain(*args), th, th)
            worst = max(worst, err)
            chk.expect(ok, f"K2 {label} {name}: max |err| {err:.3g} (tol 1e-5 + 1e-5·|ref|), "
                           f"screened-set differences {differ} (all within tol of thresh)")
        ms = timed_ms(lambda: fused.bounds_nodes(srcX, wm, params), 10)
        plain = timed_ms(lambda: fused.bounds_nodes_plain(srcX, wm, params), 2)
        ub_blk, lb_blk = fused.bounds_block_sums_plain(srcX, wm, params)
        _, _, blocks = fused.screen_scan(ub_blk, lb_blk, params[:, 15])
        pts = torch.clamp(blocks * tq, max=N).sum().item()   # valid points the rule evaluates
        b, by = bound_ms(4.0 * (16 * B + 5 * N + 3 * NT + 2 * B), 7.0 * pts * NT, clock_hz)
        k2[label] = dict(ms=ms, plain_ms=plain, bound_ms=b, bound_by=by, max_abs_err=worst,
                         blocks_run=int(blocks.sum().item()), blocks_total=B * (srcX.shape[1] // tq))
    s = k2["screened"]
    rec = _rec("K2 bounds_nodes (screened fused bounds)", "goicp_tpu_torch/csrc/bounds.cu",
               "goicp_tpu/nn/mxu.py:479",
               max(s["max_abs_err"], k2["unscreened"]["max_abs_err"]), s["ms"], s["plain_ms"],
               s["bound_ms"], s["bound_by"], None,
               f"{B} nodes x {N} points x {NT} targets, thresh = median lb "
               f"({s['blocks_run']} of {s['blocks_total']} blocks run)",
               library_none="no PyTorch call computes a screened, deflated sum",
               unscreened=k2["unscreened"])
    report("K2 screened", rec)
    report("K2 unscreened", dict(k2["unscreened"], library_ms=None,
                                 shape=f"{B} nodes x {N} points x {NT} targets"))
    return rec


def check_k4(chk, dev, S, T, rng, clock_hz, B):
    """K4 at the largest R-round bucket: per-node distances, tol 0."""
    import torch

    from goicp_tpu_torch.nn import fused

    N, NT = S.shape[0], T.shape[0]
    Rb, tb, _, _ = node_batch(rng, B, dev)
    srcT, wm = fused.pack_sources(S), fused.pack_targets(T)
    params = fused.pack_params(Rb, tb)
    err = 0.0
    for name, args in (
        ("random 37 nodes 300x700", (fused.pack_sources(torch.rand(300, 3, device=dev) - 0.5),
                                     fused.pack_targets(torch.rand(700, 3, device=dev) - 0.5),
                                     params[:37].contiguous())),
        (f"bunny {B} nodes {N}x{NT}", (srcT, wm, params)),
    ):
        got = fused.min_d2_nodes(*args)
        torch.cuda.synchronize()
        ref = fused.min_d2_nodes_plain(*args)
        err = float((got - ref).abs().max())
        chk.expect(bool(torch.equal(got, ref)),
                   f"K4 {name}: max |d2 err| {err:.3g} (tol 0: same rounding, bit-equal)")
    ms = timed_ms(lambda: fused.min_d2_nodes(srcT, wm, params), 10)
    plain = timed_ms(lambda: fused.min_d2_nodes_plain(srcT, wm, params), 2)
    Q = (S @ Rb.transpose(1, 2) + tb[:, None]).reshape(-1, 3)            # [B·N, 3]
    lib = library_min_ms(Q, T)
    del Q
    b, by = bound_ms(4.0 * (16 * B + 3 * N + 3 * NT + B * srcT.shape[1]), 7.0 * B * N * NT, clock_hz)
    # the ring route: 20,000 targets do not stay resident in shared memory
    Bg, NTg = 64, 20000
    wm_g = fused.pack_targets(torch.rand(NTg, 3, device=dev) * 2.0 - 1.0)
    p_g = params[:Bg].contiguous()
    got = fused.min_d2_nodes(srcT, wm_g, p_g)
    torch.cuda.synchronize()
    ref = fused.min_d2_nodes_plain(srcT, wm_g, p_g)
    chk.expect(bool(torch.equal(got, ref)),
               f"K4 ring route {Bg} nodes {N}x{NTg}: max |d2 err| "
               f"{float((got - ref).abs().max()):.3g} (tol 0: bit-equal)")
    bg, byg = bound_ms(4.0 * (16 * Bg + 3 * N + 3 * NTg + Bg * srcT.shape[1]),
                       7.0 * Bg * N * NTg, clock_hz)
    ring = dict(ms=timed_ms(lambda: fused.min_d2_nodes(srcT, wm_g, p_g), 5),
                plain_ms=timed_ms(lambda: fused.min_d2_nodes_plain(srcT, wm_g, p_g), 2),
                bound_ms=bg, bound_by=byg, shape=f"{Bg} nodes x {N} points x {NTg} targets")
    report("K4 ring route", dict(ring, library_ms=None))
    return _rec("K4 min_d2_nodes (per-node distances, no index)", "goicp_tpu_torch/csrc/nn_min_d2.cu",
                "goicp_tpu/nn/mxu.py:176 (via min_d2_nodes :361)", err, ms, plain, b, by, lib,
                f"{B} nodes x {N} points x {NT} targets",
                library_call=f"torch.cdist + amin over the {B * N} transformed queries, "
                             "in chunks of 2^19", ring_route=ring)


def bisect_ops(rows: int, Np: int) -> float:
    """The bisection's work per survivor: 24 passes and one final pass over
    ``rows`` x Np staged values, a compare and an add each."""
    return 2.0 * 25 * rows * Np


def check_k5(chk, dev, S, T, rng, clock_hz, B, h):
    """K5 at the largest R-round bucket with the trimmed protocol's h."""
    import torch

    from goicp_tpu_torch.nn import fused
    from goicp_tpu_torch.nn.agree import screened_agree, trim_levels

    N, NT = S.shape[0], T.shape[0]
    drop = N - h
    Rb, tb, af, gt = node_batch(rng, B, dev)
    srcX = fused.pack_sources_ext(S, torch.linalg.vector_norm(S, dim=1))
    wm = fused.pack_targets(T)
    Np = srcX.shape[1]
    tq = fused._pick_tile(Np, fused.TQB)
    p_open = fused.pack_params_bounds_trimmed(Rb, tb, af, gt, 0.0, 1e30, 1e30)
    _, lb_open = fused.bounds_nodes_trimmed_plain(srcX, wm, p_open, h=h, drop=drop)
    thresh, te, tau = trim_levels(lb_open, h, drop)
    p_scr = fused.pack_params_bounds_trimmed(Rb, tb, af, gt, 0.0, te, tau)
    out = {}
    for label, params, th, sc in (("unscreened", p_open, 1e30, 1e30), ("screened", p_scr, thresh, te)):
        worst = 0.0
        for name, args, hh, dd in (
            ("random 37 nodes 300x700", None, 225, 75),
            (f"bunny {B} nodes {N}x{NT}", (srcX, wm, params), h, drop),
        ):
            if args is None:
                s_r = torch.rand(300, 3, device=dev) - 0.5
                args = (fused.pack_sources_ext(s_r, torch.linalg.vector_norm(s_r, dim=1)),
                        fused.pack_targets(torch.rand(700, 3, device=dev) - 0.5),
                        params[:37].contiguous())
            ub, lb = fused.bounds_nodes_trimmed(*args, h=hh, drop=dd)
            torch.cuda.synchronize()
            ub_p, lb_p = fused.bounds_nodes_trimmed_plain(*args, h=hh, drop=dd)
            ok, err, nscr, differ = screened_agree(ub, lb, ub_p, lb_p, th, sc)
            worst = max(worst, err)
            chk.expect(ok, f"K5 {label} {name}: max |err| {err:.3g} (tol 1e-5 + 1e-5·|ref|), "
                           f"{nscr} screened, screened-set differences {differ} (all within tol)")
        ms = timed_ms(lambda: fused.bounds_nodes_trimmed(srcX, wm, params, h=h, drop=drop), 10)
        plain = timed_ms(lambda: fused.bounds_nodes_trimmed_plain(srcX, wm, params, h=h, drop=drop), 2)
        ub_p, _, blocks = fused.bounds_nodes_trimmed_plain(srcX, wm, params, h=h, drop=drop,
                                                           with_blocks=True)
        survivors = int((ub_p < 1e29).sum().item())
        pts = torch.clamp(blocks * tq, max=N).sum().item()
        b, by = bound_ms(4.0 * (24 * B + 5 * N + 3 * NT + 2 * B),
                         7.0 * pts * NT + survivors * bisect_ops(2, Np), clock_hz)
        out[label] = dict(ms=ms, plain_ms=plain, bound_ms=b, bound_by=by, max_abs_err=worst,
                          blocks_run=int(blocks.sum().item()), blocks_total=B * (Np // tq),
                          survivors=survivors)
    # the route above 6,144 targets: every warp reads them from global memory
    wm_g = fused.pack_targets(torch.rand(20000, 3, device=dev) * 2.0 - 1.0)
    p_g = p_open[:64].contiguous()
    ub, lb = fused.bounds_nodes_trimmed(srcX, wm_g, p_g, h=h, drop=drop)
    torch.cuda.synchronize()
    ok, err, _, _ = screened_agree(ub, lb, *fused.bounds_nodes_trimmed_plain(srcX, wm_g, p_g, h=h, drop=drop),
                                   1e30, 1e30)
    chk.expect(ok, f"K5 global-target route 64 nodes {N}x20000: max |err| {err:.3g} "
                   "(tol 1e-5 + 1e-5·|ref|)")
    s = out["screened"]
    rec = _rec("K5 bounds_nodes_trimmed (screened trimmed bounds)",
               "goicp_tpu_torch/csrc/bounds_trimmed.cu", "goicp_tpu/nn/mxu.py:738",
               max(s["max_abs_err"], out["unscreened"]["max_abs_err"]), s["ms"], s["plain_ms"],
               s["bound_ms"], s["bound_by"], None,
               f"{B} nodes x {N} points x {NT} targets, h {h}, thresh = half the median positive "
               f"lb ({s['blocks_run']} of {s['blocks_total']} blocks run, {s['survivors']} survivors)",
               library_none="no PyTorch call computes a screened, trimmed sum",
               unscreened=out["unscreened"], launch_plan=fused.k5_plan(B, Np, wm.shape[0]),
               global_target_route=dict(max_abs_err=err, plan=fused.k5_plan(64, Np, wm_g.shape[0])))
    report("K5 screened", rec)
    report("K5 unscreened", dict(out["unscreened"], library_ms=None,
                                 shape=f"{B} nodes x {N} points x {NT} targets"))
    return rec


def group_batch(rng, G, dev):
    """G random 8-sibling groups at the T-round shape."""
    import torch

    from goicp_tpu_torch.geo.rotation import axis_angle_rotation

    Rg = axis_angle_rotation(torch.as_tensor(
        rng.uniform(-np.pi, np.pi, (G, 3)).astype(np.float32), device=dev))
    t8 = torch.as_tensor(rng.uniform(-0.3, 0.3, (G, 8, 3)).astype(np.float32), device=dev)
    span_r = np.pi / 2 ** rng.integers(3, 6, G)
    af = torch.as_tensor((2 * np.sin(np.minimum(np.sqrt(3) * span_r, np.pi) / 2)).astype(np.float32), device=dev)
    gt8 = torch.as_tensor((np.sqrt(3) * 0.5 / 2 ** rng.integers(2, 5, (G, 8))).astype(np.float32), device=dev)
    return Rg, t8, af, gt8


def check_k6(chk, dev, S, T, rng, clock_hz, G, h, S_big):
    """K6 at se3_pop groups with the trimmed protocol's h, and at 263
    groups with a source of Np = 4,096 points."""
    import torch

    from goicp_tpu_torch.nn import fused
    from goicp_tpu_torch.nn.agree import screened_agree, trim_levels

    NT = T.shape[0]
    wm = fused.pack_targets(T)
    out = {}
    for route, src, g in (("se3_pop", S, G), ("Np 4096", S_big, 263)):
        N = src.shape[0]
        hh = h if route == "se3_pop" else int(round(0.75 * N))
        drop = N - hh
        srcX = fused.pack_sources_ext(src, torch.linalg.vector_norm(src, dim=1))
        Np = srcX.shape[1]
        tq = fused._pick_tile(Np, fused.TQB)
        Rg, t8, af, gt8 = group_batch(rng, g, dev)
        p_open = fused.pack_group_params_bounds_trimmed(Rg, t8, af, gt8, 0.0, 1e30, 1e30)
        _, lb_open = fused.bounds_groups_trimmed_plain(srcX, wm, p_open, h=hh, drop=drop)
        thresh, te, tau = trim_levels(lb_open, hh, drop)
        p_scr = fused.pack_group_params_bounds_trimmed(Rg, t8, af, gt8, 0.0, te, tau)
        for label, params, th, sc in (("unscreened", p_open, 1e30, 1e30),
                                      ("screened", p_scr, thresh, te)):
            ub, lb = fused.bounds_groups_trimmed(srcX, wm, params, h=hh, drop=drop)
            torch.cuda.synchronize()
            ub_p, lb_p, blocks = fused.bounds_groups_trimmed_plain(srcX, wm, params, h=hh, drop=drop,
                                                                   with_blocks=True)
            ok, err, nscr, differ = screened_agree(ub, lb, ub_p, lb_p, th, sc, group=8)
            chk.expect(ok, f"K6 {label} {g} groups {N}x{NT} ({route}): max |err| "
                           f"{err:.3g} (tol 1e-5 + 1e-5·|ref|), {nscr} groups screened, "
                           f"screened-set differences {differ} (all within tol)")
            ms = timed_ms(lambda: fused.bounds_groups_trimmed(srcX, wm, params, h=hh, drop=drop), 5)
            plain = timed_ms(lambda: fused.bounds_groups_trimmed_plain(srcX, wm, params, h=hh, drop=drop), 2)
            survivors = int((ub_p < 1e29).sum().item()) // 8
            pts = torch.clamp(blocks * tq, max=N).sum().item()
            b, by = bound_ms(4.0 * (64 * g + 5 * N + 3 * NT + 16 * g),
                             22.0 * pts * NT + survivors * bisect_ops(16, Np), clock_hz)
            out[f"{route} {label}"] = dict(
                ms=ms, plain_ms=plain, bound_ms=b, bound_by=by, max_abs_err=err,
                blocks_run=int(blocks.sum().item()), blocks_total=g * (Np // tq),
                survivors=survivors, shape=f"{g} groups x 8 x {N} points x {NT} targets, h {hh}",
                points_per_thread=fused.k6_qr(tq),
                ctas=min(g, fused._k6_ctas(dev.index or 0, tq, fused.k6_qr(tq))))
    s = out["se3_pop screened"]
    rec = _rec("K6 bounds_groups_trimmed (screened trimmed grouped bounds)",
               "goicp_tpu_torch/csrc/bounds_trimmed_grouped.cu", "goicp_tpu/nn/mxu.py:918",
               max(v["max_abs_err"] for v in out.values()), s["ms"], s["plain_ms"],
               s["bound_ms"], s["bound_by"], None,
               s["shape"] + f", thresh = half the median positive lb ({s['blocks_run']} of "
               f"{s['blocks_total']} blocks run, {s['survivors']} surviving groups)",
               library_none="no PyTorch call computes a screened, trimmed sum",
               variants={k: v for k, v in out.items() if k != "se3_pop screened"})
    for k, v in out.items():
        report(f"K6 {k}", dict(v, library_ms=None))
    return rec


def check_k7(chk, dev, S, T, rng, clock_hz, G):
    """K7 at se3_pop groups, unscreened and screened at the median of the
    groups' smallest lb."""
    import torch

    from goicp_tpu_torch.nn import fused
    from goicp_tpu_torch.nn.agree import screened_agree

    N, NT = S.shape[0], T.shape[0]
    srcX = fused.pack_sources_ext(S, torch.linalg.vector_norm(S, dim=1))
    wm = fused.pack_targets(T)
    Np = srcX.shape[1]
    tq = fused._pick_tile(Np, fused.TQB)
    Rg, t8, af, gt8 = group_batch(rng, G, dev)
    p_open = fused.pack_group_params_bounds(Rg, t8, af, gt8, 0.0, 1e30)
    _, lb_open = fused.bounds_groups_plain(srcX, wm, p_open)
    thresh = float(lb_open.reshape(G, 8).amin(1).median())
    p_scr = fused.pack_group_params_bounds(Rg, t8, af, gt8, 0.0, thresh)
    out = {}
    for label, params, th in (("unscreened", p_open, 1e30), ("screened", p_scr, thresh)):
        ub, lb = fused.bounds_groups(srcX, wm, params)
        torch.cuda.synchronize()
        ub_p, lb_p, blocks = fused.bounds_groups_plain(srcX, wm, params, with_blocks=True)
        ok, err, nscr, differ = screened_agree(ub, lb, ub_p, lb_p, th, th, group=8)
        chk.expect(ok, f"K7 {label} {G} groups {N}x{NT}: max |err| {err:.3g} (tol 1e-5 + "
                       f"1e-5·|ref|), {nscr} groups screened, screened-set differences {differ}")
        ms = timed_ms(lambda: fused.bounds_groups(srcX, wm, params), 5)
        plain = timed_ms(lambda: fused.bounds_groups_plain(srcX, wm, params), 2)
        pts = torch.clamp(blocks * tq, max=N).sum().item()
        b, by = bound_ms(4.0 * (64 * G + 5 * N + 3 * NT + 16 * G), 22.0 * pts * NT, clock_hz)
        out[label] = dict(ms=ms, plain_ms=plain, bound_ms=b, bound_by=by, max_abs_err=err,
                          blocks_run=int(blocks.sum().item()), blocks_total=G * (Np // tq))
    s = out["screened"]
    rec = _rec("K7 bounds_groups (screened grouped bounds)", "goicp_tpu_torch/csrc/bounds_grouped.cu",
               "goicp_tpu/nn/mxu.py:597",
               max(s["max_abs_err"], out["unscreened"]["max_abs_err"]), s["ms"], s["plain_ms"],
               s["bound_ms"], s["bound_by"], None,
               f"{G} groups x 8 x {N} points x {NT} targets, thresh = median smallest lb "
               f"({s['blocks_run']} of {s['blocks_total']} blocks run)",
               library_none="no PyTorch call computes a screened, deflated sum",
               unscreened=out["unscreened"])
    report("K7 screened", rec)
    report("K7 unscreened", dict(out["unscreened"], library_ms=None,
                                 shape=f"{G} groups x 8 x {N} points x {NT} targets"))
    return rec


def kernel_checks(chk, dev, src, tgt, clock_hz, se3_pop, h_trim, big_src):
    """Phase 3: every kernel against its plain version, with its times.
    Returns the per-kernel records (without launch counts)."""
    import torch

    from goicp_tpu_torch.nn import fused

    rng = np.random.default_rng(7)
    S = torch.as_tensor(src, device=dev)
    T = torch.as_tensor(tgt, device=dev)
    rec = check_k1(chk, dev, S, T, rng, clock_hz)
    rec["K3"] = check_k3(chk, dev, S, T, rng, clock_hz, se3_pop)
    report("K3", rec["K3"])
    rec["K2"] = check_k2(chk, dev, S, T, rng, clock_hz, 8 * se3_pop)
    rec["K4"] = check_k4(chk, dev, S, T, rng, clock_hz, 8 * se3_pop)
    report("K4", rec["K4"])
    rec["K5"] = check_k5(chk, dev, S, T, rng, clock_hz, 8 * se3_pop, h_trim)
    rec["K6"] = check_k6(chk, dev, S, T, rng, clock_hz, se3_pop, h_trim,
                         torch.as_tensor(big_src, device=dev))
    fused.reset_launch_counts()
    rec["K7"] = check_k7(chk, dev, S, T, rng, clock_hz, se3_pop)
    rec["K7"]["check_launches"] = fused.launches["bounds_groups"]
    return rec


def big_source(n: int = 4096):
    """``n`` points of rotated_bunny.ply (seed 4), scaled into [−1, 1]³: the
    source of K6's Np = 4,096 check."""
    from goicp_tpu_torch.io import read_ply

    big = read_ply(os.path.join(HERE, "data_generated", "rotated_bunny.ply"))
    big = big[np.sort(np.random.default_rng(4).choice(big.shape[0], n, replace=False))]
    return (big / np.abs(big).max()).astype(np.float32)


def load_bunny_partial():
    """The trimmed (partial-overlap) bunny pair: the target drops the 20 %
    of rotated_bunny.ply's points with the largest x before its seed-2
    subsample; the source is Rᵀ(full target − t), subsampled with seed 1,
    so about a fifth of it has no counterpart.  Both are scaled by one
    factor into [−1, 1]³."""
    from goicp_tpu_torch.io import read_ply

    tgt_full = read_ply(os.path.join(HERE, "data_generated", "rotated_bunny.ply"))
    with open(os.path.join(HERE, "data_generated", "rotated_bunny_gt.toml"), "rb") as f:
        gt = tomllib.load(f)
    R = np.asarray(gt["rotation"], np.float64)
    t = np.asarray(gt["translation"], np.float64)
    n = tgt_full.shape[0]
    src_full = (tgt_full.astype(np.float64) - t) @ R
    part = tgt_full[np.sort(np.argsort(tgt_full[:, 0], kind="stable")[: n - n // 5])]
    src = src_full[np.sort(np.random.default_rng(1).choice(n, N_SRC, replace=False))]
    tgt = part[np.sort(np.random.default_rng(2).choice(part.shape[0], N_TGT, replace=False))]
    scale = 1.0 / max(np.abs(src).max(), np.abs(tgt).max())
    return (
        (src * scale).astype(np.float32), (tgt * scale).astype(np.float32),
        R.astype(np.float32), (t * scale).astype(np.float32),
    )


def mse_at_truth(dev, src, tgt, R_gt, t_gt, trim: float = 0.0) -> float:
    """(Trimmed) mse of the source at the true pose: the mean of the
    h = round(N·(1 − trim)) smallest squared nearest distances."""
    import torch

    from goicp_tpu_torch.nn.brute import nearest_neighbor

    S, T = torch.as_tensor(src, device=dev), torch.as_tensor(tgt, device=dev)
    d2, _ = nearest_neighbor(S @ torch.as_tensor(R_gt, device=dev).T
                             + torch.as_tensor(t_gt, device=dev), T)
    h = max(1, int(round(src.shape[0] * (1.0 - trim))))
    return float(torch.sort(d2).values[:h].mean())


def solve_params(dev, src, tgt, R_gt, t_gt, trim: float = 0.0, **kw):
    """The solve's parameters: ``mse_threshold`` below the (trimmed) mse at
    the true pose, so the multistart ICP alone cannot end the solve."""
    from goicp_tpu_torch import BnbParams

    mse_true = mse_at_truth(dev, src, tgt, R_gt, t_gt, trim)
    p = dict(mse_threshold=MSE_FACTOR * mse_true, max_wall_s=SOLVE_WALL_S, trim_fraction=trim)
    return BnbParams(**{**p, **kw}), mse_true


def solve_bunny(chk, dev, label, src, tgt, R_gt, t_gt, expect, trim: float = 0.0, **kw):
    """Phases 4 and 4b: a certified solve through the public entry point,
    with the launch counts of exactly this solve; every kernel in
    ``expect`` must have launched.  ``kw`` overrides ``BnbParams``."""
    import torch

    from goicp_tpu_torch import register
    from goicp_tpu_torch.nn import fused

    params, mse_true = solve_params(dev, src, tgt, R_gt, t_gt, trim, **kw)
    print(f"{label}: {src.shape[0]} source / {tgt.shape[0]} target points, trim {trim}, "
          f"mse at the true pose {mse_true:.6g}, mse_threshold {params.mse_threshold:.6g}",
          flush=True)
    torch.cuda.synchronize()
    fused.reset_launch_counts()
    t0 = time.perf_counter()
    res = register(src, tgt, params, device=dev)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(fused.launches)
    k1_shape_launches = {f"{q}x{t}": n for (q, t), n in sorted(fused.nn_launch_shapes.items())}
    R, t = np.asarray(res.transform.R), np.asarray(res.transform.t)
    cos = np.clip((np.trace(R.T @ R_gt) - 1.0) / 2.0, -1.0, 1.0)
    rot_err = float(np.degrees(np.arccos(cos)))
    extent = float(np.linalg.norm(tgt.max(0) - tgt.min(0)))
    t_err = float(np.linalg.norm(t - t_gt))
    timers = dict(res.metrics.timers)
    info = dict(
        trim_fraction=trim, bound_backend=params.bound_backend, max_wall_s=params.max_wall_s,
        rounds=res.rounds, nodes=res.rot_nodes,
        nodes_per_s=res.rot_nodes / max(timers.get("bnb", 0.0), 1e-9),
        converged=bool(res.converged), gap=res.gap, sse=res.sse, mse=res.mse,
        mse_true=mse_true, mse_threshold=params.mse_threshold, wall_s=wall,
        rot_err_deg=rot_err, t_err=t_err, t_err_over_extent=t_err / extent,
        icp_iters=res.icp_iters, launches=launches, k1_launches_by_shape=k1_shape_launches,
        timers=timers,
        counters={k: float(v) for k, v in res.metrics.counters.items()},
    )
    print(f"{label}: " + json.dumps({k: info[k] for k in (
        "rounds", "nodes", "nodes_per_s", "converged", "gap", "mse", "wall_s",
        "rot_err_deg", "t_err", "t_err_over_extent", "launches", "k1_launches_by_shape")}),
          flush=True)
    for k in expect:
        chk.expect(launches[k] > 0, f"{label} launched {k} {launches[k]} times")
    chk.expect(res.rot_nodes > 0, f"{label} evaluated {res.rot_nodes} nodes")
    chk.expect(rot_err < 0.5 and t_err < 0.01 * extent,
               f"{label} pose: rotation error {rot_err:.4f} deg (< 0.5), translation error "
               f"{t_err:.3g} = {100 * t_err / extent:.3f}% of the extent (< 1%)")
    chk.expect(bool(np.isfinite(res.sse)) and R.shape == (3, 3), f"{label} result finite, R 3x3")
    return info


def card_vs_cpu(chk, dev, label, src, tgt, params, expect=()):
    """One small solve on the card and on the CPU path, which must agree on
    the pose (1e-4), the sse (rtol 1e-5) and the rounds; ``expect`` lists
    kernels that must have launched in the card's solve."""
    import torch

    from goicp_tpu_torch import register
    from goicp_tpu_torch.nn import fused

    torch.cuda.synchronize()
    fused.reset_launch_counts()
    rg = register(src, tgt, params, device=dev)
    torch.cuda.synchronize()
    launches = dict(fused.launches)
    rc = register(src, tgt, params, device="cpu")
    dR = float(np.abs(rg.transform.R - rc.transform.R).max())
    ok = dR < 1e-4 and abs(rg.sse - rc.sse) <= 1e-5 * abs(rc.sse) and rg.rounds == rc.rounds
    chk.expect(ok, f"{label} card vs CPU: |dR| {dR:.3g}, sse {rg.sse:.7g} vs {rc.sse:.7g}, "
                   f"rounds {rg.rounds} vs {rc.rounds}, nodes {rg.rot_nodes} vs {rc.rot_nodes}")
    for k in expect:
        chk.expect(launches[k] > 0, f"{label} launched {k} {launches[k]} times")
    return dict(nodes_gpu=rg.rot_nodes, nodes_cpu=rc.rot_nodes, rounds=rg.rounds, dR=dR,
                sse_gpu=rg.sse, sse_cpu=rc.sse, converged=bool(rg.converged), launches=launches)


def small_agreement(chk, dev):
    """Phase 5: the 100-point parity protocol of tests/test_torch_bnb.py on
    the card and on the CPU path."""
    from goicp_tpu_torch import BnbParams
    from goicp_tpu_torch.geo.rotation import random_rotations

    rng = np.random.default_rng(11)
    src = rng.uniform(-0.3, 0.3, (100, 3)).astype(np.float32)
    R = random_rotations(1, np.random.default_rng(5))[0]
    tgt = (src @ R.T + np.float32([0.05, -0.02, 0.03])
           + rng.normal(0, 0.01, (100, 3))).astype(np.float32)
    p = BnbParams(mse_threshold=1e-4, se3_pop=64, init_multistart=8,
                  refine_top_k=2, max_rounds=30)
    return card_vs_cpu(chk, dev, "small solve", src, tgt, p)


def small_trimmed_agreement(chk, dev, src, tgt, R_gt, t_gt):
    """Phase 5b: 300-point subsets of the trimmed pair, 30 rounds, on the
    card and on the CPU path: trimmed on the default backend (K4), trimmed
    with the screen opt-in (K5, K6), untrimmed with screen=False (K4)."""
    rng = np.random.default_rng(3)
    s = src[np.sort(rng.choice(src.shape[0], 300, replace=False))]
    t = tgt[np.sort(rng.choice(tgt.shape[0], 300, replace=False))]
    # 30 rounds and no wall budget: both devices run the same rounds
    kw = dict(se3_pop=64, init_multistart=8, refine_top_k=2, max_rounds=30, max_wall_s=1e9)
    out = {}
    for label, trim, extra, expect in (
        ("trimmed default", 0.25, {}, ("min_d2_nodes", "min_d2_groups")),
        ("trimmed screen", 0.25, dict(bound_backend="screen"),
         ("bounds_nodes_trimmed", "bounds_groups_trimmed")),
        ("untrimmed screen=False", 0.0, dict(screen=False), ("min_d2_nodes",)),
    ):
        params, _ = solve_params(dev, s, t, R_gt, t_gt, trim, **kw, **extra)
        out[label] = card_vs_cpu(chk, dev, f"small {label}", s, t, params, expect)
    return out


def profile_solve(chk, dev, label, src, tgt, R_gt, t_gt, trim: float = 0.0,
                  wall_s: float = SOLVE_WALL_S, **kw):
    """``--profile``: a solve once more under ``torch.profiler``, tracing
    device activity only (no host-op recording, so the host runs almost as
    fast as untraced), with a BnB budget of ``wall_s``.  Reports the
    device's busy share of the solve's wall (union of kernel and copy
    intervals) and device time by kernel; the tables go to
    ``chiprun_out/chip_smoke_profile.json``.  ``kw`` overrides
    ``BnbParams``."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from goicp_tpu_torch import register
    from goicp_tpu_torch.nn import fused

    params, _ = solve_params(dev, src, tgt, R_gt, t_gt, trim, max_wall_s=wall_s, **kw)
    torch.cuda.synchronize()
    fused.reset_launch_counts()
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
    info = dict(trim_fraction=trim, bound_backend=params.bound_backend, wall_s=wall,
                rounds=res.rounds, nodes=res.rot_nodes, launches=dict(fused.launches),
                device_events=len(spans), device_busy_s=busy_us * 1e-6,
                device_busy_share=busy_us * 1e-6 / wall,
                by_kernel=[dict(name=k[:120], launches=n, device_s=us * 1e-6)
                           for k, (n, us) in top])
    print(f"profile {label}: " + json.dumps({k: info[k] for k in (
        "wall_s", "rounds", "nodes", "device_events", "device_busy_s",
        "device_busy_share", "launches")}), flush=True)
    for row in info["by_kernel"][:12]:
        print(f"profile:   {row['device_s']:9.4f} s  {row['launches']:7d}x  {row['name']}",
              flush=True)
    chk.expect(len(spans) > 0, f"profile {label} traced {len(spans)} device events")
    return info


# (key, launch counter, the phase whose solve is the kernel's main path);
# K1 has a row per shape (k1_shapes) and counts that shape's launches
KERNELS = (
    ("K1 refine", "nearest_neighbor_mxu", "solve"),
    ("K1 coarse", "nearest_neighbor_mxu", "solve"),
    ("K1 multistart", "nearest_neighbor_mxu", "solve"),
    ("K2", "bounds_nodes", "solve"),
    ("K3", "min_d2_groups", "solve"),
    ("K4", "min_d2_nodes", "trimmed solve"),
    ("K5", "bounds_nodes_trimmed", "trimmed screen solve"),
    ("K6", "bounds_groups_trimmed", "trimmed screen solve"),
    ("K7", "bounds_groups", None),
)


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
    from goicp_tpu_torch.nn import fused, kernels

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
    psrc, ptgt, pR, pt = load_bunny_partial()
    se3_pop = max(64, min(4096, int(32e6 / (8 * src.shape[0]))))   # bnb/se3.py auto
    h_trim = int(round(N_SRC * (1.0 - TRIM)))
    big = big_source()
    dev = torch.device("cuda")
    recs = kernel_checks(chk, dev, src, tgt, clock_mhz * 1e6, se3_pop, h_trim, big)
    phases = {
        "solve": solve_bunny(chk, dev, "solve", src, tgt, R_gt, t_gt,
                             ("nearest_neighbor_mxu", "bounds_nodes", "min_d2_groups")),
        "trimmed solve": solve_bunny(chk, dev, "trimmed solve", psrc, ptgt, pR, pt,
                                     ("nearest_neighbor_mxu", "min_d2_nodes", "min_d2_groups"),
                                     trim=TRIM),
        "trimmed screen solve": solve_bunny(
            chk, dev, "trimmed screen solve", psrc, ptgt, pR, pt,
            ("nearest_neighbor_mxu", "bounds_nodes_trimmed", "bounds_groups_trimmed"),
            trim=TRIM, bound_backend="screen", max_wall_s=SCREEN_WALL_S),
    }
    small = small_agreement(chk, dev)
    small_trim = small_trimmed_agreement(chk, dev, psrc, ptgt, pR, pt)
    prof = None
    if "--profile" in sys.argv[1:]:
        prof = {"solve": profile_solve(chk, dev, "solve", src, tgt, R_gt, t_gt),
                "trimmed solve": profile_solve(chk, dev, "trimmed solve", psrc, ptgt, pR, pt,
                                               TRIM, PROFILE_TRIM_WALL_S),
                "trimmed screen solve": profile_solve(
                    chk, dev, "trimmed screen solve", psrc, ptgt, pR, pt, TRIM,
                    PROFILE_TRIM_WALL_S, bound_backend="screen")}

    kernels_line = []
    for key, counter, phase in KERNELS:
        r = dict(recs[key])
        shape = r.pop("shape_key", None)

        def count(info):
            if shape is None:
                return info["launches"][counter]
            return info["k1_launches_by_shape"].get(f"{shape[0]}x{shape[1]}", 0)

        if phase is None:
            r["launches"] = r.pop("check_launches")
            r["launches_from"] = ("the phase 3 check only: no solver path calls it "
                                  "(goicp_tpu/bnb/se3_eval.py:436)")
        else:
            r["launches"] = count(phases[phase])
            r["launches_from"] = phase if shape is None else f"{phase}, at this shape"
        r["launches_by_phase"] = {k: count(v) for k, v in phases.items()}
        prefix = key.split()[0] + " "
        r["check"] = "fail" if any(f.startswith(prefix) for f in chk.failed) else "pass"
        kernels_line.append(r)
    os.makedirs(OUT_DIR, exist_ok=True)
    with open(os.path.join(OUT_DIR, "chip_smoke.json"), "w") as f:
        json.dump(dict(card=card, kind=kind, clock_mhz=clock_mhz, kernels=kernels_line,
                       solve=phases["solve"], trimmed_solve=phases["trimmed solve"],
                       trimmed_screen_solve=phases["trimmed screen solve"],
                       small=small, small_trimmed=small_trim, failed=chk.failed,
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
