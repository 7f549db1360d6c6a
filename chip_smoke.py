#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port (``goicp_tpu_torch``) on one GPU.

Run from the repository root with no arguments::

    python3 chip_smoke.py

Phases, each of which fails the run:

1. the device, and ``nvidia-smi``'s name and power limit;
2. building the CUDA kernels from ``goicp_tpu_torch/csrc`` (timed);
3. each kernel against its plain PyTorch version on the card, on random
   inputs and at the bunny solves' shapes, with kernel, plain, bound and
   (K1, K3, K4) library times; K2 also against its plain version in the
   kernel's summation order (bit-equal), with its launch plan, screened and
   unscreened times and on its ring route (8,000 targets): K1 nearest neighbour at each of its shapes
   on the solve's path (in-round refine, coarse and full multistart) and at
   the CLI's modes 0/1 on the whole bunny (40,256 × 40,256, its ring route;
   device time per call, and on a doubled target cloud whose ties the
   earlier twin must win); K3 grouped distances; K2 screened bounds and K4 per-node
   distances at the largest R-round bucket (K4 also on its ring route, above
   6,144 targets); K5 screened trimmed bounds there too (and on its route
   above 6,144 targets); K6 screened trimmed grouped bounds at se3_pop
   groups and at 263 groups of Np = 4,096; K7 screened grouped bounds (no
   solver path calls K7); the kernel forms (``variant=``, on no solver
   path): K4 "exp" and "dot" at the largest R-round bucket and on the ring
   route (64 nodes x 20,000 targets), K1 "exp" and "dot" through
   ``min_d2_padded(want_idx=True)`` at the refine's 8 poses, and K3 "exp"
   at se3_pop groups, each bit-equal to its plain version, with the max
   |Δd²| (and K1's share of differing indices) against the diff form's
   kernel and the diff kernel's time beside its own;
3b. the in-round refine's ICP at its shape (8 poses × 1,518 points
   against 1,797 targets), each iteration one replay of a CUDA graph,
   against the eager loop on the same tensors: the headline pair untrimmed
   and the partial pair trimmed, all poses active and a third gated off;
   bit-equal R, t, sse and iterations, equal K1 launches, and each loop's
   host ms per iteration;
4. a certified solve of the in-repo bunny pair through ``register`` (K1,
   K2, K3 must launch), with the pose error against the ground truth and
   its rounds and nodes against the headline's 431 and 8,947,314;
4b. a trimmed (trim 0.25) certified solve of a partial-overlap bunny pair
   (the target lacks the 20 % of points of largest x): K1, K4, K3 must
   launch, and the pose must be within the same limits (60 s budget: it
   does not converge; rounds, nodes/s and gap are reported); then the same
   solve with ``bound_backend="screen"`` on a 30 s budget: K1, K5, K6 must
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
   launches of K5 and K6;
7. the CLI and the grid and plane paths, with inputs written under
   ``chiprun_out/cli/``: 7a ``goicp_tpu_torch.cli.main`` in mode 4 with the
   plane metric at the headline's 1,518 / 1,797 points (K1, K2, K3 must
   launch; normals on the card; the artifacts); 7b modes 1 and 2 on the
   whole 40,256-point bunny moved by 10° and 3 % of its extent, each on the
   point and the plane metric (mode 1 on K1 at 40,256 × 40,256, mode 2 on
   a 256³ EDT grid with no K1; the plane runs must recover the pose, mode 1
   to 1e-3 of the extent, mode 2 to one cell; the point runs, which stall
   short of it, must match the port's CPU path on the same TOMLs,
   ``CPU_WITNESS``); 7c a
   solve through ``register`` above ``mxu_max`` (grid bounds, grid ICP, no
   K2-K6); the times of the new plain-PyTorch stages (EDT build, normals,
   grid bounds of one round, one plane step); 7d the 300-point subsets of
   5b on the card and on the CPU path on the "grid", "exact" and plane
   paths;
8. full-cloud certification, checkpoints and the nested engine: 8a
   ``register_full_cert`` on the whole bunny source (40,256 points,
   Rᵀ(target − t)) against the headline's target, subsets 8,192 → 16,384 →
   32,768 → 40,256 on 20 s budgets (K1, K2, K3 must launch; the pose within
   the limits; ``gap_full`` reported, ``sse_full`` equal to the CPU path's
   score; the first grown subset equal on the card and the CPU path), with
   K1 at its coverage shape (40,256 queries x 32,768 of them), and K2, K3
   and K5 at the whole source's shape (792 nodes, 99 groups of 8) against
   their plain versions (rows of their own in the ``kernels`` line, with
   8a's launches at that shape); then a trimmed full cert (trim 0.25) on
   ``bound_backend="screen"``, 5 s a solve, subsets 20,128 → 40,256, whose
   K5 must run at the whole source; 8b the headline solve interrupted at 200
   rounds (snapshots every 25) and resumed to certification, at phase 4's
   pose, from the snapshot written at round 200 while rounds were queued
   and from the last one, written after the queue drained; 8c the headline pair on the nested engine, 30 s
   budget (K1 only); 8d card against CPU on 5b's 300-point subsets: full
   certs untrimmed and trimmed, a nested solve, and a snapshot written on
   the card resumed on both.

9. lockstep multipair and the registration service: K4 at one pair's
   lockstep round (4,096 nodes × the source's 1,536-point pack × 1,797
   targets) and K1 at the lockstep refine (4 pairs × 8 poses × 1,518
   queries × 1,797 targets) against their plain versions; 9a
   ``register_pairs`` on four rotated copies of the headline source
   against the one headline target, default ``BnbParams``, phase 4's
   ``mse_threshold``, 30 s budget (K4 and K1 must launch, K2 and K3 must
   not; each pair's rounds, nodes, nodes/s, gap and pose, beside phase 4's
   solo nodes/s), then 10 s more synchronised around each round's bounds
   and refine for their share of the wall; 9b a ``RegistrationService``
   on the headline target through ``serve_stdio`` (a goicp batch, a tracking query, an
   escalation, ``info`` naming the card) and ``serve_tcp`` on 127.0.0.1
   (a client without the auth token refused; four authenticated clients'
   goicp queries in one Batcher batch, then a tracking query each; a lone
   query of a service without shape buckets on the single-pair solver,
   whose rounds run on the Batcher's thread, 5 s budget), every pose
   within the limits; 9c three 300-point pairs in lockstep on the
   card and on the CPU path's K4 form: equal rounds, nodes and converged
   flags, one ``_pairs_round`` bit-equal in ub and lb, untrimmed and
   trimmed.

10. distribution: 10a ``make_sharded_se3_round`` at the headline's largest
   R-round bucket (21,080 nodes × 1,518 × 1,797) over meshes of the one
   card listed 2-4 times: 2×1 and 4×1 on "mxu" (K4) and "screen" (K2) bit-equal
   to the single-device round, 1×2 and 2×2 "mxu" untrimmed and trimmed (h
   = 0.75·N) within rtol 1e-5 + atol 1e-5, each round's ms beside the
   single-device round's (K4 and K2 must launch), then K4 at a point
   shard and K2 at a cube shard against their plain versions (rows of
   their own in the ``kernels`` line); 10b the certified bunny in two
   processes on the card through ``make_solver`` (the frontier-sharded
   ``GoIcpSolverMultiHost``), phase 4's threshold and round width, 150 s:
   both converge with gap ≤ ε, poses bit-equal across ranks and within
   the limits, each rank's counters and the total nodes/s beside phase 4's;
   10c ``register_pairs_distributed`` of 9a's four pairs over two
   processes, 15 s each: the result lists equal on both ranks at the
   exchanged record's f32, poses within the limits; 10d a two-process
   solve of 5b's 300-point subsets on the card and on the CPU: equal
   per-rank rounds and nodes.  The workers re-invoke this script with
   ``--mh-worker`` (the parent holds a CUDA context, so it does not fork)
   and meet in a gloo group through a ``file://`` store under
   ``chiprun_out/``; a worker that fails or outlives its timeout fails the
   run.

``python3 chip_smoke.py --witness`` builds the kernels and runs only 7b's
point-metric TOMLs, on the port's CPU path and on the card (minutes on the
CPU), for ``CPU_WITNESS``.

Each solve's (and each CLI run's) launch counts are reset just before it
and read just after;
K1's are also counted by (queries, targets), and the ``kernels`` line has a
K1 row per shape with that shape's launches in the certified solve.
The last lines are the ``kernels`` JSON line and the device JSON line.
Details go to ``chiprun_out/chip_smoke.json``.  Without CUDA, or outside the
repository, it exits non-zero and prints no result.
"""

from __future__ import annotations

import functools
import json
import os
import subprocess
import sys
import time
import tomllib

import numpy as np

from benchmark import workloads as wl

HERE = os.path.dirname(os.path.abspath(__file__))
OUT_DIR = os.path.join(HERE, "chiprun_out")
PEAK_BYTES_S = 3.35e12          # H100 SXM HBM3 (NVIDIA's data sheet)
SMS, LANES = 132, 128           # H100 SXM: FP32 lanes per SM
N_SRC, N_TGT = 1518, 1797       # the headline's subsample sizes
SOLVE_WALL_S = 150.0            # BnB budget: keeps the run inside its limit
MSE_FACTOR = 0.5                # mse_threshold = MSE_FACTOR · mse at the true pose
# a solve's parameters (benchmark/workloads.py): mse_threshold at MSE_FACTOR ×
# the (trimmed) mse at the truth, the BnB budget SOLVE_WALL_S unless given
solve_params = functools.partial(wl.solve_params, mse_factor=MSE_FACTOR, max_wall_s=SOLVE_WALL_S)
TRIM = 0.25                     # trim_fraction of the partial-overlap solves
TRIM_WALL_S = 60.0              # BnB budget of the trimmed solve (4b), which does not converge
SCREEN_WALL_S = 30.0            # BnB budget of the trimmed solve on the screen backend
PROFILE_TRIM_WALL_S = 30.0      # BnB budget of the traced trimmed solve (--profile)
ICP_GRAPH_REPS = 5              # calls of each ICP loop timed at the refine's shape
HEADLINE_COUNTS = (431, 8947314)  # rounds, nodes of the certified headline at seed 1
K1_RESIDENT_MAX = 6144          # csrc/nn_min_d2.cu kResidentMax: K1's targets in shared memory
# The distance forms (``variant=``) of K1/K4 and K3, FP32 instructions per
# (query, target) pair: diff 7 (3 subtractions, a multiply, 2 FMAs, the min;
# the bound the diff rows use), exp 4 (3 FMAs, the min), dot 6 (a multiply,
# 2 FMAs, 2 adds, the min); K3 per (point, target) pair and group of 8
# siblings: diff 22, exp 19 (3 FMAs and 8 × (add, min)).
FORM_OPS = {"diff": 7.0, "exp": 4.0, "dot": 6.0}
K3_FORM_OPS = {"diff": 22.0, "exp": 19.0}
FORMS_RING_NODES, FORMS_RING_TARGETS = 64, 20000
FORM_NOTE = "0 on any path (check only): no solver path passes variant= (goicp_tpu/nn/mxu.py:1050)"


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


def check_k1(chk, dev, S, T, rng, clock_hz, cli_q, cli_t):
    """K1 at each shape of ``k1_shapes`` and at the CLI's modes 0/1 on the
    whole bunny (``cli_q`` × ``cli_t``: 7b's source and target, 40,256 ×
    40,256, above the 6,144 targets that stay resident in shared memory, so
    on the ring route), on random inputs and on the shape's targets twice
    over (every nearest target has a twin, and the earlier must win);
    tol 0.  Returns one record per shape."""
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
    shapes = [*k1_shapes(S.shape[0], T.shape[0]), ("K1 cli", 1, cli_q.shape[0], cli_t.shape[0])]
    for key, poses, n, nt in shapes:
        if key == "K1 cli":           # the first iteration's queries: the source as loaded
            Q, Tx = cli_q, cli_t
        else:
            Sx = S[torch.as_tensor(np.sort(rng.choice(S.shape[0], n, replace=False)), device=dev)]
            Tx = T[torch.as_tensor(np.sort(rng.choice(T.shape[0], nt, replace=False)), device=dev)]
            Rp = axis_angle_rotation(torch.as_tensor(
                rng.uniform(-0.2, 0.2, (poses, 3)).astype(np.float32), device=dev))
            tp = torch.as_tensor(rng.uniform(-0.02, 0.02, (poses, 3)).astype(np.float32),
                                 device=dev)
            Q = (Sx[None] @ Rp.transpose(1, 2) + tp[:, None]).reshape(-1, 3).contiguous()
        t4 = fused.pack_nn_targets(Tx)
        name = f"{key[3:]} {poses}x{n} queries x {nt} targets"
        err = agree(name, Q, Tx, *fused.nearest_neighbor_mxu(Q, Tx, packed=t4))
        T2 = torch.cat([Tx, Tx])
        d2, idx = fused.nearest_neighbor_mxu(Q, T2)
        agree(f"{key[3:]} against the doubled targets", Q, T2, d2, idx)
        chk.expect(bool((idx < nt).all()), f"K1 {key[3:]}: the earlier twin wins every tie")
        route = fused.nn_route(Q.shape[0], t4.shape[0], fused._sm_count(Q.device.index))
        big = key == "K1 cli"         # ~1 ms a call: fewer reps
        if big:
            chk.expect(t4.shape[0] > K1_RESIDENT_MAX,
                       f"K1 cli: {t4.shape[0]} packed targets take the ring route "
                       f"(> {K1_RESIDENT_MAX} resident)")
        ms = device_ms(lambda: fused.nearest_neighbor_mxu(Q, Tx, packed=t4), 10 if big else 100,
                       clock_hz)
        call = timed_ms(lambda: fused.nearest_neighbor_mxu(Q, Tx, packed=t4), 5 if big else 20)
        # the plain version at the CLI shape is ~1,600 launches a call, more
        # than a stream queues behind device_ms's sleep: CUDA events instead
        plain = (timed_ms(lambda: nearest_neighbor(Q, Tx), 2) if big
                 else device_ms(lambda: nearest_neighbor(Q, Tx), 5, clock_hz))
        lib = device_ms(lambda: torch.cdist(Q, Tx).min(dim=1), 3 if big else 20, clock_hz)
        nq = Q.shape[0]
        b, by = bound_ms(4.0 * (3 * nq + 3 * nt + 2 * nq), 7.0 * nq * nt, clock_hz)
        recs[key] = _rec(
            f"{key} nearest_neighbor_mxu (exact NN + argmin), {poses} x {n} queries x {nt} targets",
            "goicp_tpu_torch/csrc/nn_min_d2.cu", "goicp_tpu/nn/mxu.py:152", err, ms, plain, b, by,
            lib, f"{nq} queries x {nt} targets", library_call="torch.cdist + min (two calls)",
            shape_key=[nq, nt], launch_route=dict(splits=route[0], queries_per_thread=route[1],
                                                  targets_resident=t4.shape[0] <= K1_RESIDENT_MAX),
            call_ms=call, timing="device time per call (device_ms), targets packed once")
        report(key, recs[key])
    return recs


def check_k3(chk, dev, S, T, rng, clock_hz, G, tag=""):
    """K3 at the T-round shape: se3_pop groups of 8 siblings (``tag`` names
    another path's shape in the row and the messages)."""
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
        chk.expect(err == 0.0, f"K3{tag} {name}: max |d2 err| {err:.3g} (tol 0: same rounding)")
    ms = timed_ms(lambda: fused.min_d2_groups(srcT, wm, gp), 10)
    plain = timed_ms(lambda: fused.min_d2_groups_plain(srcT, wm, gp), 2)
    Q = ((S @ Rg.transpose(1, 2))[:, None] + t8[:, :, None]).reshape(-1, 3)   # [8G·N, 3]
    lib = library_min_ms(Q, T)
    del Q
    b, by = bound_ms(4.0 * (3 * N + 3 * NT + 48 * G + 8 * G * N), K3_FORM_OPS["diff"] * G * N * NT,
                     clock_hz)
    return _rec(f"K3 min_d2_groups (8-sibling grouped distances){tag}",
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


K2_RESIDENT_MAX = 6144          # csrc/bounds.cu kBdResidentMax: K2's targets in shared memory


def check_k2(chk, dev, S, T, rng, clock_hz, B, tag=""):
    """K2 at the largest R-round bucket (8·se3_pop nodes; ``tag`` names
    another path's shape in the row and the messages), screened at the
    median lb and unscreened: within tolerance of the plain version and
    bit-equal to its kernel-order twin, with the launch plan, both times,
    both bounds and their ratio; then the ring route (targets above the
    6,144 that stay resident) at a few nodes."""
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
    plan = fused.k2_plan(B, srcX.shape[1], wm.shape[0])
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
            chk.expect(ok, f"K2{tag} {label} {name}: max |err| {err:.3g} (tol 1e-5 + 1e-5·|ref|), "
                           f"screened-set differences {differ} (all within tol of thresh)")
            ub_o, lb_o = fused.bounds_nodes_kernel_order(*args)
            chk.expect(bool(torch.equal(ub, ub_o) and torch.equal(lb, lb_o)),
                       f"K2{tag} {label} {name}: bit-equal to the plain version in the "
                       "kernel's summation order")
        ms = timed_ms(lambda: fused.bounds_nodes(srcX, wm, params), 10)
        plain = timed_ms(lambda: fused.bounds_nodes_plain(srcX, wm, params), 2)
        ub_blk, lb_blk = fused.bounds_block_sums_plain(srcX, wm, params)
        _, _, blocks = fused.screen_scan(ub_blk, lb_blk, params[:, 15])
        pts = torch.clamp(blocks * tq, max=N).sum().item()   # valid points the rule evaluates
        b, by = bound_ms(4.0 * (16 * B + 5 * N + 3 * NT + 2 * B), 7.0 * pts * NT, clock_hz)
        k2[label] = dict(ms=ms, plain_ms=plain, bound_ms=b, bound_by=by, max_abs_err=worst,
                         blocks_run=int(blocks.sum().item()), blocks_total=B * (srcX.shape[1] // tq))
    s, u = k2["screened"], k2["unscreened"]
    # the ring route: targets above the resident limit, the kernel-order
    # twin and the plain version on the same inputs
    NTg = 8000
    wm_g = fused.pack_targets(torch.rand(NTg, 3, device=dev) * 2.0 - 1.0)
    p_g = p_scr[:64].contiguous()
    plan_g = fused.k2_plan(64, srcX.shape[1], wm_g.shape[0])
    ub, lb = fused.bounds_nodes(srcX, wm_g, p_g)
    torch.cuda.synchronize()
    ub_o, lb_o = fused.bounds_nodes_kernel_order(srcX, wm_g, p_g)
    ok, err, _, _ = screened_agree(ub, lb, *fused.bounds_nodes_plain(srcX, wm_g, p_g), thresh, thresh)
    chk.expect(not plan_g["targets_resident"] and wm_g.shape[0] > K2_RESIDENT_MAX and ok
               and bool(torch.equal(ub, ub_o) and torch.equal(lb, lb_o)),
               f"K2{tag} ring route 64 nodes {N}x{NTg}: max |err| {err:.3g}, bit-equal to the "
               f"kernel-order version, plan {plan_g}")
    ring = dict(ms=timed_ms(lambda: fused.bounds_nodes(srcX, wm_g, p_g), 5), max_abs_err=err,
                plan=plan_g, shape=f"64 nodes x {N} points x {NTg} targets, thresh as above")
    rec = _rec(f"K2 bounds_nodes (screened fused bounds){tag}", "goicp_tpu_torch/csrc/bounds.cu",
               "goicp_tpu/nn/mxu.py:479",
               max(s["max_abs_err"], u["max_abs_err"]), s["ms"], s["plain_ms"],
               s["bound_ms"], s["bound_by"], None,
               f"{B} nodes x {N} points x {NT} targets, thresh = median lb "
               f"({s['blocks_run']} of {s['blocks_total']} blocks run)",
               library_none="no PyTorch call computes a screened, deflated sum",
               unscreened=u, screened_over_unscreened=s["ms"] / u["ms"],
               bound_share=s["bound_ms"] / s["ms"], launch_plan=plan, ring_route=ring)
    print(f"K2{tag} plan: {json.dumps(plan)}; screened {s['ms']:.4g} ms / unscreened "
          f"{u['ms']:.4g} ms = {s['ms'] / u['ms']:.3f}; bounds {s['bound_ms']:.4g} / "
          f"{u['bound_ms']:.4g} ms; ring route {ring['ms']:.4g} ms", flush=True)
    report(f"K2{tag} screened", rec)
    report(f"K2{tag} unscreened", dict(u, library_ms=None,
                                       shape=f"{B} nodes x {N} points x {NT} targets"))
    return rec


def check_k4(chk, dev, S, T, rng, clock_hz, B, tag=""):
    """K4 at the largest R-round bucket (``tag`` names another path's shape
    in the row and the messages): per-node distances, tol 0."""
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
                   f"K4{tag} {name}: max |d2 err| {err:.3g} (tol 0: same rounding, bit-equal)")
    ms = timed_ms(lambda: fused.min_d2_nodes(srcT, wm, params), 10)
    plain = timed_ms(lambda: fused.min_d2_nodes_plain(srcT, wm, params), 2)
    Q = (S @ Rb.transpose(1, 2) + tb[:, None]).reshape(-1, 3)            # [B·N, 3]
    lib = library_min_ms(Q, T)
    del Q
    b, by = bound_ms(4.0 * (16 * B + 3 * N + 3 * NT + B * srcT.shape[1]),
                     FORM_OPS["diff"] * B * N * NT, clock_hz)
    # the ring route: 20,000 targets do not stay resident in shared memory
    Bg, NTg = 64, 20000
    wm_g = fused.pack_targets(torch.rand(NTg, 3, device=dev) * 2.0 - 1.0)
    p_g = params[:Bg].contiguous()
    got = fused.min_d2_nodes(srcT, wm_g, p_g)
    torch.cuda.synchronize()
    ref = fused.min_d2_nodes_plain(srcT, wm_g, p_g)
    chk.expect(bool(torch.equal(got, ref)),
               f"K4{tag} ring route {Bg} nodes {N}x{NTg}: max |d2 err| "
               f"{float((got - ref).abs().max()):.3g} (tol 0: bit-equal)")
    bg, byg = bound_ms(4.0 * (16 * Bg + 3 * N + 3 * NTg + Bg * srcT.shape[1]),
                       FORM_OPS["diff"] * Bg * N * NTg, clock_hz)
    ring = dict(ms=timed_ms(lambda: fused.min_d2_nodes(srcT, wm_g, p_g), 5),
                plain_ms=timed_ms(lambda: fused.min_d2_nodes_plain(srcT, wm_g, p_g), 2),
                bound_ms=bg, bound_by=byg, shape=f"{Bg} nodes x {N} points x {NTg} targets")
    report(f"K4{tag} ring route", dict(ring, library_ms=None))
    return _rec(f"K4 min_d2_nodes (per-node distances, no index){tag}",
                "goicp_tpu_torch/csrc/nn_min_d2.cu",
                "goicp_tpu/nn/mxu.py:176 (via min_d2_nodes :361)", err, ms, plain, b, by, lib,
                f"{B} nodes x {N} points x {NT} targets",
                library_call=f"torch.cdist + amin over the {B * N} transformed queries, "
                             "in chunks of 2^19", ring_route=ring)


def bisect_ops(rows: int, Np: int) -> float:
    """The bisection's work per survivor: 24 passes and one final pass over
    ``rows`` x Np staged values, a compare and an add each."""
    return 2.0 * 25 * rows * Np


def check_k5(chk, dev, S, T, rng, clock_hz, B, h, tag=""):
    """K5 at the largest R-round bucket with the trimmed protocol's h
    (``tag`` names another path's shape, the full cert's whole source)."""
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
            chk.expect(ok, f"K5{tag} {label} {name}: max |err| {err:.3g} (tol 1e-5 + 1e-5·|ref|), "
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
    chk.expect(ok, f"K5{tag} global-target route 64 nodes {N}x20000: max |err| {err:.3g} "
                   "(tol 1e-5 + 1e-5·|ref|)")
    plan = fused.k5_plan(B, Np, wm.shape[0])
    s = out["screened"]
    rec = _rec(f"K5 bounds_nodes_trimmed (screened trimmed bounds){tag}",
               "goicp_tpu_torch/csrc/bounds_trimmed.cu", "goicp_tpu/nn/mxu.py:738",
               max(s["max_abs_err"], out["unscreened"]["max_abs_err"]), s["ms"], s["plain_ms"],
               s["bound_ms"], s["bound_by"], None,
               f"{B} nodes x {N} points x {NT} targets, h {h}, thresh = half the median positive "
               f"lb ({s['blocks_run']} of {s['blocks_total']} blocks run, {s['survivors']} survivors)",
               library_none="no PyTorch call computes a screened, trimmed sum",
               unscreened=out["unscreened"], launch_plan=plan,
               global_target_route=dict(max_abs_err=err, plan=fused.k5_plan(64, Np, wm_g.shape[0])))
    report(f"K5{tag} screened", rec)
    report(f"K5{tag} unscreened", dict(out["unscreened"], library_ms=None,
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


def check_rotation_bound(chk, dev):
    """The center-aware rotation bound on the card against the port's CPU
    path (which ``tests/test_torch_rotation.py`` holds bit-equal to the
    jitted JAX function) on 100,000 random cubes: the same bits; and its
    time at the largest R-round's 21,080 cubes, replayed from its CUDA graph
    as the rounds call it and eagerly (device ms, and the host's wall of one
    call waited for)."""
    import torch

    from goicp_tpu_torch.geo import rotation

    rng = np.random.default_rng(22)
    c = rng.uniform(-np.pi, np.pi, (300_000, 3)).astype(np.float32)
    c = c[np.linalg.norm(c, axis=1) <= np.pi][:100_000]
    s = (np.pi / 2.0 ** rng.integers(1, 11, c.shape[0])).astype(np.float32)
    ref = rotation.axis_angle_cube_max_angle(torch.from_numpy(c), torch.from_numpy(s)).numpy()
    got = rotation.axis_angle_cube_max_angle(torch.as_tensor(c, device=dev),
                                             torch.as_tensor(s, device=dev)).cpu().numpy()
    differ = int((got.view(np.int32) != ref.view(np.int32)).sum())
    chk.expect(differ == 0, f"rotation bound: card vs CPU path on {c.shape[0]} cubes, "
                            f"{differ} differ in their bits (0 expected)")
    cd, sd = torch.as_tensor(c[:21080], device=dev), torch.as_tensor(s[:21080], device=dev)

    def host_ms(fn, reps=30):
        fn()
        torch.cuda.synchronize()
        ts = []
        for _ in range(reps):
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            ts.append((time.perf_counter() - t0) * 1e3)
        return float(np.median(ts))

    graphed = lambda: rotation.axis_angle_cube_max_angle(cd, sd)  # noqa: E731
    eager = lambda: rotation._cube_max_angle(cd, sd, 40, 12)  # noqa: E731
    out = dict(cubes=int(c.shape[0]), bits_differ=differ,
               graph_ms=timed_ms(graphed, 30), graph_host_ms=host_ms(graphed),
               eager_ms=timed_ms(eager, 30), eager_host_ms=host_ms(eager))
    print("rotation bound: " + json.dumps(out), flush=True)
    return out




def check_icp_graph(chk, dev, src, tgt, R_gt, t_gt, psrc, ptgt, pR, pt):
    """The in-round refine's ICP (``icp.run_icp``, each iteration one
    replay of a CUDA graph) against its eager loop (``icp.solver._run_eager``,
    the same iteration op by op) on the same CUDA tensors, at the refine's
    shape (``refine_top_k`` 8 poses × 1,518 source points against 1,797
    targets, ``refine_max_iter`` 32): the headline pair untrimmed and the
    partial pair trimmed, each with every pose active and with a third of
    them gated off.  R, t, sse and iters must be bit-equal and K1's launches
    equal; the host's wall per iteration of each loop (a call waited for,
    over the iterations it ran; median of ICP_GRAPH_REPS calls), the first
    graphed call's (the capture's) and one replay's device time."""
    import torch

    from goicp_tpu_torch.bnb.params import BnbParams
    from goicp_tpu_torch.core.types import RigidTransform
    from goicp_tpu_torch.geo.rotation import random_rotations
    from goicp_tpu_torch.icp import IcpParams, exact_correspondence, run_icp
    from goicp_tpu_torch.icp import solver as icp_solver
    from goicp_tpu_torch.nn import fused

    bp = BnbParams()
    B, iters_cap = bp.refine_top_k, min(bp.icp_max_iter, bp.refine_max_iter)
    rng = np.random.default_rng(61)
    out = {}
    for label, S_h, T_h, R_h, t_h, trim in (("untrimmed", src, tgt, R_gt, t_gt, 0.0),
                                           ("trimmed", psrc, ptgt, pR, pt, TRIM)):
        R0 = random_rotations(B, rng)
        R0[:2] = R_h
        t0 = (t_h + rng.normal(0, 0.05, (B, 3))).astype(np.float32)
        S, T = torch.as_tensor(S_h, device=dev), torch.as_tensor(T_h, device=dev)
        init = RigidTransform(torch.as_tensor(R0, device=dev), torch.as_tensor(t0, device=dev))
        params = IcpParams(max_iter=iters_cap, rel_tol=bp.icp_rel_tol, trim_fraction=trim)
        corr = exact_correspondence(T)
        for gated in (False, True):
            key = f"{label}{', gated' if gated else ''}"
            a0 = torch.as_tensor(np.arange(B) % 3 != 1, device=dev) if gated else None

            def eager():
                return icp_solver._run_eager(S, corr, init.R, init.t, params, active0=a0)

            def graphed():
                res = run_icp(S, corr, init, params, active0=a0)
                return res.transform.R, res.transform.t, res.sse, res.iters

            def walls(fn):
                """``(outputs, K1 launches, [host ms of each call])``."""
                ms = []
                for _ in range(ICP_GRAPH_REPS):
                    torch.cuda.synchronize()
                    fused.reset_launch_counts()
                    t0_ = time.perf_counter()
                    o = fn()
                    torch.cuda.synchronize()
                    ms.append((time.perf_counter() - t0_) * 1e3)
                return o, fused.launches["nearest_neighbor_mxu"], ms

            misses = icp_solver._icp_graph.cache_info().misses
            torch.cuda.synchronize()
            t0_ = time.perf_counter()
            graphed()
            torch.cuda.synchronize()
            first_ms = (time.perf_counter() - t0_) * 1e3
            captured = icp_solver._icp_graph.cache_info().misses - misses
            e_out, e_k1, e_ms = walls(eager)
            g_out, g_k1, g_ms = walls(graphed)
            differ = [name for name, a, b in zip(("R", "t", "sse", "iters"), g_out, e_out)
                      if not torch.equal(a, b)]
            n_it = int(e_out[3].max())
            g = icp_solver._icp_graph(dev.index or 0, B, S.shape[0], T.shape[0],
                                      float(trim), float(bp.icp_rel_tol))
            rec = dict(poses=B, points=int(S.shape[0]), targets=int(T.shape[0]),
                       trim_fraction=trim, iterations=n_it,
                       iters=[int(x) for x in e_out[3].cpu()],
                       k1_launches_eager=e_k1, k1_launches_graph=g_k1,
                       captures_in_first_call=captured, first_call_ms=first_ms,
                       eager_host_ms_per_iter=float(np.median(e_ms)) / max(n_it, 1),
                       graph_host_ms_per_iter=float(np.median(g_ms)) / max(n_it, 1),
                       replay_device_ms=timed_ms(g.graph.replay, 50),
                       differ=differ)
            print(f"ICP graph, {key}: " + json.dumps(rec), flush=True)
            chk.expect(not differ and n_it > 1,
                       f"ICP graph ({key}, {B} x {S.shape[0]} vs {T.shape[0]}): graphed "
                       f"refine bit-equal to the eager loop over {n_it} iterations "
                       f"(differ: {differ or 'none'})")
            chk.expect(g_k1 == e_k1 == n_it,
                       f"ICP graph ({key}): K1 launches {g_k1} graphed, {e_k1} eager, "
                       f"{n_it} iterations")
            out[key] = rec
    return out


def once_ms(fn):
    """``(fn(), its CUDA-event ms)`` from one call: for the plain versions
    of the forms, whose f64 fused multiply-adds take seconds at the
    headline's shapes, so the check's own call is the one timed."""
    import torch

    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    out = fn()
    b.record()
    b.synchronize()
    return out, a.elapsed_time(b)


def check_forms(chk, dev, S, T, rng, clock_hz, B, G, lib_k4, lib_k3):
    """The exp and dot forms of K4 (at the largest R-round bucket, B nodes,
    and on the ring route: 64 nodes x 20,000 targets), of K1 over node
    poses (``min_d2_padded(want_idx=True)`` at the in-round refine's 8
    poses) and the exp form of K3 (G groups): each bit-equal to its plain
    version (tol 0), with the max |Δd²| against the diff form's kernel on
    the same inputs (and K1's share of differing indices), kernel, diff
    and plain times and the bound by the forms' instruction counts
    (``FORM_OPS``).  ``lib_k4``/``lib_k3``: the torch.cdist times of the
    K4 and K3 rows, the same function on the same shapes in this run.
    Launch counts are reset first; returns one record per form."""
    import torch

    from goicp_tpu_torch.nn import fused

    N, NT = S.shape[0], T.shape[0]
    srcT, wm = fused.pack_sources(S), fused.pack_targets(T)
    Np, Mp = srcT.shape[1], wm.shape[0]
    Rb, tb, _, _ = node_batch(rng, B, dev)
    params = fused.pack_params(Rb, tb)
    fused.reset_launch_counts()
    recs = {}
    diff_k4 = fused.min_d2_nodes(srcT, wm, params)
    diff_k4_ms = timed_ms(lambda: fused.min_d2_nodes(srcT, wm, params), 10)
    wm_g = fused.pack_targets(torch.rand(FORMS_RING_TARGETS, 3, device=dev) * 2.0 - 1.0)
    p_g = params[:FORMS_RING_NODES].contiguous()
    Bg = FORMS_RING_NODES
    for v in ("exp", "dot"):
        got = fused.min_d2_nodes(srcT, wm, params, variant=v)
        torch.cuda.synchronize()
        ref, plain = once_ms(lambda: fused.min_d2_nodes_plain(srcT, wm, params, variant=v))
        same = bool(torch.equal(got, ref))
        chk.expect(same, f"K4 {v} bunny {B} nodes {N}x{NT}: bit-equal to the plain version "
                         f"(max |d2 err| {float((got - ref).abs().max()):.3g}, tol 0)")
        delta = float((got[:, :N] - diff_k4[:, :N]).abs().max())
        ms = timed_ms(lambda: fused.min_d2_nodes(srcT, wm, params, variant=v), 10)
        b, by = bound_ms(4.0 * (16 * B + 3 * N + 3 * NT + B * Np), FORM_OPS[v] * B * N * NT,
                         clock_hz)
        got_g = fused.min_d2_nodes(srcT, wm_g, p_g, variant=v)
        torch.cuda.synchronize()
        ref_g, plain_g = once_ms(lambda: fused.min_d2_nodes_plain(srcT, wm_g, p_g, variant=v))
        chk.expect(bool(torch.equal(got_g, ref_g)) and wm_g.shape[0] > K1_RESIDENT_MAX,
                   f"K4 {v} ring route {Bg} nodes {N}x{FORMS_RING_TARGETS}: bit-equal to the "
                   "plain version (tol 0)")
        bg, byg = bound_ms(4.0 * (16 * Bg + 3 * N + 3 * FORMS_RING_TARGETS + Bg * Np),
                           FORM_OPS[v] * Bg * N * FORMS_RING_TARGETS, clock_hz)
        ring = dict(ms=timed_ms(lambda: fused.min_d2_nodes(srcT, wm_g, p_g, variant=v), 5),
                    plain_ms=plain_g, bound_ms=bg, bound_by=byg,
                    shape=f"{Bg} nodes x {N} points x {FORMS_RING_TARGETS} targets")
        recs[f"K4 {v}"] = _rec(
            f"K4 min_d2_nodes, variant={v!r} (per-node distances, no index)",
            "goicp_tpu_torch/csrc/nn_min_d2.cu", "goicp_tpu/nn/mxu.py:176 (via min_d2_nodes :361)",
            float((got - ref).abs().max()), ms, plain, b, by, lib_k4,
            f"{B} nodes x {N} points x {NT} targets",
            library_call=f"torch.cdist + amin over the {B * N} transformed queries, in chunks "
                         "of 2^19 (the K4 row's time)",
            max_abs_diff_vs_diff_form=delta, diff_form_ms=diff_k4_ms,
            ms_over_diff_form=ms / diff_k4_ms, bound_share=b / ms, ring_route=ring,
            path_note=FORM_NOTE)
        report(f"K4 {v}", recs[f"K4 {v}"])
        report(f"K4 {v} ring route", dict(ring, library_ms=None))

    # K1 over node poses at the in-round refine's shape: 8 poses near the identity
    from goicp_tpu_torch.geo.rotation import axis_angle_rotation

    P1 = 8
    R1 = axis_angle_rotation(torch.as_tensor(rng.uniform(-0.2, 0.2, (P1, 3)).astype(np.float32),
                                             device=dev))
    t1 = torch.as_tensor(rng.uniform(-0.02, 0.02, (P1, 3)).astype(np.float32), device=dev)
    p1 = fused.pack_params(R1, t1)
    nq = P1 * Np
    d_diff, i_diff = fused.min_d2_padded(p1, srcT, wm, want_idx=True, variant="diff")
    diff_k1_ms = device_ms(lambda: fused.min_d2_padded(p1, srcT, wm, want_idx=True,
                                                       variant="diff"), 100, clock_hz)
    Q = (S[None] @ R1.transpose(1, 2) + t1[:, None]).reshape(-1, 3)
    lib_k1 = device_ms(lambda: torch.cdist(Q, T).min(dim=1), 20, clock_hz)
    route = fused.nn_route(nq, Mp, fused._sm_count(dev.index or 0))
    for v in ("exp", "dot"):
        d2, idx = fused.min_d2_padded(p1, srcT, wm, want_idx=True, variant=v)
        torch.cuda.synchronize()
        (d2_p, idx_p), plain = once_ms(
            lambda: fused.min_d2_padded_plain(p1, srcT, wm, want_idx=True, variant=v))
        chk.expect(bool(torch.equal(d2, d2_p) and torch.equal(idx, idx_p)),
                   f"K1 {v} refine {P1}x{N} queries x {NT} targets (min_d2_padded, want_idx): "
                   "d2 and indices bit-equal to the plain version (tol 0)")
        delta = float((d2[:, :N] - d_diff[:, :N]).abs().max())
        idx_share = float((idx[:, :N] != i_diff[:, :N]).float().mean())
        ms = device_ms(lambda: fused.min_d2_padded(p1, srcT, wm, want_idx=True, variant=v), 100,
                       clock_hz)
        b, by = bound_ms(4.0 * (16 * P1 + 3 * N + 3 * NT + 2 * nq), FORM_OPS[v] * nq * NT,
                         clock_hz)
        recs[f"K1 {v}"] = _rec(
            f"K1 min_d2_padded(want_idx=True), variant={v!r} (node poses, index), "
            f"{P1} poses x {N} points x {NT} targets",
            "goicp_tpu_torch/csrc/nn_min_d2.cu", "goicp_tpu/nn/mxu.py:152",
            float((d2 - d2_p).abs().max()), ms, plain, b, by, lib_k1,
            f"{nq} queries ({P1} x {Np} packed) x {NT} targets",
            library_call="torch.cdist + min (two calls) over the transformed queries",
            max_abs_diff_vs_diff_form=delta, idx_differ_share_vs_diff_form=idx_share,
            diff_form_ms=diff_k1_ms, ms_over_diff_form=ms / diff_k1_ms, bound_share=b / ms,
            launch_route=dict(splits=route[0], queries_per_thread=route[1]),
            timing="device time per call (device_ms)", path_note=FORM_NOTE)
        report(f"K1 {v}", recs[f"K1 {v}"])

    # K3's exp form at the T-round shape
    Rg = axis_angle_rotation(torch.as_tensor(
        rng.uniform(-np.pi, np.pi, (G, 3)).astype(np.float32), device=dev))
    t8 = torch.as_tensor(rng.uniform(-0.3, 0.3, (G, 8, 3)).astype(np.float32), device=dev)
    gp = fused.pack_group_params(Rg, t8)
    diff_k3 = fused.min_d2_groups(srcT, wm, gp)
    diff_k3_ms = timed_ms(lambda: fused.min_d2_groups(srcT, wm, gp), 10)
    got = fused.min_d2_groups(srcT, wm, gp, variant="exp")
    torch.cuda.synchronize()
    ref, plain = once_ms(lambda: fused.min_d2_groups_plain(srcT, wm, gp, variant="exp"))
    chk.expect(bool(torch.equal(got, ref)), f"K3 exp bunny {G} groups {N}x{NT}: bit-equal to "
                                            "the plain version (tol 0)")
    ms = timed_ms(lambda: fused.min_d2_groups(srcT, wm, gp, variant="exp"), 10)
    b, by = bound_ms(4.0 * (3 * N + 3 * NT + 48 * G + 8 * G * N), K3_FORM_OPS["exp"] * G * N * NT,
                     clock_hz)
    recs["K3 exp"] = _rec(
        "K3 min_d2_groups, variant='exp' (8-sibling grouped distances)",
        "goicp_tpu_torch/csrc/min_d2_grouped.cu", "goicp_tpu/nn/mxu.py:265",
        float((got - ref).abs().max()), ms, plain, b, by, lib_k3,
        f"{G} groups x 8 x {N} points x {NT} targets",
        library_call=f"torch.cdist + amin over the {8 * G * N} transformed queries, in chunks "
                     "of 2^19 (the K3 row's time)",
        max_abs_diff_vs_diff_form=float((got.reshape(G * 8, Np)[:, :N]
                                         - diff_k3.reshape(G * 8, Np)[:, :N]).abs().max()),
        diff_form_ms=diff_k3_ms, ms_over_diff_form=ms / diff_k3_ms, bound_share=b / ms,
        path_note=FORM_NOTE)
    report("K3 exp", recs["K3 exp"])
    for key, counter in (("K4 exp", "min_d2_nodes_exp"), ("K4 dot", "min_d2_nodes_dot"),
                         ("K1 exp", "min_d2_padded_exp"), ("K1 dot", "min_d2_padded_dot"),
                         ("K3 exp", "min_d2_groups_exp")):
        recs[key]["check_launches"] = fused.launches[counter]
    print("forms: " + json.dumps({k: dict(ms=r["ms"], diff_form_ms=r["diff_form_ms"],
                                          bound_ms=r["bound_ms"],
                                          max_abs_diff_vs_diff_form=r["max_abs_diff_vs_diff_form"])
                                  for k, r in recs.items()}), flush=True)
    return recs


def kernel_checks(chk, dev, src, tgt, clock_hz, se3_pop, h_trim, big_src):
    """Phase 3: every kernel against its plain version, with its times.
    Returns the per-kernel records (without launch counts)."""
    import torch

    from goicp_tpu_torch.nn import fused

    rng = np.random.default_rng(7)
    S = torch.as_tensor(src, device=dev)
    T = torch.as_tensor(tgt, device=dev)
    tgt_full = bunny_full()[0]
    rec = check_k1(chk, dev, S, T, rng, clock_hz,
                   torch.as_tensor(moved_bunny(tgt_full)[0], device=dev),
                   torch.as_tensor(tgt_full, dtype=torch.float32, device=dev))
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
    rec["K7"]["path_note"] = ("the phase 3 check only: no solver path calls it "
                              "(goicp_tpu/bnb/se3_eval.py:436)")
    t0 = time.perf_counter()
    rec.update(check_forms(chk, dev, S, T, rng, clock_hz, 8 * se3_pop, se3_pop,
                           rec["K4"]["library_ms"], rec["K3"]["library_ms"]))
    print(f"forms check: {time.perf_counter() - t0:.1f} s", flush=True)
    return rec


def big_source(n: int = 4096):
    """``n`` points of rotated_bunny.ply (seed 4), scaled into [−1, 1]³: the
    source of K6's Np = 4,096 check."""
    from goicp_tpu_torch.io import read_ply

    big = read_ply(os.path.join(HERE, "data_generated", "rotated_bunny.ply"))
    big = big[np.sort(np.random.default_rng(4).choice(big.shape[0], n, replace=False))]
    return (big / np.abs(big).max()).astype(np.float32)


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
        timers=timers, R=R.tolist(), t=t.tolist(),
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
    the pose (1e-4), the sse (rtol 1e-5), the rounds and the nodes;
    ``expect`` lists kernels that must have launched in the card's solve."""
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
    ok = (dR < 1e-4 and abs(rg.sse - rc.sse) <= 1e-5 * abs(rc.sse) and rg.rounds == rc.rounds
          and rg.rot_nodes == rc.rot_nodes)
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


CLI_WALL_S = 30.0               # BnB budget of the CLI's mode-4 solve and the grid solve

# 7b's point-metric runs on the port's CPU path, the witness of the card's
# (``python3 chip_smoke.py --witness`` on the H100 machine's CPU, 8 threads;
# mode 1 took 983 s there).  The card must end within WITNESS_ITERS
# iterations of them and within WITNESS_RMS of their pose (RMS displacement
# of the source; the card's runs were 2.5e-7 and 2.8e-8 from them, the
# stall itself 6.75e-4 and 4.16e-3 from the true pose).
CPU_WITNESS = {
    "mode 1": dict(icp_iters=53, rms=0.0006751772587839814,
                R=[[0.9853625297546387, -0.142537459731102, 0.09352248162031174],
                   [0.14660879969596863, 0.9884591102600098, -0.03817742317914963],
                   [-0.087001271545887, 0.05132972449064255, 0.9948866367340088]],
                t=[0.005034530069679022, -0.002682269085198641, 0.005478300619870424]),
    "mode 2": dict(icp_iters=99, rms=0.004162753476224238,
                R=[[0.9817355275154114, -0.1708204746246338, 0.08378029614686966],
                   [0.17259475588798523, 0.9848902225494385, -0.014357254840433598],
                   [-0.08006177842617035, 0.028554998338222504, 0.9963826537132263]],
                t=[0.00339655508287251, -0.0032234119717031717, 0.0034434758126735687]),
}
WITNESS_ITERS, WITNESS_RMS = 2, 1e-5


class Spy:
    """Replaces ``module.name`` by a wrapper that synchronises the card
    around each call, times it and keeps its result; ``restore`` puts the
    original back."""

    def __init__(self, module, name, method: bool = False):
        import torch

        self.module, self.name, self.orig = module, name, getattr(module, name)
        self.calls = []
        spy = self

        def wrapper(*a, **k):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = spy.orig(*a, **k)
            torch.cuda.synchronize()
            spy.calls.append((time.perf_counter() - t0, a, out))
            return out

        setattr(module, name, wrapper)

    def restore(self):
        setattr(self.module, self.name, self.orig)


def bunny_full():
    """The whole rotated_bunny.ply (40,256 points) as the target, the source
    Rᵀ(target − t) for its ground truth, and that truth (float64)."""
    from goicp_tpu_torch.io import read_ply

    tgt = read_ply(os.path.join(HERE, "data_generated", "rotated_bunny.ply"))
    with open(os.path.join(HERE, "data_generated", "rotated_bunny_gt.toml"), "rb") as f:
        gt = tomllib.load(f)
    R = np.asarray(gt["rotation"], np.float64)
    t = np.asarray(gt["translation"], np.float64)
    return tgt, (tgt.astype(np.float64) - t) @ R, R, t


def moved_bunny(tgt_full):
    """7b's source: the whole target moved by 10° about (1, 2, 3) and 3 % of
    its extent, so that target = Rs·source + ts.  Returns (source as f32,
    Rs, ts, the extent)."""
    import torch

    from goicp_tpu_torch.geo.rotation import axis_angle_rotation

    axis = np.float64([1.0, 2.0, 3.0]) / np.sqrt(14.0)
    Rs = axis_angle_rotation(torch.as_tensor(np.radians(10.0) * axis)).numpy()
    ext = float(np.linalg.norm(tgt_full.max(0) - tgt_full.min(0)))
    ts = 0.03 * ext * np.float64([2.0, -1.0, 2.0]) / 3.0
    return ((tgt_full.astype(np.float64) - ts) @ Rs).astype(np.float32), Rs, ts, ext


def runs_7b(base):
    """Writes 7b's source PLY and its four TOMLs (modes 1 and 2, each on the
    point and the plane metric; from the identity, ``mse_threshold`` 1e-10,
    so ICP runs until it stalls or 128 iterations).  Returns ``[(mode,
    metric, toml, name)]``, Rs, ts, the extent and the source as read back."""
    from goicp_tpu_torch.io import read_ply, write_ply

    tgt_ply = os.path.join(HERE, "data_generated", "rotated_bunny.ply")
    src_b, Rs, ts, ext = moved_bunny(bunny_full()[0])
    src_ply = os.path.join(base, "bunny_moved_40256.ply")
    write_ply(src_ply, src_b)
    runs = []
    for mode, metric in ((1, "point"), (1, "plane"), (2, "point"), (2, "plane")):
        toml = scenario_toml(os.path.join(base, f"mode{mode}_{metric}.toml"), tgt_ply,
                             src_ply, mode, 1.0, 1.0, 1e-10, icp_metric=metric)
        runs.append((mode, metric, toml, f"mode {mode}" + (" plane" if metric == "plane" else "")))
    return runs, Rs, ts, ext, read_ply(src_ply).astype(np.float64)


def cpu_witness(chk, dev):
    """``--witness``: 7b's point-metric runs of modes 1 and 2 on the port's
    CPU path and then on the card (K1 bit-equal to its plain version makes
    the two differ only in the order of the Procrustes reductions): their
    iterations, poses and walls, and the RMS displacement of the source
    between the two poses.  Writes ``chiprun_out/chip_smoke_witness.json``;
    ``CPU_WITNESS`` holds its CPU runs."""
    import torch

    from goicp_tpu_torch import cli

    torch.set_num_threads(os.cpu_count() or 1)
    base = os.path.join(OUT_DIR, "cli")
    os.makedirs(base, exist_ok=True)
    runs, Rs, ts, ext, src_b = runs_7b(base)
    spies = [Spy(cli, "run_scenario")]
    out = dict(threads=torch.get_num_threads(), extent=ext)
    try:
        for mode, metric, toml, name in runs:
            if metric != "point":
                continue
            res = {}
            for where in ("cpu", "cuda"):
                o, info = run_cli(chk, f"witness {name} on {where}", toml,
                                  os.path.join(base, f"witness_{where}_mode{mode}"), spies, where)
                rot, terr, rms = wl.pose_error(o["R"], o["t"], Rs, ts, src_b)
                res[where] = dict(icp_iters=int(o["icp_iters"]), R=np.asarray(o["R"]).tolist(),
                                  t=np.asarray(o["t"]).tolist(), rot_err_deg=rot, rms=rms,
                                  main_wall_s=info["main_wall_s"], launches=info["launches"])
            between = wl.pose_error(res["cuda"]["R"], res["cuda"]["t"], np.asarray(res["cpu"]["R"]),
                                 np.asarray(res["cpu"]["t"]), src_b)
            out[name] = dict(res, rot_between_deg=between[0], rms_between=between[2])
            print(f"witness {name}: cpu {res['cpu']['icp_iters']} iterations, RMS {res['cpu']['rms']:.4g}; "
                  f"card {res['cuda']['icp_iters']} iterations, RMS {res['cuda']['rms']:.4g}; "
                  f"between {between[2]:.3g} ({between[0]:.3g} deg)", flush=True)
    finally:
        for sp in spies:
            sp.restore()
    with open(os.path.join(OUT_DIR, "chip_smoke_witness.json"), "w") as f:
        json.dump(out, f, indent=1)
    return out


def scenario_toml(path, target, source, mode, subsample, resize, mse, **tpu):
    """A scenario TOML of the reference's schema; ``tpu`` fills ``[tpu]``.
    The translation cube is ±0.5, the solver's default."""
    lines = ["[io]", f"target = {json.dumps(target)}", f"source = {json.dumps(source)}",
             'output = "output.toml"', 'visualization = "viz.ply"', "", "[params]",
             f"mode = {mode}", f"subsample = {float(subsample)!r}",
             f"mse_threshold = {float(mse)!r}", f"resize = {float(resize)!r}", "",
             "[params.translation]",
             *(f"{a}{b} = {v}" for a in "xyz" for b, v in (("min", -0.5), ("max", 0.5))),
             "", "[tpu]", *(f"{k} = {json.dumps(v)}" for k, v in tpu.items())]
    with open(path, "w") as f:
        f.write("\n".join(lines) + "\n")
    return path


def run_cli(chk, label, toml, outdir, spies, device: str = "cuda"):
    """``goicp_tpu_torch.cli.main`` on the card (or on the CPU path), with
    the launch counts of exactly this run; returns what ``run_scenario``
    returned and the counts."""
    import torch

    from goicp_tpu_torch import cli
    from goicp_tpu_torch.nn import fused

    for sp in spies:
        sp.calls.clear()
    torch.cuda.synchronize()
    fused.reset_launch_counts()
    t0 = time.perf_counter()
    rc = cli.main([toml, "--output", outdir, "--device", device])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    out = spies[0].calls[-1][2]
    with open(out["output_toml"], "rb") as f:
        doc = tomllib.load(f)
    chk.expect(np.allclose(doc["result"]["rotation"], out["R"], rtol=0, atol=1e-7)
               and np.allclose(doc["result"]["translation"], out["t"], rtol=0, atol=1e-7),
               f"{label}: output.toml parses and holds the returned R and t")
    return out, dict(rc=rc, main_wall_s=wall, launches=dict(fused.launches),
                     k1_launches_by_shape={f"{q}x{t}": n for (q, t), n
                                           in sorted(fused.nn_launch_shapes.items())})


def plain_stages(dev, tgt_full, src_h, runs, clock_hz):
    """The new paths' plain-PyTorch stages at the shapes phase 7 gives them,
    each with its time (CUDA events), how often phase 7's runs ran it, and
    its bound: the EDT build at 256³ of the whole cloud (one per mode-2
    run), the normals of the whole cloud, the grid bounds of one R-round at
    the largest bucket (one per round of the grid solve) and one plane step
    at the refine shape (one per plane ICP iteration of the mode-4 run)."""
    import torch

    from goicp_tpu_torch.geo.normals import estimate_normals
    from goicp_tpu_torch.geo.rotation import axis_angle_rotation
    from goicp_tpu_torch.icp.solver import _plane_update
    from goicp_tpu_torch.nn.grid import build_distance_grid
    from goicp_tpu_torch.bnb.se3_eval import evaluate_se3_nodes

    rng = np.random.default_rng(9)
    T = torch.as_tensor(tgt_full, device=dev)
    nt = T.shape[0]
    out = {}
    n = 256
    out["EDT build 256^3"] = dict(
        ms=timed_ms(lambda: build_distance_grid(T, n=n, method="edt", with_index=True), 2),
        per_run=1, run="7b mode 2 (each metric)", shape=f"{nt} targets, {n}^3 cells, with the index",
        # three min-plus passes: n^4 candidates each, an add and a compare
        bound=bound_ms(4.0 * 3 * nt + 12.0 * n ** 3, 3 * 2.0 * n ** 4, clock_hz))
    out["normals"] = dict(
        ms=timed_ms(lambda: estimate_normals(T, k=16), 3), per_run=1, run="7b mode 2 plane",
        shape=f"{nt} points, k = 16",
        # |q|² − 2q·p + |p|² per pair (~8 operations), then 16-point covariances
        bound=bound_ms(4.0 * 6 * nt, 8.0 * nt * nt, clock_hz))
    grid = build_distance_grid(torch.as_tensor(tgt_full * 1.0, device=dev), n=n,
                               expand=1.5, method="edt", with_index=True)
    M, N = 21080, src_h.shape[0]
    S = torch.as_tensor(src_h, device=dev)
    R = axis_angle_rotation(torch.as_tensor(rng.uniform(-np.pi, np.pi, (M, 3)).astype(np.float32),
                                            device=dev))
    tc = torch.as_tensor(rng.uniform(-0.3, 0.3, (M, 3)).astype(np.float32), device=dev)
    ang = torch.full((M,), 0.1, device=dev)
    tspan = torch.full((M,), 0.05, device=dev)
    mask = torch.ones(M, dtype=torch.bool, device=dev)
    norms = torch.linalg.vector_norm(S, dim=1)
    out["grid bounds of one R-round"] = dict(
        ms=timed_ms(lambda: evaluate_se3_nodes(S, norms, grid, T[:1], 0.0, R, ang, tc, tspan,
                                               mask, lookup="nearest", backend="grid"), 5),
        per_run=runs["grid solve"]["rounds"], run="7c grid solve (rounds)",
        shape=f"{M} nodes x {N} points, nearest lookup",
        # a transform, a lookup and the deflated terms: ~40 operations per pair
        bound=bound_ms(4.0 * (3 * N + 16 * M + 2 * M) + 4.0 * n ** 3, 40.0 * M * N, clock_hz))
    B = 8
    pts = (S[None] @ R[:B].transpose(1, 2) + tc[:B, None]).contiguous()
    dst = pts + 0.01
    nrm = torch.nn.functional.normalize(torch.ones_like(pts), dim=-1)
    out["plane step"] = dict(
        ms=timed_ms(lambda: _plane_update(pts, dst, nrm, None), 20),
        per_run=runs["mode 4 plane"]["icp_iters"], run="7a mode 4 plane (ICP iterations)",
        shape=f"{B} poses x {N} points",
        # the 6x6 normal equations: 21 + 6 products per point, and the solve
        bound=bound_ms(4.0 * 9 * B * N, 2.0 * 27 * B * N, clock_hz))
    for k, v in out.items():
        v["bound_ms"], v["bound_by"] = v.pop("bound")
        print(f"plain stage {k}: {v['ms']:.4g} ms, bound {v['bound_ms']:.4g} ms ({v['bound_by']}), "
              f"{v['per_run']} per run of {v['run']}, at {v['shape']}", flush=True)
    return out


def cli_phase(chk, dev, src_h, R_h, t_h, scale_h, psrc, ptgt, pR, pt, clock_hz):
    """Phase 7: the CLI and the new paths.  7a mode 4 with the plane metric
    through ``cli.main`` at the headline's sizes; 7b modes 1 and 2 at the
    whole bunny's width; 7c a solve above ``mxu_max`` through ``register``
    (grid bounds, grid ICP); 7d card against CPU on the grid, exact and
    plane paths.  Inputs are written under ``chiprun_out/cli/``."""
    import torch

    from goicp_tpu_torch import cli, register
    from goicp_tpu_torch.bnb import se3, solver
    from goicp_tpu_torch.io import load_cloud, read_ply, write_ply
    from goicp_tpu_torch.io.loader import subsample_cloud
    from goicp_tpu_torch.nn import fused

    base = os.path.join(OUT_DIR, "cli")
    os.makedirs(base, exist_ok=True)
    tgt_full, src_full, R_gt, t_gt = bunny_full()
    n = tgt_full.shape[0]
    tgt_ply = os.path.join(HERE, "data_generated", "rotated_bunny.ply")
    spies = [Spy(cli, "run_scenario"), Spy(solver, "estimate_normals"),
             Spy(cli, "build_distance_grid")]
    out = {}
    try:
        # -- 7a: mode 4, plane metric, 1,518 / 1,797 points --------------
        s = N_TGT / n
        n_src = int(np.ceil(N_SRC / s))                  # floor(n_src·s) = 1,518
        sub = np.sort(np.random.default_rng(1).choice(n, n_src, replace=False))
        src_ply = os.path.join(base, "bunny_source_34006.ply")
        write_ply(src_ply, src_full[sub].astype(np.float32))
        seed = next(k for k in range(1000)
                    if subsample_cloud(tgt_full, s, k).shape[0] == N_TGT
                    and subsample_cloud(src_full[sub], s, k).shape[0] == N_SRC)
        scale = 1.0 / max(np.abs(src_full).max(), np.abs(tgt_full).max())
        S = load_cloud(src_ply, s, scale, seed)
        T = load_cloud(tgt_ply, s, scale, seed)
        mse_true = wl.mse_at_truth(dev, S, T, R_gt.astype(np.float32), (t_gt * scale).astype(np.float32))
        toml = scenario_toml(os.path.join(base, "mode4_plane.toml"), tgt_ply, src_ply, 4, s,
                             scale, MSE_FACTOR * mse_true, icp_metric="plane",
                             max_wall_s=CLI_WALL_S, seed=seed)
        o, info = run_cli(chk, "7a cli mode 4 plane", toml, os.path.join(base, "mode4_plane"),
                          spies)
        rot, terr, _ = wl.pose_error(o["R"], o["t"], R_gt, t_gt * scale, S)
        extent = float(np.linalg.norm(T.max(0) - T.min(0)))
        normals = spies[1].calls
        viz = read_ply(o["viz_ply"])
        odir = os.path.dirname(o["output_toml"])
        m = o["metrics"]
        with open(os.path.join(odir, "trajectory.csv")) as f:
            rounds = int(f.read().splitlines()[-1].split(",")[0])
        info.update(n_src=o["n_src"], n_tgt=o["n_tgt"], seed=seed, mse_true=mse_true,
                    mse_threshold=MSE_FACTOR * mse_true, converged=bool(o["converged"]),
                    mse=o["mse"], rounds=rounds, nodes=o["rot_nodes"], wall_s=o["wall_s"],
                    nodes_per_s=o["rot_nodes"] / max(m.get("time_s/bnb", 0.0), 1e-9),
                    icp_iters=o["icp_iters"],
                    rot_err_deg=rot, t_err=terr, t_err_over_extent=terr / extent,
                    normals_s=[c[0] for c in normals],
                    normals_device=[str(c[2].device) for c in normals],
                    timers={k: v for k, v in m.items() if k.startswith("time_s/")})
        print("7a cli mode 4 plane: " + json.dumps(info), flush=True)
        for k in ("nearest_neighbor_mxu", "bounds_nodes", "min_d2_groups"):
            chk.expect(info["launches"][k] > 0, f"7a launched {k} {info['launches'][k]} times")
        chk.expect(o["n_src"] == N_SRC and o["n_tgt"] == N_TGT,
                   f"7a loaded {o['n_src']} / {o['n_tgt']} points (seed {seed})")
        chk.expect(len(normals) == 1 and normals[0][2].is_cuda and normals[0][2].shape == (N_TGT, 3),
                   f"7a estimated the target normals on the card in {normals[0][0] * 1e3:.2f} ms"
                   if normals else "7a estimated the target normals")
        chk.expect(rot < 0.5 and terr < 0.01 * extent,
                   f"7a pose: rotation error {rot:.4f} deg (< 0.5), translation error "
                   f"{100 * terr / extent:.3f}% of the extent (< 1%)")
        chk.expect(viz.shape[0] == o["n_src"] + o["n_tgt"],
                   f"7a viz.ply reads back {viz.shape[0]} points")
        chk.expect(all(os.path.exists(os.path.join(odir, f))
                       for f in ("trajectory.csv", "metrics.json")),
                   "7a trajectory.csv and metrics.json written")
        out["mode 4 plane"] = info

        # -- 7b: modes 1 and 2 on the whole cloud -------------------------
        runs, Rs, ts, ext_full, src_b32 = runs_7b(base)
        # point-to-point ICP stalls short of this pose (mode 1 at 0.33°,
        # mode 2 a few cells off, whose correspondences are the cells'
        # points, not the nearest ones); the plane metric reaches it, so the
        # plane runs are held to the limits and the point runs to the port's
        # CPU path on the same TOMLs (CPU_WITNESS)
        for mode, metric, toml, name in runs:
            o, info = run_cli(chk, f"7b cli {name}", toml,
                              os.path.join(base, f"mode{mode}_{metric}"), spies)
            rot, terr, rms = wl.pose_error(o["R"], o["t"], Rs, ts, src_b32)
            info.update(n_src=o["n_src"], n_tgt=o["n_tgt"], icp_iters=o["icp_iters"],
                        wall_s=o["wall_s"], mse=o["mse"], converged=bool(o["converged"]),
                        rot_err_deg=rot, t_err=terr, rms=rms, extent=ext_full)
            key = f"{n}x{n}"
            if metric == "point":
                wit = CPU_WITNESS[name]
                between = wl.pose_error(o["R"], o["t"], np.asarray(wit["R"], np.float64),
                                     np.asarray(wit["t"], np.float64), src_b32)[2]
                info.update(witness_iters=wit["icp_iters"], rms_from_witness=between)
                chk.expect(abs(int(o["icp_iters"]) - wit["icp_iters"]) <= WITNESS_ITERS
                           and between < WITNESS_RMS,
                           f"7b {name} matches the CPU path: {o['icp_iters']} iterations "
                           f"(CPU {wit['icp_iters']}, within {WITNESS_ITERS}), pose "
                           f"{between:.3g} RMS from the CPU's (< {WITNESS_RMS:g}); RMS "
                           f"{rms:.4g} from the true pose (CPU {wit['rms']:.4g})")
            if mode == 1:
                chk.expect(info["k1_launches_by_shape"].get(key, 0) > 0,
                           f"7b {name} launched K1 at {n} x {n} "
                           f"{info['k1_launches_by_shape'].get(key, 0)} times")
                if metric == "plane":
                    chk.expect(rms < 1e-3 * ext_full,
                               f"7b {name} pose: RMS displacement {rms:.3g} (< 1e-3 of the "
                               f"extent {ext_full:.4g}), rotation error {rot:.4g} deg")
            else:
                build = spies[2].calls
                g = build[-1][2]
                info.update(edt_build_s=build[-1][0], grid_n=g.n, cell=g.cell)
                chk.expect(info["launches"]["nearest_neighbor_mxu"] == 0,
                           f"7b {name} launched no K1 ({info['launches']['nearest_neighbor_mxu']})")
                chk.expect(g.n == 256 and g.values.is_cuda,
                           f"7b {name} built a {g.n}^3 EDT grid on the card in "
                           f"{build[-1][0]:.3f} s")
                if metric == "plane":
                    chk.expect(rms < g.cell,
                               f"7b {name} pose: RMS displacement {rms:.3g} (< one cell "
                               f"{g.cell:.3g}), rotation error {rot:.4g} deg")
            print(f"7b cli {name}: " + json.dumps(info), flush=True)
            out[name] = info

        # -- 7c: above mxu_max through register ---------------------------
        tgt_c = (tgt_full * scale_h).astype(np.float32)
        params, mse_c = solve_params(dev, src_h, tgt_c, R_h, t_h, 0.0, bound_backend="auto",
                                     max_wall_s=CLI_WALL_S)
        seen = {}
        orig_run = se3.GoIcpSolverSE3.run

        def run(self, *a, **k):
            seen.update(backend=self._backend, icp_backend=self._icp_backend,
                        grid_n=None if self.grid is None else self.grid.n,
                        grid_s=self.metrics.timers.get("grid_build"))
            return orig_run(self, *a, **k)

        se3.GoIcpSolverSE3.run = run
        try:
            torch.cuda.synchronize()
            fused.reset_launch_counts()
            t0 = time.perf_counter()
            res = register(src_h, tgt_c, params, device=dev)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        finally:
            se3.GoIcpSolverSE3.run = orig_run
        launches = dict(fused.launches)
        rot, terr, _ = wl.pose_error(res.transform.R, res.transform.t, R_h, t_h, src_h)
        extent = float(np.linalg.norm(tgt_c.max(0) - tgt_c.min(0)))
        timers = dict(res.metrics.timers)
        info = dict(seen, n_src=src_h.shape[0], n_tgt=tgt_c.shape[0], mse_true=mse_c,
                    mse_threshold=params.mse_threshold, rounds=res.rounds,
                    nodes=res.rot_nodes, nodes_per_s=res.rot_nodes / max(timers.get("bnb", 0), 1e-9),
                    converged=bool(res.converged), gap=res.gap, wall_s=wall,
                    rot_err_deg=rot, t_err=terr, t_err_over_extent=terr / extent,
                    icp_iters=res.icp_iters, launches=launches, timers=timers,
                    k1_launches_by_shape={f"{q}x{t}": c for (q, t), c
                                          in sorted(fused.nn_launch_shapes.items())})
        print("7c grid solve: " + json.dumps(info), flush=True)
        chk.expect(seen.get("backend") == "grid" and seen.get("icp_backend") == "grid",
                   f"7c picked {seen.get('backend')!r} bounds and {seen.get('icp_backend')!r} ICP "
                   f"for {tgt_c.shape[0]} targets (grid {seen.get('grid_n')}^3 built in "
                   f"{seen.get('grid_s') or 0:.3f} s)")
        k26 = {k: launches[k] for k in ("bounds_nodes", "min_d2_groups", "min_d2_nodes",
                                        "bounds_nodes_trimmed", "bounds_groups_trimmed")}
        chk.expect(not any(k26.values()), f"7c launched none of K2-K6 {k26}")
        chk.expect(res.rot_nodes > 0, f"7c evaluated {res.rot_nodes} nodes "
                                      f"({info['nodes_per_s']:.0f} nodes/s)")
        chk.expect(rot < 0.5 and terr < 0.01 * extent,
                   f"7c pose: rotation error {rot:.4f} deg (< 0.5), translation error "
                   f"{100 * terr / extent:.3f}% of the extent (< 1%)")
        out["grid solve"] = info
    finally:
        for sp in spies:
            sp.restore()

    out["plain stages"] = plain_stages(dev, tgt_full, src_h, out, clock_hz)

    # -- 7d: card against CPU on the grid, exact and plane paths -----------
    rng = np.random.default_rng(3)
    s = psrc[np.sort(rng.choice(psrc.shape[0], 300, replace=False))]
    t = ptgt[np.sort(rng.choice(ptgt.shape[0], 300, replace=False))]
    kw = dict(se3_pop=64, init_multistart=8, refine_top_k=2, max_rounds=30, max_wall_s=1e9)
    out["card vs cpu"] = {}
    for label, extra in (("grid", dict(bound_backend="grid", grid_resolution=64)),
                         ("exact", dict(bound_backend="exact")),
                         ("plane", dict(icp_metric="plane"))):
        params, _ = solve_params(dev, s, t, pR, pt, 0.0, **kw, **extra)
        out["card vs cpu"][label] = card_vs_cpu(chk, dev, f"7d {label}", s, t, params)
    return out


FULLCERT_WALL_S = 20.0          # 8a: BnB budget of each subset solve
TRIM_FULLCERT_WALL_S = 5.0      # 8a trimmed: BnB budget of each subset solve
CHECKPOINT_ROUNDS = 200         # 8b: rounds before the interruption
CHECKPOINT_EVERY = 25           # 8b: rounds between snapshots
NESTED_WALL_S = 30.0            # 8c: BnB budget of the nested solve
COVERAGE_TARGETS = 32768        # 8a: K1's coverage check against the largest grown subset


def pose_limits(chk, label, R, t, R_gt, t_gt, extent):
    """The pose against the truth: within 0.5° and 1 % of the extent."""
    cos = np.clip((np.trace(np.asarray(R).T @ R_gt) - 1.0) / 2.0, -1.0, 1.0)
    rot_err = float(np.degrees(np.arccos(cos)))
    t_err = float(np.linalg.norm(np.asarray(t) - t_gt))
    chk.expect(rot_err < 0.5 and t_err < 0.01 * extent,
               f"{label} pose: rotation error {rot_err:.4f} deg (< 0.5), translation error "
               f"{t_err:.3g} = {100 * t_err / extent:.3f}% of the extent (< 1%)")
    return rot_err, t_err


def check_k1_coverage(chk, dev, full, n_sub, clock_hz):
    """K1 at the full-cloud certificate's coverage query: the whole source
    (40,256 queries) against ``n_sub`` of its own points (the ring route),
    so every subset point ties with itself at d² = 0; tol 0."""
    import torch

    from goicp_tpu_torch.nn import fused
    from goicp_tpu_torch.nn.brute import nearest_neighbor

    idx = np.sort(np.random.default_rng(777).choice(full.shape[0], n_sub, replace=False))
    Q = torch.as_tensor(full, device=dev)
    T = Q[torch.as_tensor(idx, device=dev)].contiguous()
    d2, nn = fused.nearest_neighbor_mxu(Q, T)
    torch.cuda.synchronize()
    d2_p, nn_p = nearest_neighbor(Q, T)
    err = float((d2 - d2_p).abs().max())
    chk.expect(bool(torch.equal(nn, nn_p)) and bool(torch.equal(d2, d2_p))
               and bool((d2[torch.as_tensor(idx, device=dev)] == 0).all()),
               f"K1 coverage {full.shape[0]} x {n_sub}: indices equal, max |d2 err| {err:.3g}, "
               f"every subset point its own nearest (tol 0: bit-equal)")
    t4 = fused.pack_nn_targets(T)
    ms = device_ms(lambda: fused.nearest_neighbor_mxu(Q, T, packed=t4), 10, clock_hz)
    plain = timed_ms(lambda: nearest_neighbor(Q, T), 2)
    lib = library_min_ms(Q, T)
    nq, nt = Q.shape[0], T.shape[0]
    b, by = bound_ms(4.0 * (3 * nq + 3 * nt + 2 * nq), 7.0 * nq * nt, clock_hz)
    route = fused.nn_route(nq, t4.shape[0], fused._sm_count(Q.device.index))
    rec = _rec(f"K1 coverage nearest_neighbor_mxu (full-cloud certificate's coverage order), "
               f"{nq} queries x {nt} targets", "goicp_tpu_torch/csrc/nn_min_d2.cu",
               "goicp_tpu/nn/mxu.py:152", err, ms, plain, b, by, lib,
               f"{nq} queries x {nt} targets", library_call="torch.cdist + amin",
               shape_key=[nq, nt], launch_route=dict(splits=route[0], queries_per_thread=route[1],
                                                      targets_resident=False),
               timing="device time per call (device_ms), targets packed once")
    report("K1 coverage", rec)
    return rec


def fullcert_phase(chk, dev, src, tgt, R_gt, t_gt, scale, psrc, ptgt, pR, pt, headline,
                   clock_hz):
    """Phase 8: full-cloud certification, checkpoint/resume and the nested
    engine.  8a ``register_full_cert`` on the whole bunny source against the
    headline's target; 8b the headline solve interrupted by ``max_rounds``
    and resumed from its snapshot; 8c the headline pair on the nested
    engine; 8d card against CPU on 5b's 300-point subsets.  Returns the
    records and the K1 coverage row."""
    import torch

    extent = float(np.linalg.norm(tgt.max(0) - tgt.min(0)))
    full = (bunny_full()[1] * scale).astype(np.float32)             # Rᵀ(target − t), 40,256
    out = {"K1 coverage": check_k1_coverage(chk, dev, full, COVERAGE_TARGETS, clock_hz)}
    # K2 and K3 at the largest grown subset (the whole source), at the node
    # batch and group count of se3_pop's auto rule there (bnb/se3.py)
    pop = max(64, min(4096, int(32e6 / (8 * full.shape[0]))))
    rng = np.random.default_rng(8)
    S_full, T = torch.as_tensor(full, device=dev), torch.as_tensor(tgt, device=dev)
    tag = " at the full cert's whole source"
    out["K3 full cert"] = check_k3(chk, dev, S_full, T, rng, clock_hz, pop, tag)
    report("K3 full cert", out["K3 full cert"])
    out["K2 full cert"] = check_k2(chk, dev, S_full, T, rng, clock_hz, 8 * pop, tag)
    out["K5 full cert"] = check_k5(chk, dev, S_full, T, rng, clock_hz, 8 * pop,
                                   int(round(full.shape[0] * (1.0 - TRIM))), tag)
    # its row counts 8a's launches at this shape only (Np, nodes), not those
    # at the first subset's
    out["K5 full cert"]["k5_shape_key"] = [full.shape[0] + (-full.shape[0]) % 128, 8 * pop]
    out["full cert"] = phase_8a(chk, dev, full, tgt, R_gt, t_gt, extent)
    out["trimmed screen full cert"] = phase_8a_trimmed(chk, dev, full, tgt, R_gt, t_gt, extent)
    out["checkpoint"] = phase_8b(chk, dev, src, tgt, R_gt, t_gt, headline)
    out["nested"] = phase_8c(chk, dev, src, tgt, R_gt, t_gt, extent)
    out["card vs cpu"] = phase_8d(chk, dev, psrc, ptgt, pR, pt)
    return out


def record_subset_solves(fullcert, solves, label):
    """Wrap ``fullcert.make_solver`` so that each subset solve of a full
    cert appends its subset size, wall, rounds, nodes, nodes/s and gaps to
    ``solves``; returns the original, which the caller puts back."""
    import torch

    orig = fullcert.make_solver

    def recording(*a, **k):
        s = orig(*a, **k)
        run = s.run

        def timed_run(*x):
            t0 = time.perf_counter()
            r = run(*x)
            torch.cuda.synchronize()
            bnb = r.metrics.timers.get("bnb", 0.0)
            solves.append(dict(subset=s.src.shape[0], wall_s=time.perf_counter() - t0,
                               rounds=r.rounds, nodes=r.rot_nodes,
                               nodes_per_s=r.rot_nodes / max(bnb, 1e-9), gap=r.gap,
                               gap_full=r.gap_full, converged=bool(r.converged)))
            print(f"{label}: " + json.dumps(solves[-1]), flush=True)
            return r

        s.run = timed_run
        return s

    fullcert.make_solver = recording
    return orig


def phase_8a(chk, dev, full, tgt, R_gt, t_gt, extent):
    """8a: ``register_full_cert`` on the whole source at full width."""
    import torch

    from goicp_tpu_torch import BnbParams, make_solver
    from goicp_tpu_torch.bnb import fullcert
    from goicp_tpu_torch.nn import fused

    mse_true = wl.mse_at_truth(dev, full, tgt, R_gt, t_gt)
    params = BnbParams(mse_threshold=MSE_FACTOR * mse_true, max_wall_s=FULLCERT_WALL_S)
    idx0 = np.sort(np.random.default_rng(777).choice(full.shape[0], params.bound_points,
                                                     replace=False))
    n_grow = params.bound_points
    grown = {}
    for key, d in (("card", dev), ("cpu", torch.device("cpu"))):
        order = fullcert._coverage_order(full, full[idx0], d)
        mask = np.zeros(full.shape[0], bool)
        mask[idx0] = True
        grown[key] = np.sort(np.concatenate([idx0, order[~mask[order]][:n_grow]]))
    chk.expect(np.array_equal(grown["card"], grown["cpu"]),
               f"8a the first grown subset ({grown['card'].shape[0]} points) is the same on "
               "the card and on the CPU path")
    print(f"8a: {full.shape[0]} source / {tgt.shape[0]} target points, mse at the true pose "
          f"{mse_true:.6g}, mse_threshold {params.mse_threshold:.6g}", flush=True)
    solves = []
    orig = record_subset_solves(fullcert, solves, "8a refinement")
    try:
        torch.cuda.synchronize()
        fused.reset_launch_counts()
        t0 = time.perf_counter()
        res = fullcert.register_full_cert(full, tgt, params, max_refinements=3, device=dev)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    finally:
        fullcert.make_solver = orig
    launches = dict(fused.launches)
    shapes = {f"{q}x{t}": n for (q, t), n in sorted(fused.nn_launch_shapes.items())}
    R, t = np.asarray(res.transform.R), np.asarray(res.transform.t)
    sse_cpu = make_solver(full, tgt, params, device="cpu").score_full(R, t)
    rot_err, t_err = pose_limits(chk, "8a full cert", R, t, R_gt, t_gt, extent)
    out = dict(
        wall_s=wall, refinements=solves, subset_sizes=[x["subset"] for x in solves],
        gap_full=res.gap_full, sse_full=res.sse_full, sse_full_cpu=sse_cpu, sse=res.sse,
        converged=bool(res.converged), rot_err_deg=rot_err, t_err=t_err, launches=launches,
        k1_launches_by_shape=shapes, mse_true=mse_true, mse_threshold=params.mse_threshold)
    print("8a: " + json.dumps({k: out[k] for k in (
        "wall_s", "subset_sizes", "gap_full", "sse_full", "sse_full_cpu", "launches")}), flush=True)
    for k in ("nearest_neighbor_mxu", "bounds_nodes", "min_d2_groups"):
        chk.expect(launches[k] > 0, f"8a launched {k} {launches[k]} times")
    plan = fullcert._subset_sizes(params.bound_points, full.shape[0], 2.0, 3)
    met = res.gap_full is not None and res.gap_full <= params.mse_threshold * full.shape[0]
    chk.expect([x["subset"] for x in solves] == plan[:len(solves)]
               and (len(solves) == len(plan) or met),
               f"8a subsets {[x['subset'] for x in solves]} of the plan {plan} (all of it, "
               f"unless the target is met early: {met})")
    chk.expect(res.gap_full is not None and res.gap_full >= 0.0,
               f"8a gap_full {res.gap_full} reported and >= 0")
    chk.expect(res.sse_full is not None and abs(res.sse_full - sse_cpu) <= 1e-5 * abs(sse_cpu),
               f"8a sse_full {res.sse_full} vs the CPU path's score {sse_cpu} (rtol 1e-5)")
    return out


def phase_8a_trimmed(chk, dev, full, tgt, R_gt, t_gt, extent):
    """8a, trimmed: ``register_full_cert`` with trim 0.25 on
    ``bound_backend="screen"``, TRIM_FULLCERT_WALL_S a solve.  Its subsets
    start at twice the full drop count (20,128 points) and grow to the whole
    source (K5 at Np = 40,320, 315 KB of scratch a warp)."""
    import collections

    import torch

    from goicp_tpu_torch import BnbParams
    from goicp_tpu_torch.bnb import fullcert
    from goicp_tpu_torch.nn import fused

    N = full.shape[0]
    mse_true = wl.mse_at_truth(dev, full, tgt, R_gt, t_gt, TRIM)
    params = BnbParams(mse_threshold=MSE_FACTOR * mse_true, max_wall_s=TRIM_FULLCERT_WALL_S,
                       trim_fraction=TRIM, bound_backend="screen")
    drop = N - int(round(N * (1.0 - TRIM)))
    plan = fullcert._subset_sizes(min(N, max(params.bound_points, 2 * drop)), N, 2.0, 3)
    print(f"8a trimmed: {N} source / {tgt.shape[0]} target points, trim {TRIM}, screen, "
          f"mse at the true pose {mse_true:.6g}, subsets planned {plan}", flush=True)
    k5_np = collections.Counter()
    k5 = fused._k5_kernel

    def spy(srcT_ext, wm, params_, *a, **k):
        k5_np[(srcT_ext.shape[1], params_.shape[0])] += 1
        return k5(srcT_ext, wm, params_, *a, **k)

    solves = []
    orig = record_subset_solves(fullcert, solves, "8a trimmed refinement")
    fused._k5_kernel = spy
    try:
        torch.cuda.synchronize()
        fused.reset_launch_counts()
        t0 = time.perf_counter()
        res = fullcert.register_full_cert(full, tgt, params, max_refinements=3, device=dev)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    finally:
        fullcert.make_solver = orig
        fused._k5_kernel = k5
    launches = dict(fused.launches)
    shapes = {f"{q}x{t}": n for (q, t), n in sorted(fused.nn_launch_shapes.items())}
    Np_full = N + (-N) % 128
    Mp = tgt.shape[0] + (-tgt.shape[0]) % 128
    at_full = {f"{b} nodes": n for (np_, b), n in sorted(k5_np.items()) if np_ == Np_full}
    plans = {b: fused.k5_plan(b, Np_full, Mp) for (np_, b) in k5_np if np_ == Np_full}
    R, t = np.asarray(res.transform.R), np.asarray(res.transform.t)
    rot_err, t_err = pose_limits(chk, "8a trimmed full cert", R, t, R_gt, t_gt, extent)
    out = dict(wall_s=wall, refinements=solves, subset_sizes=[x["subset"] for x in solves],
               plan=plan, gap_full=res.gap_full, sse_full=res.sse_full,
               converged=bool(res.converged), rot_err_deg=rot_err, t_err=t_err,
               launches=launches, k1_launches_by_shape=shapes,
               k5_launches_by_np={f"{np_}x{b}": n for (np_, b), n
                                                     in sorted(k5_np.items())},
               k5_plans_at_whole_source={str(b): p for b, p in plans.items()},
               mse_true=mse_true, mse_threshold=params.mse_threshold)
    print("8a trimmed: " + json.dumps({k: out[k] for k in (
        "wall_s", "subset_sizes", "gap_full", "sse_full", "launches",
        "k5_launches_by_np")}), flush=True)
    for k in ("nearest_neighbor_mxu", "bounds_nodes_trimmed", "bounds_groups_trimmed"):
        chk.expect(launches[k] > 0, f"8a trimmed launched {k} {launches[k]} times")
    chk.expect(out["subset_sizes"] == plan and plan[-1] == N,
               f"8a trimmed subsets {out['subset_sizes']}: the plan {plan}, up to the whole "
               f"source")
    chk.expect(bool(at_full), f"8a trimmed: K5 ran at the whole source (Np {Np_full}) {at_full}, "
                              f"plans {plans}")
    chk.expect(res.gap_full is not None and res.gap_full >= 0.0,
               f"8a trimmed gap_full {res.gap_full} reported and >= 0")
    return out


def phase_8b(chk, dev, src, tgt, R_gt, t_gt, headline):
    """8b: the headline solve interrupted at ``CHECKPOINT_ROUNDS`` and
    resumed from two of its snapshots: the first one written at that round,
    while rounds were still queued (their popped parents re-included, their
    children off the count), and the last one, written after the queue
    drained."""
    import dataclasses
    import shutil

    from goicp_tpu_torch import BnbParams, register
    from goicp_tpu_torch.bnb import se3
    from goicp_tpu_torch.nn import fused

    ck = os.path.join(OUT_DIR, "checkpoint_8b.npz")
    ck_q = os.path.join(OUT_DIR, "checkpoint_8b_inflight.npz")
    for f in (ck, ck_q):
        if os.path.exists(f):
            os.remove(f)
    p1, _ = solve_params(dev, src, tgt, R_gt, t_gt, max_rounds=CHECKPOINT_ROUNDS,
                         checkpoint_path=ck, checkpoint_every=CHECKPOINT_EVERY)
    queued = []
    snapshot, save = se3.inflight_snapshot, se3.save_checkpoint

    def counting(drv, inflight, nodes):
        queued.append(sum(w["parents"][0].shape[0] for w in inflight))
        return snapshot(drv, inflight, nodes)

    def keeping(path, *a):
        save(path, *a)
        if queued[-1] and a[-2] == CHECKPOINT_ROUNDS and not os.path.exists(ck_q):
            shutil.copy(path, ck_q)

    se3.inflight_snapshot, se3.save_checkpoint = counting, keeping
    try:
        t0 = time.perf_counter()
        r1 = register(src, tgt, p1, device=dev)
        w1 = time.perf_counter() - t0
    finally:
        se3.inflight_snapshot, se3.save_checkpoint = snapshot, save
    chk.expect(not r1.converged and r1.rounds == CHECKPOINT_ROUNDS and os.path.exists(ck_q),
               f"8b interrupted at round {r1.rounds} (max_rounds {CHECKPOINT_ROUNDS}); "
               f"snapshots with queued parents: {sum(1 for q in queued if q)} of {len(queued)}")
    out = dict(interrupted=dict(rounds=r1.rounds, nodes=r1.rot_nodes,
                                converged=bool(r1.converged), wall_s=w1),
               headline_nodes=headline["nodes"])
    for label, path in (("in flight", ck_q), ("drained", ck)):
        if not os.path.exists(path):
            continue
        snap = dict(np.load(path))
        mine = path[:-4] + "_resumed.npz"
        shutil.copy(path, mine)
        fused.reset_launch_counts()
        t0 = time.perf_counter()
        r2 = register(src, tgt, dataclasses.replace(p1, max_rounds=BnbParams().max_rounds,
                                                     checkpoint_path=mine), device=dev)
        w2 = time.perf_counter() - t0
        dR = float(np.abs(np.asarray(r2.transform.R) - headline["R"]).max())
        dt = float(np.abs(np.asarray(r2.transform.t) - headline["t"]).max())
        out[label] = dict(
            snapshot=dict(rounds=int(snap["rounds"]), nodes=int(snap["nodes"]),
                          frontier=int(snap["lb"].shape[0])),
            resumed=dict(rounds=r2.rounds, nodes=r2.rot_nodes, converged=bool(r2.converged),
                         gap=r2.gap, wall_s=w2, launches=dict(fused.launches)),
            dR=dR, dt=dt)
        chk.expect(r2.converged and r2.gap == 0.0 and dR < 1e-4 and dt < 1e-4,
                   f"8b resumed from the {label} snapshot of round {int(snap['rounds'])} "
                   f"({int(snap['nodes'])} nodes, {int(snap['lb'].shape[0])} in its frontier): "
                   f"converged {r2.converged}, gap {r2.gap}, pose within {max(dR, dt):.3g} of "
                   f"phase 4's (< 1e-4); nodes {r2.rot_nodes} against the uninterrupted "
                   f"{headline['nodes']}")
    print("8b: " + json.dumps(out), flush=True)
    return out


def phase_8c(chk, dev, src, tgt, R_gt, t_gt, extent):
    """8c: the headline pair on the nested engine."""
    import torch

    from goicp_tpu_torch import register
    from goicp_tpu_torch.nn import fused

    pn, _ = solve_params(dev, src, tgt, R_gt, t_gt, engine="nested", max_wall_s=NESTED_WALL_S)
    torch.cuda.synchronize()
    fused.reset_launch_counts()
    t0 = time.perf_counter()
    rn = register(src, tgt, pn, device=dev)
    torch.cuda.synchronize()
    wn = time.perf_counter() - t0
    ln = dict(fused.launches)
    bnb = rn.metrics.timers.get("bnb", 0.0)
    rot_err, t_err = pose_limits(chk, "8c nested", rn.transform.R, rn.transform.t, R_gt, t_gt,
                                 extent)
    out = dict(rounds=rn.rounds, rot_nodes=rn.rot_nodes, trans_nodes=rn.trans_nodes,
                         trans_nodes_per_s=rn.trans_nodes / max(bnb, 1e-9),
                         rot_nodes_per_s=rn.rot_nodes / max(bnb, 1e-9), bnb_s=bnb, wall_s=wn,
                         converged=bool(rn.converged), gap=rn.gap, launches=ln,
                         rot_err_deg=rot_err, t_err=t_err)
    print("8c: " + json.dumps(out), flush=True)
    chk.expect(ln["nearest_neighbor_mxu"] > 0 and rn.rounds > 0,
               f"8c launched nearest_neighbor_mxu {ln['nearest_neighbor_mxu']} times in "
               f"{rn.rounds} rounds")
    chk.expect(all(v == 0 for k, v in ln.items() if k != "nearest_neighbor_mxu"),
               f"8c launched no K2-K7: {ln}")
    return out


def phase_8d(chk, dev, psrc, ptgt, pR, pt):
    """8d: card against CPU on 5b's 300-point subsets: full certs untrimmed
    and trimmed, a nested solve, a snapshot resumed on both."""
    import dataclasses

    from goicp_tpu_torch import register
    from goicp_tpu_torch.bnb import fullcert

    rng = np.random.default_rng(3)
    s = psrc[np.sort(rng.choice(psrc.shape[0], 300, replace=False))]
    t = ptgt[np.sort(rng.choice(ptgt.shape[0], 300, replace=False))]
    kw = dict(se3_pop=64, init_multistart=8, refine_top_k=2, max_wall_s=1e9)
    out = {}
    for label, trim in (("full cert", 0.0), ("trimmed full cert", 0.25)):
        params, _ = solve_params(dev, s, t, pR, pt, trim, bound_points=100, max_rounds=10, **kw)
        rg = fullcert.register_full_cert(s, t, params, max_refinements=3, device=dev)
        rc = fullcert.register_full_cert(s, t, params, max_refinements=3, device="cpu")
        same = [rg.metrics.counters[k] == rc.metrics.counters[k]
                for k in ("fullcert_subset", "fullcert_refinements")]
        ok = (all(same) and rg.rounds == rc.rounds and rg.rot_nodes == rc.rot_nodes
              and abs(rg.gap_full - rc.gap_full) <= 1e-5 * abs(rc.gap_full))
        chk.expect(ok, f"8d {label} card vs CPU: subset {rg.metrics.counters['fullcert_subset']}"
                       f" vs {rc.metrics.counters['fullcert_subset']}, rounds {rg.rounds} vs "
                       f"{rc.rounds}, nodes {rg.rot_nodes} vs {rc.rot_nodes}, gap_full "
                       f"{rg.gap_full:.7g} vs {rc.gap_full:.7g}")
        out[label] = dict(subset=rg.metrics.counters["fullcert_subset"],
                                         rounds=rg.rounds, nodes_gpu=rg.rot_nodes,
                                         nodes_cpu=rc.rot_nodes, gap_full_gpu=rg.gap_full,
                                         gap_full_cpu=rc.gap_full)
    params, _ = solve_params(dev, s, t, pR, pt, 0.0, engine="nested", rot_pop=4, inner_cap=16,
                             inner_levels=5, max_rounds=5, init_multistart=8, refine_top_k=2,
                             max_wall_s=1e9)
    rg, rc = register(s, t, params, device=dev), register(s, t, params, device="cpu")
    chk.expect((rg.rounds, rg.rot_nodes, rg.trans_nodes) == (rc.rounds, rc.rot_nodes,
                                                             rc.trans_nodes),
               f"8d nested card vs CPU: rounds {rg.rounds} vs {rc.rounds}, rot nodes "
               f"{rg.rot_nodes} vs {rc.rot_nodes}, trans nodes {rg.trans_nodes} vs "
               f"{rc.trans_nodes}")
    out["nested"] = dict(rounds=rg.rounds, rot_nodes=[rg.rot_nodes, rc.rot_nodes],
                                        trans_nodes=[rg.trans_nodes, rc.trans_nodes])
    ck = os.path.join(OUT_DIR, "checkpoint_8d.npz")
    if os.path.exists(ck):
        os.remove(ck)
    params, _ = solve_params(dev, s, t, pR, pt, 0.0, checkpoint_path=ck, checkpoint_every=5,
                             max_rounds=10, **kw)
    register(s, t, params, device=dev)
    resumed = {}
    for d in ("cuda", "cpu"):
        mine = os.path.join(OUT_DIR, f"checkpoint_8d_{d}.npz")
        with open(ck, "rb") as f_in, open(mine, "wb") as f_out:
            f_out.write(f_in.read())
        r = register(s, t, dataclasses.replace(params, checkpoint_path=mine, max_rounds=20),
                     device=dev if d == "cuda" else d)
        resumed[d] = (r.rounds, r.rot_nodes)
    chk.expect(resumed["cuda"] == resumed["cpu"],
               f"8d snapshot written on the card, resumed on the card and on the CPU: "
               f"(rounds, nodes) {resumed['cuda']} vs {resumed['cpu']}")
    out["resume"] = resumed
    return out


LOCKSTEP_PAIRS = 4              # 9a: pairs in the lockstep batch
LOCKSTEP_WALL_S = 30.0          # 9a: BnB budget of the lockstep
LOCKSTEP_BREAKDOWN_S = 10.0     # 9a: BnB budget of the synchronised rerun (the breakdown)
SERVE_WALL_S = 10.0             # 9b: BnB budget of each service query
SERVE_QUERY_N = 1000            # 9b: points in each service query (a target subset)
SERVE_SOLO_WALL_S = 5.0         # 9b: BnB budget of the query on the single-pair solver
AGREE_ROUNDS = 15               # 9c: rounds of the card-vs-CPU lockstep solves


def lockstep_pairs(src, tgt, R_gt, n_pairs, seed):
    """``n_pairs`` pairs of the source rotated by seeded random rotations
    Q_i, each against the one target array (the serving shape), and their
    ground truths (R_gt Q_iᵀ, t)."""
    from goicp_tpu_torch.geo.rotation import random_rotations

    Qs = random_rotations(n_pairs, np.random.default_rng(seed))
    pairs = [((src @ Q.T).astype(np.float32), tgt) for Q in Qs]
    return pairs, [(R_gt @ Q.T).astype(np.float32) for Q in Qs]


def check_lockstep_kernels(chk, dev, S, T, rng, clock_hz, P, k, B):
    """K4 at one pair's lockstep round (``B`` nodes, the source's 1,536-point
    pack, the headline's targets) and K1 at the lockstep refine (``P`` pairs
    × ``k`` poses × the source against the shared target), each against its
    plain version (tol 0), with kernel, plain, library and bound times."""
    import torch

    from goicp_tpu_torch.geo.rotation import axis_angle_rotation
    from goicp_tpu_torch.nn import fused
    from goicp_tpu_torch.nn.brute import nearest_neighbor

    rec4 = check_k4(chk, dev, S, T, rng, clock_hz, B)
    rec4.update(name=f"K4 lockstep min_d2_nodes, one pair's round: {B} nodes x "
                     f"{S.shape[0]} points x {T.shape[0]} targets",
                replaces="goicp_tpu/nn/mxu.py:176 (via min_d2_nodes :361, "
                         "multipair_lockstep.py:113-116)")
    N, NT = S.shape[0], T.shape[0]
    Rp = axis_angle_rotation(torch.as_tensor(
        rng.uniform(-0.2, 0.2, (P * k, 3)).astype(np.float32), device=dev))
    tp = torch.as_tensor(rng.uniform(-0.02, 0.02, (P * k, 3)).astype(np.float32), device=dev)
    Q = (S[None] @ Rp.transpose(1, 2) + tp[:, None]).reshape(-1, 3).contiguous()
    t4 = fused.pack_nn_targets(T)
    d2, idx = fused.nearest_neighbor_mxu(Q, T, packed=t4)
    torch.cuda.synchronize()
    d2_p, idx_p = nearest_neighbor(Q, T)
    err = float((d2 - d2_p).abs().max())
    chk.expect(bool(torch.equal(idx, idx_p)) and bool(torch.equal(d2, d2_p)),
               f"K1 lockstep {P}x{k}x{N} queries x {NT} targets: indices equal, max |d2 err| "
               f"{err:.3g} (tol 0: bit-equal)")
    ms = device_ms(lambda: fused.nearest_neighbor_mxu(Q, T, packed=t4), 100, clock_hz)
    plain = device_ms(lambda: nearest_neighbor(Q, T), 5, clock_hz)
    lib = device_ms(lambda: torch.cdist(Q, T).min(dim=1), 20, clock_hz)
    nq = Q.shape[0]
    b, by = bound_ms(4.0 * (3 * nq + 3 * NT + 2 * nq), 7.0 * nq * NT, clock_hz)
    route = fused.nn_route(nq, t4.shape[0], fused._sm_count(Q.device.index))
    rec1 = _rec(f"K1 lockstep nearest_neighbor_mxu (the lockstep refine), {P} pairs x {k} poses "
                f"x {N} queries x {NT} targets", "goicp_tpu_torch/csrc/nn_min_d2.cu",
                "goicp_tpu/nn/mxu.py:152", err, ms, plain, b, by, lib,
                f"{nq} queries x {NT} targets", library_call="torch.cdist + min (two calls)",
                shape_key=[nq, NT], launch_route=dict(splits=route[0], queries_per_thread=route[1],
                                                      targets_resident=t4.shape[0] <= K1_RESIDENT_MAX),
                timing="device time per call (device_ms), targets packed once")
    report("K4 lockstep", rec4)
    report("K1 lockstep", rec1)
    return rec4, rec1


def phase_9a(chk, dev, src, tgt, R_gt, t_gt, solo):
    """9a: ``register_pairs`` on LOCKSTEP_PAIRS rotated copies of the
    headline source against the one headline target, default ``BnbParams``
    with phase 4's ``mse_threshold`` and a LOCKSTEP_WALL_S budget.  K4 and K1
    must launch, K2 and K3 must not; every pose within the limits; the
    lockstep's nodes/s beside phase 4's solo rate."""
    import torch

    from goicp_tpu_torch import register_pairs
    from goicp_tpu_torch.nn import fused

    pairs, R_gts = lockstep_pairs(src, tgt, R_gt, LOCKSTEP_PAIRS, 91)
    params, mse_true = solve_params(dev, src, tgt, R_gt, t_gt, max_wall_s=LOCKSTEP_WALL_S)
    extent = float(np.linalg.norm(tgt.max(0) - tgt.min(0)))
    torch.cuda.synchronize()
    fused.reset_launch_counts()
    t0 = time.perf_counter()
    res = register_pairs(pairs, params, device=dev)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(fused.launches)
    per_pair = []
    for b, (r, Rg) in enumerate(zip(res, R_gts)):
        rot_err, t_err = pose_limits(chk, f"9a pair {b}", r.transform.R, r.transform.t, Rg,
                                     t_gt, extent)
        per_pair.append(dict(rounds=r.rounds, nodes=r.rot_nodes,
                             nodes_per_s=r.rot_nodes / r.wall_s, gap=r.gap,
                             converged=bool(r.converged), mse=r.mse, icp_iters=r.icp_iters,
                             rot_err_deg=rot_err, t_err_over_extent=t_err / extent))
    nodes = sum(r.rot_nodes for r in res)
    info = dict(pairs=len(pairs), mse_threshold=params.mse_threshold, mse_true=mse_true,
                max_wall_s=params.max_wall_s, wall_s=wall, lockstep_wall_s=res[0].wall_s,
                rounds=res[0].rounds, nodes=nodes, nodes_per_s=nodes / res[0].wall_s,
                per_pair=per_pair, solo_nodes_per_s=solo["nodes_per_s"],
                per_pair_over_solo=[q["nodes_per_s"] / solo["nodes_per_s"] for q in per_pair],
                all_pairs_over_solo=nodes / res[0].wall_s / solo["nodes_per_s"],
                launches=launches,
                k1_launches_by_shape={f"{q}x{t}": n
                                      for (q, t), n in sorted(fused.nn_launch_shapes.items())})
    print("9a lockstep: " + json.dumps({k: info[k] for k in (
        "wall_s", "rounds", "nodes", "nodes_per_s", "solo_nodes_per_s", "all_pairs_over_solo",
        "per_pair", "launches")}), flush=True)
    for k in ("min_d2_nodes", "nearest_neighbor_mxu"):
        chk.expect(launches[k] > 0, f"9a lockstep launched {k} {launches[k]} times")
    for k in ("bounds_nodes", "min_d2_groups"):
        chk.expect(launches[k] == 0, f"9a lockstep launched {k} {launches[k]} times (none)")
    info["breakdown"] = lockstep_breakdown(dev, pairs, params)
    return info


def lockstep_breakdown(dev, pairs, params):
    """9a once more on a LOCKSTEP_BREAKDOWN_S budget, the card synchronised
    around each round's bounds (``_pairs_bounds``: K4 and the epilogue of
    every live pair) and refine (``_pairs_refine``: the batched ICP): their
    wall per round and share of the lockstep's wall; the rest is the host's
    (pops, expansion, absorption) and the multistart."""
    import dataclasses

    from goicp_tpu_torch import multipair_lockstep as ml
    from goicp_tpu_torch import register_pairs
    from goicp_tpu_torch.nn import fused

    spies = {k: Spy(ml, k) for k in ("_pairs_bounds", "_pairs_refine")}
    fused.reset_launch_counts()
    try:
        res = register_pairs(pairs, dataclasses.replace(params, max_wall_s=LOCKSTEP_BREAKDOWN_S),
                             device=dev)
    finally:
        for spy in spies.values():
            spy.restore()
    wall, rounds = res[0].wall_s, res[0].rounds
    out = dict(max_wall_s=LOCKSTEP_BREAKDOWN_S, wall_s=wall, rounds=rounds,
               k1_launches_per_round=fused.launches["nearest_neighbor_mxu"] / max(rounds, 1))
    for k, spy in spies.items():
        tot = sum(c[0] for c in spy.calls)
        out[k] = dict(calls=len(spy.calls), s=tot, ms_per_round=1e3 * tot / max(rounds, 1),
                      share=tot / wall)
    out["rest_share"] = 1.0 - sum(out[k]["share"] for k in spies)
    print("9a breakdown: " + json.dumps(out), flush=True)
    return out


def _tcp_session(service, token, lines_by_client, window_s):
    """``serve_tcp`` on 127.0.0.1 with ``token``: one client without the
    handshake (refused), then one authenticated client per entry of
    ``lines_by_client``, all sending at once after the handshake, then a
    shutdown.  Returns (the refusal, each client's answers, the Batcher)."""
    import socket
    import threading

    from goicp_tpu_torch.serving.tcp import serve_tcp

    ready, bound, out = threading.Event(), [], {}
    srv = threading.Thread(target=lambda: out.setdefault("batcher", serve_tcp(
        service, port=0, max_batch=len(lines_by_client), window_s=window_s, ready=ready,
        bound=bound, auth_token=token)), daemon=True)
    srv.start()
    if not ready.wait(60):
        raise RuntimeError("serve_tcp did not start")

    def conn():
        s = socket.create_connection(("127.0.0.1", bound[0]), timeout=600)
        return s, s.makefile("rw")

    s, f = conn()
    f.write(json.dumps({"id": "no-auth", "cmd": "info"}) + "\n")
    f.flush()
    refused = json.loads(f.readline())
    refused["closed"] = f.readline() == ""
    s.close()
    go = threading.Barrier(len(lines_by_client))
    answers = [None] * len(lines_by_client)

    def client(i):
        s, f = conn()
        f.write(json.dumps({"auth": token}) + "\n")
        f.flush()
        json.loads(f.readline())
        go.wait()
        got = []
        for line in lines_by_client[i]:
            f.write(json.dumps(line) + "\n")
            f.flush()
            got.append(json.loads(f.readline()))
        answers[i] = got
        s.close()

    threads = [threading.Thread(target=client, args=(i,)) for i in range(len(lines_by_client))]
    for th in threads:
        th.start()
    for th in threads:
        th.join(600)
    s, f = conn()
    f.write(json.dumps({"auth": token}) + "\n")
    f.write(json.dumps({"cmd": "shutdown"}) + "\n")
    f.flush()
    f.readline()
    f.readline()
    s.close()
    srv.join(60)
    return refused, answers, out.get("batcher")


def phase_9b(chk, dev, tgt):
    """9b: a ``RegistrationService`` on the headline target, driven through
    ``serve_stdio`` (a goicp batch, an icp tracking query, an escalation,
    ``info``) and ``serve_tcp`` (a refused client without the token, then
    four authenticated clients whose goicp queries must land in one
    Batcher batch, and a tracking query each; then a lone query on the
    single-pair solver, run from the Batcher's thread).  Queries are
    rigidly moved SERVE_QUERY_N-point subsets of the target; every
    answer's pose within the limits."""
    import io

    import torch

    from goicp_tpu_torch import BnbParams
    from goicp_tpu_torch.geo.rotation import axis_angle_rotation, random_rotations
    from goicp_tpu_torch.nn import fused
    from goicp_tpu_torch.serve import RegistrationService, serve_stdio

    rng = np.random.default_rng(92)
    extent = float(np.linalg.norm(tgt.max(0) - tgt.min(0)))
    t0 = time.perf_counter()
    svc = RegistrationService(tgt, BnbParams(mse_threshold=1e-5, max_wall_s=SERVE_WALL_S),
                              name="bunny", device=dev)
    build_s = time.perf_counter() - t0

    def query(i):
        Q = random_rotations(1, np.random.default_rng(900 + i))[0]
        t = (rng.random(3).astype(np.float32) - 0.5) * 0.3
        idx = np.sort(rng.choice(tgt.shape[0], SERVE_QUERY_N, replace=False))
        return ((tgt[idx] - t) @ Q).astype(np.float32), Q, t

    def near(Q, t):
        dR = axis_angle_rotation(torch.as_tensor(rng.normal(0, 0.03, 3).astype(np.float32))).numpy()
        return {"R": (dR @ Q).tolist(), "t": (t + 0.01).tolist()}

    qs = [query(i) for i in range(6)]
    checks = []

    def hold(label, resp, Q, t, escalated=None):
        ok = bool(resp.get("ok"))
        chk.expect(ok, f"9b {label}: answered ok ({resp.get('error', '')})")
        if ok:
            pose_limits(chk, f"9b {label}", np.asarray(resp["R"], np.float32),
                        np.asarray(resp["t"], np.float32), Q, t, extent)
            checks.append(dict(label=label, nodes=resp["nodes"], icp_iters=resp["icp_iters"],
                               converged=resp["converged"], wall_s=resp["wall_s"],
                               escalated=resp.get("escalated", False)))
        if escalated is not None:
            chk.expect(resp.get("escalated", False) == escalated,
                       f"9b {label}: escalated {resp.get('escalated', False)} ({escalated})")

    torch.cuda.synchronize()
    fused.reset_launch_counts()
    lines = [
        {"batch": [{"id": f"g{i}", "points": qs[i][0].tolist()} for i in range(3)]},
        {"id": "track", "points": qs[3][0].tolist(), "mode": "icp", "init": near(*qs[3][1:])},
        {"id": "lost", "points": qs[4][0].tolist(), "mode": "icp",
         "init": {"R": np.eye(3).tolist(), "t": [0.0, 0.0, 0.0]}, "escalate_mse": 1e-4},
        {"cmd": "info"},
        {"cmd": "shutdown"},
    ]
    out = io.StringIO()
    t0 = time.perf_counter()
    serve_stdio(svc, io.StringIO("\n".join(json.dumps(x) for x in lines) + "\n"), out)
    stdio_s = time.perf_counter() - t0
    resp = [json.loads(x) for x in out.getvalue().splitlines()]
    for i in range(3):
        hold(f"stdio goicp g{i}", resp[i], *qs[i][1:])
    hold("stdio icp track", resp[3], *qs[3][1:], escalated=False)
    hold("stdio icp lost", resp[4], *qs[4][1:], escalated=True)
    info = resp[5]
    chk.expect(info.get("devices") == [torch.cuda.get_device_name(0)],
               f"9b info names the card: {info.get('devices')}")
    stdio_launches = dict(fused.launches)

    fused.reset_launch_counts()
    tcp_lines = [[{"id": f"c{i}", "points": q[0].tolist()},
                  {"id": f"c{i}-track", "points": q[0].tolist(), "mode": "icp",
                   "init": near(*q[1:])}]
                 for i, q in enumerate(qs[:3] + qs[5:6])]
    t0 = time.perf_counter()
    refused, answers, batcher = _tcp_session(svc, "smoke-token", tcp_lines, window_s=0.5)
    tcp_s = time.perf_counter() - t0
    chk.expect(not refused.get("ok") and "auth" in refused.get("error", "") and refused["closed"],
               f"9b tcp: a client without the token refused and closed ({refused})")
    for i, (q, got) in enumerate(zip(qs[:3] + qs[5:6], answers)):
        if got is None:
            chk.expect(False, f"9b tcp client {i} answered")
            continue
        hold(f"tcp goicp c{i}", got[0], *q[1:])
        hold(f"tcp icp c{i}", got[1], *q[1:])
    batches = list(batcher.batches) if batcher is not None else []
    chk.expect(4 in batches, f"9b tcp: the four goicp queries in one Batcher batch (batches "
                             f"{batches})")
    tcp_launches = dict(fused.launches)

    # a lone query of a service without shape buckets leaves the lockstep
    # for the single-pair solver, on the Batcher's thread: its rounds replay
    # the rotation bound's CUDA graph there.  The query carries noise 0.003
    # and the threshold sits below its mse, so the BnB runs its budget.
    solo = RegistrationService(tgt, BnbParams(mse_threshold=1e-6, max_wall_s=SERVE_SOLO_WALL_S),
                               name="bunny-solo", bucket_shapes=False, device=dev)
    src, Q, t = qs[0]
    noisy = (src + rng.normal(0, 0.003, src.shape)).astype(np.float32)
    fused.reset_launch_counts()
    t0 = time.perf_counter()
    _, answers, _ = _tcp_session(solo, "smoke-token", [[{"id": "solo",
                                                           "points": noisy.tolist()}]], 0.05)
    solo_s = time.perf_counter() - t0
    got = answers[0][0] if answers[0] else {}
    hold("tcp single-pair solver", got, Q, t)
    chk.expect(got.get("nodes", 0) > 0 and fused.launches["bounds_nodes"] > 0,
               f"9b tcp single-pair solver ran its rounds on the Batcher's thread: nodes "
               f"{got.get('nodes')}, K2 launches {fused.launches['bounds_nodes']}")
    return dict(build_s=build_s, stdio_s=stdio_s, tcp_s=tcp_s, solo_s=solo_s, answers=checks,
                info=info, batches=batches, stdio_launches=stdio_launches,
                tcp_launches=tcp_launches, solo_launches=dict(fused.launches), refused=refused)


def phase_9c(chk, dev, src, tgt, R_gt, t_gt):
    """9c: three 300-point pairs in lockstep on the card (K4) and on the CPU
    path's K4 form (K4's plain version): equal rounds, nodes and converged
    flags per pair, and one ``_pairs_round`` bit-equal in ub and lb;
    untrimmed and trimmed (0.25)."""
    import torch

    from goicp_tpu_torch import multipair_lockstep as ml
    from goicp_tpu_torch.geo.rotation import random_rotations
    from goicp_tpu_torch.icp import IcpParams

    rng = np.random.default_rng(93)
    s = src[np.sort(rng.choice(src.shape[0], 300, replace=False))]
    t = tgt[np.sort(rng.choice(tgt.shape[0], 300, replace=False))]
    pairs, _ = lockstep_pairs(s, t, R_gt, 3, 94)
    out = {}
    for label, trim in (("untrimmed", 0.0), ("trimmed", TRIM)):
        params, _ = solve_params(dev, s, t, R_gt, t_gt, trim, se3_pop=64, init_multistart=8,
                                 refine_top_k=2, max_rounds=AGREE_ROUNDS, max_wall_s=1e9)
        rg = ml._register_pairs_lockstep(pairs, params, device=dev)
        rc = ml._register_pairs_lockstep(pairs, params, device="cpu", use_kernel=True)
        same = all((a.rounds, a.rot_nodes, a.converged) == (b.rounds, b.rot_nodes, b.converged)
                   for a, b in zip(rg, rc))
        chk.expect(same, f"9c {label} lockstep card vs CPU (K4 form): (rounds, nodes, converged) "
                         f"{[(r.rounds, r.rot_nodes, r.converged) for r in rg]} vs "
                         f"{[(r.rounds, r.rot_nodes, r.converged) for r in rc]}")
        M = 512
        Rn = random_rotations(3 * M, rng).reshape(3, M, 3, 3)
        ang = rng.uniform(0.01, 1.0, (3, M)).astype(np.float32)
        t_c = rng.uniform(-0.1, 0.1, (3, M, 3)).astype(np.float32)
        t_s = rng.uniform(0.005, 0.1, (3, M)).astype(np.float32)
        mask = np.ones((3, M), bool)
        mask[2, 300:] = False
        h = np.array([max(1, round(300 * (1 - trim)))] * 3, np.float64)
        bounds = []
        for d in (dev, torch.device("cpu")):
            batch = ml._PairBatch(pairs, 300, d)
            bounds.append([x.cpu() for x in ml._pairs_round(
                batch, 0.0, Rn, ang, t_c, t_s, mask, h, np.full(3, 2.0, np.float32),
                refine_k=2, icp_params=IcpParams(max_iter=32, rel_tol=1e-4, trim_fraction=trim),
                trim=trim > 0, use_kernel=True)[:2]])
        eq = all(bool(torch.equal(a, b)) for a, b in zip(*bounds))
        chk.expect(eq, f"9c {label} _pairs_round card vs CPU: ub and lb bit-equal")
        out[label] = dict(card=[(r.rounds, r.rot_nodes, r.converged, r.sse) for r in rg],
                          cpu=[(r.rounds, r.rot_nodes, r.converged, r.sse) for r in rc],
                          round_bit_equal=eq)
    return out


def lockstep_phase(chk, dev, src, tgt, R_gt, t_gt, solo, clock_hz):
    """Phase 9: K4 and K1 at the lockstep's shapes, then 9a-9c.  Returns
    the records, with the two kernel rows under "kernels"."""
    import torch

    S, T = torch.as_tensor(src, device=dev), torch.as_tensor(tgt, device=dev)
    out = {"kernels": check_lockstep_kernels(chk, dev, S, T, np.random.default_rng(95),
                                             clock_hz, LOCKSTEP_PAIRS, 8, 4096)}
    out["9a"] = phase_9a(chk, dev, src, tgt, R_gt, t_gt, solo)
    out["9b"] = phase_9b(chk, dev, tgt)
    out["9c"] = phase_9c(chk, dev, src, tgt, R_gt, t_gt)
    return out


MESH_NODES = 21080              # 10a: the headline's largest R-round bucket (8 · se3_pop)
MESH_CASES = (                  # 10a: (label, (cubes, points), backend, trimmed)
    ("2x1 mxu", (2, 1), "mxu", False), ("4x1 mxu", (4, 1), "mxu", False),
    ("2x1 screen", (2, 1), "screen", False), ("4x1 screen", (4, 1), "screen", False),
    ("1x2 mxu", (1, 2), "mxu", False), ("1x2 mxu trimmed", (1, 2), "mxu", True),
    ("2x2 mxu", (2, 2), "mxu", False), ("2x2 mxu trimmed", (2, 2), "mxu", True),
)
MH_WALL_S = 150.0               # 10b: BnB budget of the two-process bunny (phase 4's)
MH_PAIRS_WALL_S = 15.0          # 10c: BnB budget of each process's lockstep
MH_AGREE_ROUNDS = 30            # 10d: lockstep iterations of the card-vs-CPU solves
MH_TIMEOUT_S = 420              # a worker that runs longer is killed and fails the phase


def mesh_round_inputs(rng, dev, M):
    """``M`` nodes as an R-round holds them: rotations, cube angles for
    spans π/8..π/32, translations and their half sides; the last 37 are
    padding (masked)."""
    import torch

    from goicp_tpu_torch.geo.rotation import axis_angle_rotation

    R = axis_angle_rotation(torch.as_tensor(
        rng.uniform(-np.pi, np.pi, (M, 3)).astype(np.float32), device=dev))
    ang = np.minimum(np.sqrt(3) * np.pi / 2 ** rng.integers(3, 6, M), np.pi).astype(np.float32)
    t_c = rng.uniform(-0.3, 0.3, (M, 3)).astype(np.float32)
    t_s = (0.5 / 2 ** rng.integers(2, 5, M)).astype(np.float32)
    mask = np.ones(M, bool)
    mask[-37:] = False
    return (R, *(torch.as_tensor(x, device=dev) for x in (ang, t_c, t_s)),
            torch.as_tensor(mask, device=dev))


def phase_10a(chk, dev, src, tgt, clock_hz):
    """10a: ``make_sharded_se3_round`` at the headline (21,080 nodes × 1,518
    × 1,797) over meshes of the one card listed k times: cube-only meshes
    (K4 on "mxu", K2 on "screen" at the median lb) bit-equal to the
    single-device round, point-sharded ones (K4, untrimmed and trimmed at h
    = 0.75·N) within rtol 1e-5 + atol 1e-5; each round's ms beside the
    single-device round's.  The main path's K4 and K2 launches are counted
    by shape (nodes x points); K4 and K2 get rows at a shard's shape, and
    every other shard shape of the main path is checked against the plain
    version too."""
    import collections

    import torch

    from goicp_tpu_torch.bnb.bounds import BoundsEvaluator
    from goicp_tpu_torch.bnb.se3_eval import se3_round_bounds
    from goicp_tpu_torch.dist.se3 import make_sharded_se3_round, pad_points
    from goicp_tpu_torch.dist.sharding import make_mesh
    from goicp_tpu_torch.icp import IcpParams
    from goicp_tpu_torch.nn import fused

    rng = np.random.default_rng(101)
    S, T = torch.as_tensor(src, device=dev), torch.as_tensor(tgt, device=dev)
    norms = BoundsEvaluator(S).norms
    N = S.shape[0]
    h_trim = int(round(0.75 * N))
    R, ang, t_c, t_s, mask = mesh_round_inputs(rng, dev, MESH_NODES)
    _, lb_open = se3_round_bounds(S, norms, T, 0.0, float("inf"), R, ang, t_c, t_s, mask, h=0,
                                  backend="mxu")
    thresh = float(lb_open[mask].median())

    def single(backend, h, th):
        return se3_round_bounds(S, norms, T, 0.0, th, R, ang, t_c, t_s, mask, h=h,
                                backend=backend)

    rounds = []
    for label, (n_c, n_p), backend, trimmed in MESH_CASES:
        h = h_trim if trimmed else 0
        th = thresh if backend == "screen" else float("inf")
        sp, nrm = pad_points(src, norms.cpu().numpy(), n_p, 128)
        rnd = make_sharded_se3_round(
            make_mesh(n_c, n_p, devices=[dev] * (n_c * n_p)), h=h, n_valid=N, lookup="nearest",
            backend=backend, tile=128, refine_k=8, icp_params=IcpParams(), icp_backend="exact")
        args = (torch.as_tensor(sp, device=dev), torch.as_tensor(nrm, device=dev), None, T, 0.0,
                th, R, ang, t_c, t_s, mask)
        rounds.append((label, n_c, n_p, backend, h, th, rnd, args))
    # the main path: every mesh round once, launches counted from 0; the
    # spy records each K4/K2 launch's (nodes, points) and counts nothing
    shapes = collections.Counter()
    launch = fused._launch

    def spy(name, fn, *a):
        launch(name, fn, *a)
        if name in ("min_d2_nodes", "bounds_nodes"):
            shapes[(name, a[1], a[3])] += 1          # (params, B, srcT, Np, ...)

    torch.cuda.synchronize()
    fused.reset_launch_counts()
    fused._launch = spy
    try:
        outs = [rnd.bounds(*args) for *_, rnd, args in rounds]
        torch.cuda.synchronize()
    finally:
        fused._launch = launch
    launches = dict(fused.launches)
    cases = {}
    for (label, n_c, n_p, backend, h, th, rnd, args), got in zip(rounds, outs):
        ref = single(backend, h, th)
        if n_p == 1:
            ok = all(bool(torch.equal(g, r)) for g, r in zip(got, ref))
            chk.expect(ok, f"10a {label} (h {h}): ub and lb bit-equal to the single-device round")
            err = 0.0 if ok else float(max((g - r)[torch.isfinite(r)].abs().max()
                                           for g, r in zip(got, ref)))
        else:
            err, ok = 0.0, True
            for g, r in zip(got, ref):
                fin = torch.isfinite(r)
                ok &= bool(torch.equal(fin, torch.isfinite(g)))
                d = (g[fin] - r[fin]).abs()
                err = max(err, float(d.max()))
                ok &= bool((d <= 1e-5 + 1e-5 * r[fin].abs()).all())
            chk.expect(ok, f"10a {label} (h {h}): max |err| {err:.3g} against the single-device "
                           "round (tol 1e-5 + 1e-5·|ref|)")
        ms = timed_ms(lambda: rnd.bounds(*args), 5)
        ms_single = timed_ms(lambda: single(backend, h, th), 5)
        cases[label] = dict(mesh=[n_c, n_p], backend=backend, h=h, thresh=th, max_abs_err=err,
                            ms=ms, single_device_ms=ms_single, mesh_over_single=ms / ms_single)
        print(f"10a {label}: mesh round {ms:.4g} ms, single-device {ms_single:.4g} ms "
              f"({ms / ms_single:.3f}x)", flush=True)
    chk.expect(launches["min_d2_nodes"] > 0 and launches["bounds_nodes"] > 0,
               f"10a mesh rounds launched K4 {launches['min_d2_nodes']} and K2 "
               f"{launches['bounds_nodes']} times")
    by_shape = {shape_key(*k): n for k, n in sorted(shapes.items())}
    info = dict(nodes=MESH_NODES, points=N, targets=T.shape[0], cases=cases, launches=launches,
                k1_launches_by_shape={}, mesh_launches_by_shape=by_shape,
                card="[cuda:0] listed once per shard")
    print("10a launches by shape: " + json.dumps(by_shape), flush=True)
    # K4 at the 2x2 mesh's shard (10,540 nodes x 768 points), K2 at the
    # 2x1 mesh's cube shard (10,540 nodes x 1,518 points, 1,536 packed)
    nrm = norms.cpu().numpy()
    sp, _ = pad_points(src, nrm, 2, 128)
    shard = torch.as_tensor(sp[: sp.shape[0] // 2], device=dev)
    k4 = check_k4(chk, dev, shard, T, rng, clock_hz, MESH_NODES // 2, tag=" mesh shard")
    k4["replaces"] = ("goicp_tpu/nn/mxu.py:176 (via min_d2_nodes :361, dist/se3.py:142-152, "
                      "one point shard)")
    k4["mesh_shape_key"] = ("min_d2_nodes", MESH_NODES // 2, shard.shape[0])
    report("K4 mesh shard", k4)
    k2 = check_k2(chk, dev, S, T, rng, clock_hz, MESH_NODES // 2, tag=" mesh shard")
    k2["replaces"] = "goicp_tpu/nn/mxu.py:479 (via dist/se3.py:125-140, one cube shard)"
    k2["mesh_shape_key"] = ("bounds_nodes", MESH_NODES // 2, fused.pack_sources_ext(S, norms).shape[1])
    # the main path's other shard shapes: one launch each against the plain version
    for rec in (k4, k2):
        own = rec["mesh_shape_key"]
        chk.expect(shapes[own] > 0, f"{rec['name'].split()[0]} mesh shard: the main path "
                                    f"launched it {shapes[own]} times at {shape_key(*own)}")
        rec["other_shard_shapes"] = {
            shape_key(*k): dict(launches=n, **check_shard_shape(chk, dev, k, S, norms, nrm, T, rng))
            for k, n in sorted(shapes.items()) if k[0] == own[0] and k != own}
    return info, k4, k2


def shape_key(counter: str, nodes: int, points: int) -> str:
    """10a's key of a K4/K2 launch shape: ``counter:nodesxpoints``."""
    return f"{counter}:{nodes}x{points}"


def check_shard_shape(chk, dev, key, S, norms, nrm, T, rng) -> dict:
    """One launch of K4 or K2 at another shard shape of 10a's main path
    against its plain version on the same inputs: K4 on the shard's padded
    points, bit-equal; K2 on the whole source, screened at the median lb,
    within 1e-5 + 1e-5·|ref| and bit-equal to its kernel-order twin."""
    import torch

    from goicp_tpu_torch.dist.se3 import pad_points
    from goicp_tpu_torch.nn import fused
    from goicp_tpu_torch.nn.agree import screened_agree

    counter, B, Np = key
    Rb, tb, af, gt = node_batch(rng, B, dev)
    wm = fused.pack_targets(T)
    if counter == "min_d2_nodes":
        n_p = next(n for n in (1, 2, 4, 8) if pad_points(S.cpu().numpy(), nrm, n, 128)[0].shape[0]
                   == n * Np)
        pts = pad_points(S.cpu().numpy(), nrm, n_p, 128)[0][:Np]
        args = (fused.pack_sources(torch.as_tensor(pts, device=dev)), wm, fused.pack_params(Rb, tb))
        got = fused.min_d2_nodes(*args)
        torch.cuda.synchronize()
        ref = fused.min_d2_nodes_plain(*args)
        err = float((got - ref).abs().max())
        ok = bool(torch.equal(got, ref))
        tol = "tol 0: bit-equal"
        fn = fused.min_d2_nodes
    else:
        srcX = fused.pack_sources_ext(S, norms)
        _, lb_open = fused.bounds_nodes_plain(
            srcX, wm, fused.pack_params_bounds(Rb, tb, af, gt, 0.0, 1e30))
        th = float(lb_open.median())
        args = (srcX, wm, fused.pack_params_bounds(Rb, tb, af, gt, 0.0, th))
        ub, lb = fused.bounds_nodes(*args)
        torch.cuda.synchronize()
        ok, err, _, _ = screened_agree(ub, lb, *fused.bounds_nodes_plain(*args), th, th)
        ub_o, lb_o = fused.bounds_nodes_kernel_order(*args)
        ok = ok and bool(torch.equal(ub, ub_o) and torch.equal(lb, lb_o))
        tol = "tol 1e-5 + 1e-5·|ref|, bit-equal to the kernel-order version"
        fn = fused.bounds_nodes
    name = "K4" if counter == "min_d2_nodes" else "K2"
    chk.expect(ok, f"{name} mesh shard at {B} nodes x {Np} points: max |err| {err:.3g} ({tol})")
    return dict(max_abs_err=err, ms=timed_ms(lambda: fn(*args), 5))


def mh_spawn(chk, label, nproc, spec):
    """``nproc`` worker processes (this script with ``--mh-worker``), joined
    in a gloo group through a ``file://`` store under ``chiprun_out/``;
    returns their records, rank order.  A worker that fails or outlives
    MH_TIMEOUT_S fails the phase (all are killed)."""
    store = os.path.join(OUT_DIR, f"mh_store_{label.replace(' ', '_')}")
    if os.path.exists(store):
        os.remove(store)
    outs, procs = [], []
    for r in range(nproc):
        out = f"{store}_{r}.json"
        if os.path.exists(out):
            os.remove(out)
        outs.append(out)
        procs.append(subprocess.Popen(
            [sys.executable, os.path.abspath(__file__), "--mh-worker", json.dumps(dict(
                spec, rank=r, nproc=nproc, init=f"file://{store}", out=out))],
            cwd=HERE, stdout=subprocess.PIPE, stderr=subprocess.STDOUT))
    recs, t_end = [], time.perf_counter() + MH_TIMEOUT_S
    for r, (pr, out) in enumerate(zip(procs, outs)):
        try:
            log, _ = pr.communicate(timeout=max(1.0, t_end - time.perf_counter()))
        except subprocess.TimeoutExpired:
            for q in procs:
                q.kill()
                q.wait()
            chk.expect(False, f"{label}: worker {r} outlived {MH_TIMEOUT_S} s")
            return None
        tail = log.decode(errors="replace")[-1500:]
        ok = pr.returncode == 0 and os.path.exists(out)
        chk.expect(ok, f"{label}: worker {r} exited {pr.returncode}" + ("" if ok else "\n" + tail))
        if not ok:
            for q in procs:
                q.kill()
                q.wait()
            return None
        with open(out) as f:
            recs.append(json.load(f))
    return recs


def mh_worker(spec: dict) -> int:
    """One process of a phase 10 run: ``solve`` (the frontier-sharded solve
    through ``make_solver``) or ``pairs`` (``register_pairs_distributed``)
    on ``spec["device"]``, in a gloo group; writes its record to
    ``spec["out"]``."""
    import datetime
    import torch
    import torch.distributed as dist

    sys.path.insert(0, HERE)
    import goicp_tpu_torch  # noqa: F401  (sets the f32 precision policy)
    from goicp_tpu_torch import BnbParams, make_solver
    from goicp_tpu_torch.multipair import register_pairs_distributed
    from goicp_tpu_torch.nn import fused, kernels

    cuda = spec["device"] == "cuda"
    if not cuda:
        torch.set_num_threads(max(1, (os.cpu_count() or 2) // spec["nproc"]))
    dist.init_process_group("gloo", init_method=spec["init"], rank=spec["rank"],
                            world_size=spec["nproc"],
                            timeout=datetime.timedelta(seconds=MH_TIMEOUT_S))
    try:
        if cuda:
            kernels.lib()
        data = spec["data"]
        if data == "subset300":
            part = wl.load_pair(wl.load_config("bunny_goicp_partial_trim25"), 1)
            psrc, ptgt = part.src, part.tgt
            rng = np.random.default_rng(3)
            src = psrc[np.sort(rng.choice(psrc.shape[0], 300, replace=False))]
            tgt = ptgt[np.sort(rng.choice(ptgt.shape[0], 300, replace=False))]
        else:
            head = wl.load_pair(wl.load_config("bunny_goicp_headline"), 1)
            src, tgt = head.src, head.tgt
        params = BnbParams(**spec["params"])
        device = None if cuda else "cpu"
        fused.reset_launch_counts()
        t0 = time.perf_counter()
        if spec["mode"] == "pairs":
            R_gt = wl.load_pair(wl.load_config("bunny_goicp_headline"), 1).R
            pairs, _ = lockstep_pairs(src, tgt, R_gt, LOCKSTEP_PAIRS, 91)
            res = register_pairs_distributed(pairs, params, device=device)
            # the fields of the exchanged record, at its f32 precision (a
            # rank's own results keep their f64 gap otherwise)
            rec = dict(results=[dict(R=np.asarray(r.transform.R).tolist(),
                                     t=np.asarray(r.transform.t).tolist(),
                                     sse=float(np.float32(r.sse)), gap=float(np.float32(r.gap)),
                                     converged=bool(r.converged), rounds=r.rounds,
                                     nodes=r.rot_nodes) for r in res])
        else:
            res = make_solver(src, tgt, params, device=device).run()
            c, tm = res.metrics.counters, res.metrics.timers
            rec = dict(R=np.asarray(res.transform.R).tolist(),
                       t=np.asarray(res.transform.t).tolist(), sse=res.sse, mse=res.mse,
                       gap=res.gap, converged=bool(res.converged), rounds=res.rounds,
                       local_nodes=res.rot_nodes, rebalances=int(c.get("rebalances", 0)),
                       mh_iters=int(c.get("mh_iters", 0)), bnb_s=tm.get("bnb", 0.0),
                       mh_gather_s=tm.get("mh_gather_s", 0.0),
                       mh_dispatch_s=tm.get("mh_dispatch_s", 0.0),
                       mh_absorb_s=tm.get("mh_absorb_s", 0.0),
                       mh_rebalance_s=tm.get("mh_rebalance_s", 0.0))
        if cuda:
            torch.cuda.synchronize()
        rec.update(wall_s=time.perf_counter() - t0, launches=dict(fused.launches),
                   k1_launches_by_shape={f"{q}x{t}": n for (q, t), n
                                         in sorted(fused.nn_launch_shapes.items())},
                   device=(torch.cuda.get_device_name(0) if cuda else "cpu"))
        with open(spec["out"], "w") as f:
            json.dump(rec, f)
    finally:
        dist.destroy_process_group()
    return 0


def _summed(recs, key):
    out = {}
    for r in recs:
        for k, v in r[key].items():
            out[k] = out.get(k, 0) + v
    return out


def phase_10b(chk, dev, src, tgt, R_gt, t_gt, solo):
    """10b: the certified bunny headline through ``make_solver`` in two
    processes on the one card (``GoIcpSolverMultiHost``), phase 4's
    protocol, MH_WALL_S: both converge with gap ≤ ε, poses bit-equal across
    ranks and within the limits; local nodes, rounds, rebalances, the
    exchange and dispatch timers, and total nodes/s beside phase 4's."""
    params, _ = solve_params(dev, src, tgt, R_gt, t_gt, max_wall_s=MH_WALL_S)
    # phase 4's round width (its auto se3_pop), so that rates compare: the
    # multi-process engine's own default pops 256 parents a round
    se3_pop = max(64, min(4096, int(32e6 / (8 * src.shape[0]))))
    t0 = time.perf_counter()
    recs = mh_spawn(chk, "10b two-process bunny", 2, dict(
        mode="solve", data="bunny", device="cuda",
        params=dict(mse_threshold=params.mse_threshold, max_wall_s=MH_WALL_S,
                    se3_pop=se3_pop)))
    if recs is None:
        return dict(launches={}, k1_launches_by_shape={})
    wall = time.perf_counter() - t0
    eps = params.mse_threshold * src.shape[0]
    extent = float(np.linalg.norm(tgt.max(0) - tgt.min(0)))
    for r, rec in enumerate(recs):
        chk.expect(rec["converged"] and rec["gap"] <= eps,
                   f"10b rank {r}: converged {rec['converged']}, gap {rec['gap']:.4g} (≤ ε {eps:.4g})")
        pose_limits(chk, f"10b rank {r}", rec["R"], rec["t"], R_gt, t_gt, extent)
    chk.expect(recs[0]["R"] == recs[1]["R"] and recs[0]["t"] == recs[1]["t"],
               "10b poses bit-equal across ranks")
    nodes = sum(r["local_nodes"] for r in recs)
    bnb_s = max(r["bnb_s"] for r in recs)
    info = dict(per_rank=[{k: r[k] for k in (
        "local_nodes", "rounds", "rebalances", "mh_iters", "mh_gather_s", "mh_dispatch_s",
        "mh_absorb_s", "mh_rebalance_s", "bnb_s", "wall_s", "converged", "gap", "sse",
        "launches")} for r in recs],
        nodes=nodes, nodes_per_s=nodes / bnb_s, solo_nodes_per_s=solo["nodes_per_s"],
        over_solo=nodes / bnb_s / solo["nodes_per_s"], solo_nodes=solo["nodes"],
        launch_to_exit_s=wall, mse_threshold=params.mse_threshold, max_wall_s=MH_WALL_S,
        se3_pop=se3_pop,
        R=recs[0]["R"], t=recs[0]["t"], launches=_summed(recs, "launches"),
        k1_launches_by_shape=_summed(recs, "k1_launches_by_shape"))
    for k in ("nearest_neighbor_mxu", "bounds_nodes", "min_d2_groups"):
        chk.expect(all(r["launches"][k] > 0 for r in recs),
                   f"10b both ranks launched {k} ({[r['launches'][k] for r in recs]})")
    print("10b two-process bunny: " + json.dumps({k: info[k] for k in (
        "per_rank", "nodes", "nodes_per_s", "solo_nodes_per_s", "over_solo",
        "launch_to_exit_s")}), flush=True)
    return info


def phase_10c(chk, dev, src, tgt, R_gt, t_gt):
    """10c: ``register_pairs_distributed`` of 9a's four pairs over two
    processes on the one card, MH_PAIRS_WALL_S each: the result lists equal
    on both ranks, every pose within the limits."""
    params, _ = solve_params(dev, src, tgt, R_gt, t_gt, max_wall_s=MH_PAIRS_WALL_S)
    recs = mh_spawn(chk, "10c distributed pairs", 2, dict(
        mode="pairs", data="bunny", device="cuda",
        params=dict(mse_threshold=params.mse_threshold, max_wall_s=MH_PAIRS_WALL_S)))
    if recs is None:
        return {}
    chk.expect(recs[0]["results"] == recs[1]["results"] and len(recs[0]["results"]) == 4,
               "10c the four results equal on both ranks")
    _, R_gts = lockstep_pairs(src, tgt, R_gt, LOCKSTEP_PAIRS, 91)
    extent = float(np.linalg.norm(tgt.max(0) - tgt.min(0)))
    for b, (r, Rg) in enumerate(zip(recs[0]["results"], R_gts)):
        pose_limits(chk, f"10c pair {b}", r["R"], r["t"], Rg, t_gt, extent)
    info = dict(results=recs[0]["results"], wall_s=[r["wall_s"] for r in recs],
                launches=[r["launches"] for r in recs])
    print("10c distributed pairs: " + json.dumps(info), flush=True)
    return info


def phase_10d(chk, dev, psrc, ptgt, pR, pt):
    """10d: a two-process solve of 5b's 300-point subsets (untrimmed,
    MH_AGREE_ROUNDS lockstep iterations, no wall budget) on the card and on
    the CPU: equal per-rank nodes and rounds, poses within 1e-4."""
    rng = np.random.default_rng(3)
    s = psrc[np.sort(rng.choice(psrc.shape[0], 300, replace=False))]
    t = ptgt[np.sort(rng.choice(ptgt.shape[0], 300, replace=False))]
    params, _ = solve_params(dev, s, t, pR, pt, 0.0)
    kw = dict(mse_threshold=params.mse_threshold, se3_pop=64, init_multistart=8,
              refine_top_k=2, max_rounds=MH_AGREE_ROUNDS, max_wall_s=1e9)
    runs = {d: mh_spawn(chk, f"10d two-process {d}", 2, dict(mode="solve", data="subset300",
                                                              device=d, params=kw))
            for d in ("cuda", "cpu")}
    if runs["cuda"] is None or runs["cpu"] is None:
        return {}
    for r, (g, c) in enumerate(zip(runs["cuda"], runs["cpu"])):
        dR = float(np.abs(np.asarray(g["R"]) - np.asarray(c["R"])).max())
        chk.expect((g["rounds"], g["local_nodes"]) == (c["rounds"], c["local_nodes"])
                   and dR < 1e-4,
                   f"10d rank {r} card vs CPU: rounds {g['rounds']} vs {c['rounds']}, local "
                   f"nodes {g['local_nodes']} vs {c['local_nodes']}, |dR| {dR:.3g}")
    info = {d: [{k: r[k] for k in ("rounds", "local_nodes", "converged", "sse", "wall_s",
                                   "launches")} for r in recs] for d, recs in runs.items()}
    print("10d card vs CPU: " + json.dumps(info), flush=True)
    return info


def distribution_phase(chk, dev, src, tgt, R_gt, t_gt, psrc, ptgt, pR, pt, solo, clock_hz):
    """Phase 10: 10a mesh rounds on the card (with K4 and K2 at a shard's
    shape), 10b the two-process bunny, 10c ``register_pairs_distributed``,
    10d card against CPU."""
    out = {}
    out["10a"], k4, k2 = phase_10a(chk, dev, src, tgt, clock_hz)
    out["kernels"] = (k4, k2)
    out["10b"] = phase_10b(chk, dev, src, tgt, R_gt, t_gt, solo)
    out["10c"] = phase_10c(chk, dev, src, tgt, R_gt, t_gt)
    out["10d"] = phase_10d(chk, dev, psrc, ptgt, pR, pt)
    return out


# (key, launch counter, the phase whose solve is the kernel's main path);
# K1 has a row per shape (k1_shapes) and counts that shape's launches
KERNELS = (
    ("K1 refine", "nearest_neighbor_mxu", "solve"),
    ("K1 coarse", "nearest_neighbor_mxu", "solve"),
    ("K1 multistart", "nearest_neighbor_mxu", "solve"),
    ("K1 cli", "nearest_neighbor_mxu", "cli mode 1"),
    ("K1 coverage", "nearest_neighbor_mxu", "full cert"),
    ("K2", "bounds_nodes", "solve"),
    ("K2 full cert", "bounds_nodes", "full cert"),
    ("K3", "min_d2_groups", "solve"),
    ("K3 full cert", "min_d2_groups", "full cert"),
    ("K4", "min_d2_nodes", "trimmed solve"),
    ("K5", "bounds_nodes_trimmed", "trimmed screen solve"),
    ("K5 full cert", "bounds_nodes_trimmed", "trimmed screen full cert"),
    ("K6", "bounds_groups_trimmed", "trimmed screen solve"),
    ("K7", "bounds_groups", None),
    ("K4 exp", "min_d2_nodes_exp", None),
    ("K4 dot", "min_d2_nodes_dot", None),
    ("K1 exp", "min_d2_padded_exp", None),
    ("K1 dot", "min_d2_padded_dot", None),
    ("K3 exp", "min_d2_groups_exp", None),
    ("K4 lockstep", "min_d2_nodes", "lockstep"),
    ("K1 lockstep", "nearest_neighbor_mxu", "lockstep"),
    ("K4 mesh shard", "min_d2_nodes", "mesh rounds"),
    ("K2 mesh shard", "bounds_nodes", "mesh rounds"),
)


def main() -> int:
    import torch

    if "--mh-worker" in sys.argv[1:]:
        return mh_worker(json.loads(sys.argv[sys.argv.index("--mh-worker") + 1]))
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
    if "--witness" in sys.argv[1:]:
        cpu_witness(chk, torch.device("cuda"))
        print(f"total: {time.perf_counter() - t_start:.1f} s", flush=True)
        return 1 if chk.failed else 0

    head = wl.load_pair(wl.load_config("bunny_goicp_headline"), 1)
    part = wl.load_pair(wl.load_config("bunny_goicp_partial_trim25"), 1)
    src, tgt, R_gt, t_gt, scale = head.src, head.tgt, head.R, head.t, head.scale
    psrc, ptgt, pR, pt = part.src, part.tgt, part.R, part.t
    se3_pop = max(64, min(4096, int(32e6 / (8 * src.shape[0]))))   # bnb/se3.py auto
    h_trim = int(round(N_SRC * (1.0 - TRIM)))
    big = big_source()
    dev = torch.device("cuda")
    recs = kernel_checks(chk, dev, src, tgt, clock_mhz * 1e6, se3_pop, h_trim, big)
    rot_bound = check_rotation_bound(chk, dev)
    icp_graph = check_icp_graph(chk, dev, src, tgt, R_gt, t_gt, psrc, ptgt, pR, pt)
    phases = {
        "solve": solve_bunny(chk, dev, "solve", src, tgt, R_gt, t_gt,
                             ("nearest_neighbor_mxu", "bounds_nodes", "min_d2_groups")),
        "trimmed solve": solve_bunny(chk, dev, "trimmed solve", psrc, ptgt, pR, pt,
                                     ("nearest_neighbor_mxu", "min_d2_nodes", "min_d2_groups"),
                                     trim=TRIM, max_wall_s=TRIM_WALL_S),
        "trimmed screen solve": solve_bunny(
            chk, dev, "trimmed screen solve", psrc, ptgt, pR, pt,
            ("nearest_neighbor_mxu", "bounds_nodes_trimmed", "bounds_groups_trimmed"),
            trim=TRIM, bound_backend="screen", max_wall_s=SCREEN_WALL_S),
    }
    counts = (phases["solve"]["rounds"], phases["solve"]["nodes"])
    chk.expect(counts == HEADLINE_COUNTS,
               f"solve: {counts[0]} rounds and {counts[1]} nodes (the headline at seed 1: "
               f"{HEADLINE_COUNTS[0]} and {HEADLINE_COUNTS[1]})")
    small = small_agreement(chk, dev)
    small_trim = small_trimmed_agreement(chk, dev, psrc, ptgt, pR, pt)
    t7 = time.perf_counter()
    cli_out = cli_phase(chk, dev, src, R_gt, t_gt, scale, psrc, ptgt, pR, pt,
                        clock_mhz * 1e6)
    cli_out["phase_s"] = time.perf_counter() - t7
    print(f"phase 7: {cli_out['phase_s']:.1f} s", flush=True)
    for k in ("mode 4 plane", "mode 1", "mode 1 plane", "mode 2", "mode 2 plane", "grid solve"):
        phases[f"cli {k}" if k != "grid solve" else k] = cli_out[k]
    t8 = time.perf_counter()
    headline = dict(R=np.asarray(phases["solve"]["R"]), t=np.asarray(phases["solve"]["t"]),
                    nodes=phases["solve"]["nodes"])
    fc_out = fullcert_phase(chk, dev, src, tgt, R_gt, t_gt, scale, psrc, ptgt, pR, pt, headline,
                            clock_mhz * 1e6)
    for k in ("K1 coverage", "K2 full cert", "K3 full cert", "K5 full cert"):
        recs[k] = fc_out.pop(k)
    for k in ("full cert", "trimmed screen full cert"):
        phases[k] = fc_out[k]
    fc_out["phase_s"] = time.perf_counter() - t8
    print(f"phase 8: {fc_out['phase_s']:.1f} s", flush=True)
    t9 = time.perf_counter()
    ls_out = lockstep_phase(chk, dev, src, tgt, R_gt, t_gt, phases["solve"], clock_mhz * 1e6)
    recs["K4 lockstep"], recs["K1 lockstep"] = ls_out.pop("kernels")
    phases["lockstep"] = ls_out["9a"]
    ls_out["phase_s"] = time.perf_counter() - t9
    print(f"phase 9: {ls_out['phase_s']:.1f} s", flush=True)
    t10 = time.perf_counter()
    mh_out = distribution_phase(chk, dev, src, tgt, R_gt, t_gt, psrc, ptgt, pR, pt,
                                phases["solve"], clock_mhz * 1e6)
    recs["K4 mesh shard"], recs["K2 mesh shard"] = mh_out.pop("kernels")
    phases["mesh rounds"] = mh_out["10a"]
    phases["two-process solve"] = mh_out["10b"]
    mh_out["phase_s"] = time.perf_counter() - t10
    print(f"phase 10: {mh_out['phase_s']:.1f} s", flush=True)
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
        k5_shape = r.pop("k5_shape_key", None)
        mesh_shape = r.pop("mesh_shape_key", None)

        def count(info):
            """The row's launches in one phase; KeyError where the phase
            does not record this kernel's count."""
            if shape is not None:
                return info["k1_launches_by_shape"].get(f"{shape[0]}x{shape[1]}", 0)
            if k5_shape is not None:
                return info["k5_launches_by_np"].get(f"{k5_shape[0]}x{k5_shape[1]}", 0)
            if mesh_shape is not None:
                return info["mesh_launches_by_shape"].get(shape_key(*mesh_shape), 0)
            return info["launches"][counter]

        def count_any(info):
            try:
                return count(info)
            except KeyError:          # e.g. 10b's summed worker counts hold no entry
                return 0

        if phase is None:
            r["launches"] = r.pop("check_launches")
            r["launches_from"] = r.pop("path_note")
        else:
            r["launches"] = count(phases[phase])
            r["launches_from"] = (phase if shape is None and k5_shape is None
                                  and mesh_shape is None else f"{phase}, at this shape")
        r["launches_by_phase"] = {k: count_any(v) for k, v in phases.items()}
        prefix = key.split()[0] + " "
        r["check"] = "fail" if any(f.startswith(prefix) for f in chk.failed) else "pass"
        kernels_line.append(r)
    os.makedirs(OUT_DIR, exist_ok=True)
    with open(os.path.join(OUT_DIR, "chip_smoke.json"), "w") as f:
        json.dump(dict(card=card, kind=kind, clock_mhz=clock_mhz, kernels=kernels_line,
                       solve=phases["solve"], trimmed_solve=phases["trimmed solve"],
                       trimmed_screen_solve=phases["trimmed screen solve"],
                       small=small, small_trimmed=small_trim, rotation_bound=rot_bound,
                       icp_graph=icp_graph,
                       cli=cli_out, phase8=fc_out, phase9=ls_out, phase10=mh_out,
                       failed=chk.failed,
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
