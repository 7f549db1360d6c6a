#!/usr/bin/env python3
"""Time the nearest-neighbour kernels K1 and K4, the bound kernel K2, the
trimmed bound kernels K5 and K6 and the center-aware rotation bound of the
``goicp_tpu_torch`` package found under ROOT, on one GPU::

    python3 nn_ab.py [ROOT]        # ROOT: a checkout (default: this one)
    python3 nn_ab.py --routes      # K1, K2, K5, K6 on every launch route, this checkout
    python3 nn_ab.py [ROOT] --trace  # also trace ROOT's trimmed screen solve

Run it for two checkouts in one session, in turns (A, B, B, A), to compare
them on one card.  The shapes are ``chip_smoke.py``'s, on the in-repo bunny
pair: K1 at each shape of ``k1_shapes``, K4 at the largest R-round bucket
(8·se3_pop nodes) and with 20,000 targets, K5 at that bucket and K6 at
se3_pop groups and at 263 groups of a 4,096-point source (h = 0.75·N), each
unscreened and screened at half the median positive lb (``trim_levels``).
K2 runs at the headline's R-round bucket (21,080 nodes × 1,518 × 1,797)
and at the full cert's whole source (792 nodes × 40,256 × 1,797), each
unscreened and screened at the median lb, with a SHA-256 of its (ub, lb)
bytes, so two checkouts' outputs can be compared bit for bit.  The
rotation bound runs at 2,635 and 21,080 random cubes (a T-round's and the
largest R-round's count; ``rotation_bound``), with the host's wall per
call beside the device's.  It
reports, per K1 shape:

- ``kernel_ms``: the kernel alone, its inputs packed beforehand, through the
  checkout's C entry point (``goicp_nn_query``, or in checkouts without it
  ``goicp_nn_min_d2`` with one identity pose);
- ``icp_call_ms``: one ``nearest_neighbor_mxu`` call as the checkout's ICP
  makes it (with the targets packed once where the checkout does so);
- ``icp_call_host_ms``: the same call timed one by one, waiting for each,
  as the ICP waits once per iteration.

K1's first two are device time per call (``chip_smoke.device_ms``), the
rest medians of CUDA events (``chip_smoke.timed_ms``).  ``--routes``
instead times K1's kernel at each shape on every (target splits, queries
per thread) route, beside the one ``nn_route`` picks, K2 at both shapes
on both target routes and on schedules of fewer warps in flight (smaller
grids and CTAs: k, the blocks of a node in flight, falls to 1) beside
``k2_plan``'s pick, K5 at every count of warps per CTA, K5 at the whole
source (Np = 40,320) at every count of warps and at the trimmed full
cert's first subset (Np = 20,224), and K6 at 1, 2 and 3 points per
thread.
``--trace`` then runs ``chip_smoke.py``'s traced trimmed solve on
``bound_backend="screen"`` (30 s budget; busy share, device time by
kernel, K5/K6 launches) with ROOT's package.  The last line printed is
one JSON object; exits non-zero without CUDA.
"""

from __future__ import annotations

import hashlib
import importlib.util
import inspect
import json
import os
import sys

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("nn_ab: no CUDA device", file=sys.stderr)
        return 2
    args = [a for a in sys.argv[1:] if not a.startswith("--")]
    routes, trace = "--routes" in sys.argv[1:], "--trace" in sys.argv[1:]
    root = os.path.abspath(args[0] if args else HERE)
    sys.path.insert(0, root)
    spec = importlib.util.spec_from_file_location("smoke", os.path.join(HERE, "chip_smoke.py"))
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    import goicp_tpu_torch
    from goicp_tpu_torch.nn import fused, kernels

    if not os.path.abspath(goicp_tpu_torch.__file__).startswith(root + os.sep):
        print(f"nn_ab: imported {goicp_tpu_torch.__file__}, not from {root}", file=sys.stderr)
        return 2
    dev = torch.device("cuda")
    clock_hz = float(smoke.smi("clocks.max.sm").split()[0]) * 1e6
    src, tgt, *_ = smoke.load_bunny()
    S, T = torch.as_tensor(src, device=dev), torch.as_tensor(tgt, device=dev)
    rng = np.random.default_rng(7)
    packs_once = "packed" in inspect.signature(fused.nearest_neighbor_mxu).parameters
    out = dict(root=root, card=smoke.smi("name,power.limit"), k1={})
    for key, poses, n, nt in smoke.k1_shapes(S.shape[0], T.shape[0]):
        Sx = S[torch.as_tensor(np.sort(rng.choice(S.shape[0], n, replace=False)), device=dev)]
        Tx = T[torch.as_tensor(np.sort(rng.choice(T.shape[0], nt, replace=False)), device=dev)]
        Rp = smoke_rotations(rng, poses, dev)
        Q = (Sx[None] @ Rp.transpose(1, 2)).reshape(-1, 3).contiguous()
        if routes:
            t4 = fused.pack_nn_targets(Tx)
            out["k1"][key] = dict(
                queries=Q.shape[0], targets=nt,
                picked=fused.nn_route(Q.shape[0], t4.shape[0], fused._sm_count(dev.index)),
                kernel_ms={f"{s} splits x {qr}": smoke.device_ms(
                    lambda: fused._nn_kernel(Q, t4, nt, route=(s, qr)), 50, clock_hz)
                    for qr in (1, 4) for s in (1, 2, 4, 8)})
            continue
        if packs_once:
            t4 = fused.pack_nn_targets(Tx)

            def kern():
                fused._nn_kernel(Q, t4, nt)

            def call():
                fused.nearest_neighbor_mxu(Q, Tx, packed=t4)
        else:
            srcT, wm = fused.pack_sources(Q), fused.pack_targets(Tx)
            eye = fused.pack_params(torch.eye(3, device=dev)[None], torch.zeros((1, 3), device=dev))
            d2 = torch.empty((1, srcT.shape[1]), device=dev)
            idx = torch.empty((1, srcT.shape[1]), dtype=torch.int32, device=dev)
            fn = kernels.lib().goicp_nn_min_d2

            def kern():
                kernels.check(fn(eye.data_ptr(), 1, srcT.data_ptr(), srcT.shape[1],
                                 wm.data_ptr(), wm.shape[0], d2.data_ptr(), idx.data_ptr(),
                                 torch.cuda.current_stream().cuda_stream), "K1")

            def call():
                fused.nearest_neighbor_mxu(Q, Tx)

        out["k1"][key] = dict(
            queries=Q.shape[0], targets=nt,
            kernel_ms=smoke.device_ms(kern, 100, clock_hz),
            icp_call_ms=smoke.device_ms(call, 100, clock_hz),
            icp_call_host_ms=smoke.timed_ms(call, 50),
        )
    k2 = k2_cases(smoke, fused, S, T, dev)
    cases = trimmed_cases(smoke, fused, S, T, dev)
    if routes:
        out["k2_routes"] = k2_routes(smoke, fused, k2)
        out["trimmed_routes"] = trimmed_routes(smoke, fused, cases)
        out["k5_whole_source"] = k5_whole_source(smoke, fused, S, T, dev)
        print(json.dumps(out), flush=True)
        return 0
    out["k2"] = {}
    for key, (srcX, wm, params) in k2.items():
        ub, lb = fused.bounds_nodes(srcX, wm, params)
        torch.cuda.synchronize()
        digest = hashlib.sha256(ub.cpu().numpy().tobytes() + lb.cpu().numpy().tobytes()).hexdigest()
        out["k2"][key] = dict(ms=smoke.timed_ms(lambda: fused.bounds_nodes(srcX, wm, params), 10),
                              sha256=digest[:16])
    se3_pop = max(64, min(4096, int(32e6 / (8 * S.shape[0]))))        # bnb/se3.py auto
    B = 8 * se3_pop
    Rb, tb, _, _ = smoke.node_batch(rng, B, dev)
    srcT, wm, params = fused.pack_sources(S), fused.pack_targets(T), fused.pack_params(Rb, tb)
    wm_g = fused.pack_targets(torch.rand(20000, 3, device=dev) * 2.0 - 1.0)
    p_g = params[:64].contiguous()
    out["k4"] = {
        f"{B} nodes x {S.shape[0]} x {T.shape[0]}":
            smoke.timed_ms(lambda: fused.min_d2_nodes(srcT, wm, params), 10),
        f"64 nodes x {S.shape[0]} x 20000": smoke.timed_ms(lambda: fused.min_d2_nodes(srcT, wm_g, p_g), 5),
    }
    out["trimmed"] = {key: smoke.timed_ms(lambda: trimmed_call(fused, c), 10) for key, c in cases.items()}
    out["rotation_bound"] = rotation_bound(smoke, dev)
    if trace:
        psrc, ptgt, pR, pt = smoke.load_bunny_partial()
        out["trace"] = smoke.profile_solve(smoke.Checks(), dev, "trimmed screen solve", psrc, ptgt,
                                           pR, pt, smoke.TRIM, smoke.PROFILE_TRIM_WALL_S,
                                           bound_backend="screen")
    print(json.dumps(out), flush=True)
    return 0


def k2_cases(smoke, fused, S, T, dev):
    """K2's inputs, by key: (srcT, wm, params), at the headline's largest
    R-round bucket and at the full cert's whole source, unscreened and
    screened at the median lb (the same inputs in every checkout)."""
    import torch

    full = (smoke.bunny_full()[1] * smoke.load_bunny()[4]).astype(np.float32)
    wm = fused.pack_targets(T)
    cases = {}
    for label, src, B in (("headline", S, 21080),
                          ("whole source", torch.as_tensor(full, device=dev), 792)):
        rng = np.random.default_rng(7)
        Rb, tb, af, gt = smoke.node_batch(rng, B, dev)
        srcX = fused.pack_sources_ext(src, torch.linalg.vector_norm(src, dim=1))
        p_open = fused.pack_params_bounds(Rb, tb, af, gt, 0.0, 1e30)
        _, lb = fused.bounds_nodes_plain(srcX, wm, p_open)
        shape = f"{label}: {B} nodes x {src.shape[0]} x {T.shape[0]}"
        cases[f"{shape} unscreened"] = (srcX, wm, p_open)
        cases[f"{shape} screened"] = (
            srcX, wm, fused.pack_params_bounds(Rb, tb, af, gt, 0.0, float(lb.median())))
    return cases


def k2_routes(smoke, fused, cases):
    """K2 on both target routes and on schedules with fewer warps in flight,
    beside ``k2_plan``'s pick (this checkout's helpers)."""
    out = {}
    for key, (srcX, wm, params) in cases.items():
        B, Np, Mp = params.shape[0], srcX.shape[1], wm.shape[0]
        picked = fused.k2_plan(B, Np, Mp)
        runs = {}
        for route in ("resident", "ring"):
            for warps, grid in ((0, 0), (4, 0), (2, 0), (8, 132), (8, 66), (4, 33)):
                plan = fused.k2_plan(B, Np, Mp, warps, grid, route)
                ms = smoke.timed_ms(
                    lambda: fused._k2_kernel(srcX, wm, params, warps, grid, route), 5)
                runs[f"{route}, {plan['warps']} warps x {plan['grid']} CTAs, k {plan['k']}"] = ms
        out[key] = dict(picked=picked, ms=runs)
    return out


def k5_whole_source(smoke, fused, S, T, dev):
    """K5 at the full cert's whole source (Np = 40,320) at every
    warps-per-CTA count and at its first grown subset (Np = 20,224) at the
    plan's pick, unscreened and screened (h = 0.75·N)."""
    import torch

    from goicp_tpu_torch.nn.agree import trim_levels

    full = (smoke.bunny_full()[1] * smoke.load_bunny()[4]).astype(np.float32)
    wm = fused.pack_targets(T)
    out = {}
    for n, warps in ((full.shape[0], range(1, 9)), (20128, (0,))):
        src = torch.as_tensor(full[:n], device=dev)
        B = 8 * max(64, min(4096, int(32e6 / (8 * n))))                # bnb/se3.py auto
        h = int(round(n * (1.0 - smoke.TRIM)))
        rng = np.random.default_rng(9)
        Rb, tb, af, gt = smoke.node_batch(rng, B, dev)
        srcX = fused.pack_sources_ext(src, torch.linalg.vector_norm(src, dim=1))
        p_open = fused.pack_params_bounds_trimmed(Rb, tb, af, gt, 0.0, 1e30, 1e30)
        _, lb = fused.bounds_nodes_trimmed_plain(srcX, wm, p_open, h=h, drop=n - h)
        _, te, tau = trim_levels(lb, h, n - h)
        p_scr = fused.pack_params_bounds_trimmed(Rb, tb, af, gt, 0.0, te, tau)
        for label, params in (("unscreened", p_open), ("screened", p_scr)):
            for w in warps:
                plan = fused.k5_plan(B, srcX.shape[1], wm.shape[0], w)
                ms = smoke.timed_ms(lambda: fused._k5_kernel(srcX, wm, params, h, n - h, w), 5)
                out[f"{B} nodes x {n} x {T.shape[0]} {label}, "
                    f"{plan['warps']} warps x {plan['grid']} CTAs"] = ms
    return out


def rotation_bound(smoke, dev):
    """The center-aware rotation bound (``geo.rotation.
    axis_angle_cube_max_angle``) at a T-round's and the largest R-round's
    cube count of the headline (2,635 and 21,080 cubes): CUDA-event ms and
    the host's wall of one call waited for, with a SHA-256 of its output;
    in checkouts that replay it from a CUDA graph, also the eager
    ``_cube_max_angle``."""
    import time

    import torch

    from goicp_tpu_torch.geo import rotation

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

    eager = getattr(rotation, "_cube_max_angle", None)
    out = {}
    for M in (2635, 21080):
        rng = np.random.default_rng(11)
        c = torch.as_tensor(rng.uniform(-2.5, 2.5, (M, 3)).astype(np.float32), device=dev)
        s = torch.as_tensor(rng.uniform(0.005, 0.2, M).astype(np.float32), device=dev)
        call = lambda: rotation.axis_angle_cube_max_angle(c, s)  # noqa: E731
        y = call()
        torch.cuda.synchronize()
        row = dict(ms=smoke.timed_ms(call, 30), host_ms=host_ms(call),
                   sha256=hashlib.sha256(y.cpu().numpy().tobytes()).hexdigest()[:16])
        if eager is not None:
            e = lambda: eager(c, s, 40, 12)  # noqa: E731
            row.update(eager_ms=smoke.timed_ms(e, 30), eager_host_ms=host_ms(e))
        out[f"{M} cubes"] = row
    return out


def trimmed_cases(smoke, fused, S, T, dev):
    """K5's and K6's inputs, by key: (kernel, srcT, wm, params, h, drop)."""
    import torch

    from goicp_tpu_torch.nn.agree import trim_levels

    rng = np.random.default_rng(9)
    se3_pop = max(64, min(4096, int(32e6 / (8 * S.shape[0]))))        # bnb/se3.py auto
    big = torch.as_tensor(smoke.big_source(), device=dev)
    wm = fused.pack_targets(T)
    cases = {}
    for kind, src, count in (("K5", S, 8 * se3_pop), ("K6", S, se3_pop), ("K6", big, 263)):
        N = src.shape[0]
        h = int(round(N * (1.0 - smoke.TRIM)))
        srcX = fused.pack_sources_ext(src, torch.linalg.vector_norm(src, dim=1))
        if kind == "K5":
            Rb, tb, af, gt = smoke.node_batch(rng, count, dev)
            pack = lambda te, tau: fused.pack_params_bounds_trimmed(Rb, tb, af, gt, 0.0, te, tau)  # noqa: E731
            plain = fused.bounds_nodes_trimmed_plain
            what = "nodes"
        else:
            Rg, t8, af, gt8 = smoke.group_batch(rng, count, dev)
            pack = lambda te, tau: fused.pack_group_params_bounds_trimmed(Rg, t8, af, gt8, 0.0, te, tau)  # noqa: E731
            plain = fused.bounds_groups_trimmed_plain
            what = "groups"
        p_open = pack(1e30, 1e30)
        _, lb = plain(srcX, wm, p_open, h=h, drop=N - h)
        _, te, tau = trim_levels(lb, h, N - h)
        shape = f"{count} {what} x {N} x {T.shape[0]}, h {h}"
        cases[f"{kind} {shape} unscreened"] = (kind, srcX, wm, p_open, h, N - h)
        cases[f"{kind} {shape} screened"] = (kind, srcX, wm, pack(te, tau), h, N - h)
    return cases


def trimmed_call(fused, case, route=0):
    """One K5 or K6 call on ``case``; ``route`` forces K5's warps per CTA or
    K6's points per thread (this checkout's helpers)."""
    kind, srcX, wm, params, h, drop = case
    if route:
        fn = fused._k5_kernel if kind == "K5" else fused._k6_kernel
        return fn(srcX, wm, params, h, drop, route)
    fn = fused.bounds_nodes_trimmed if kind == "K5" else fused.bounds_groups_trimmed
    return fn(srcX, wm, params, h=h, drop=drop)


def trimmed_routes(smoke, fused, cases):
    """K5 at every warps-per-CTA count that fits, K6 at 1-3 points per
    thread (where the point block divides), beside the wrappers' picks."""
    out = {}
    for key, case in cases.items():
        kind, srcX, wm, params, _, _ = case
        Np, tq = srcX.shape[1], fused._pick_tile(srcX.shape[1], fused.TQB)
        if kind == "K5":
            picked = fused.k5_plan(params.shape[0], Np, wm.shape[0])["warps"]
            routes = []
            for w in range(1, 9):
                try:
                    fused.k5_plan(params.shape[0], Np, wm.shape[0], w)
                    routes.append(w)
                except RuntimeError:
                    pass
            label = "warps per CTA"
        else:
            picked = fused.k6_qr(tq)
            routes = [q for q in (1, 2, 3) if tq % (32 * q) == 0 and 64 <= tq // q <= 384]
            label = "points per thread"
        out[key] = dict(picked=picked, route=label, ms={
            r: smoke.timed_ms(lambda: trimmed_call(fused, case, r), 5) for r in routes})
    return out


def smoke_rotations(rng, n, dev):
    """``n`` rotations within 0.2 rad of the identity, as the ICP's poses."""
    import torch

    from goicp_tpu_torch.geo.rotation import axis_angle_rotation

    return axis_angle_rotation(torch.as_tensor(
        rng.uniform(-0.2, 0.2, (n, 3)).astype(np.float32), device=dev))


if __name__ == "__main__":
    sys.exit(main())
