#!/usr/bin/env python3
"""Time the nearest-neighbour kernels K1 and K4 and the trimmed bound
kernels K5 and K6 of the ``goicp_tpu_torch`` package found under ROOT, on
one GPU::

    python3 nn_ab.py [ROOT]        # ROOT: a checkout (default: this one)
    python3 nn_ab.py --routes      # K1, K5, K6 on every launch route, this checkout
    python3 nn_ab.py [ROOT] --trace  # also trace ROOT's trimmed screen solve

Run it for two checkouts in one session, in turns (A, B, B, A), to compare
them on one card.  The shapes are ``chip_smoke.py``'s, on the in-repo bunny
pair: K1 at each shape of ``k1_shapes``, K4 at the largest R-round bucket
(8·se3_pop nodes) and with 20,000 targets, K5 at that bucket and K6 at
se3_pop groups and at 263 groups of a 4,096-point source (h = 0.75·N), each
unscreened and screened at half the median positive lb (``trim_levels``).
It reports, per K1 shape:

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
per thread) route, beside the one ``nn_route`` picks, K5 at every count of
warps per CTA that fits, and K6 at 1, 2 and 3 points per thread.
``--trace`` then runs ``chip_smoke.py``'s traced trimmed solve on
``bound_backend="screen"`` (30 s budget; busy share, device time by
kernel, K5/K6 launches) with ROOT's package.  The last line printed is
one JSON object; exits non-zero without CUDA.
"""

from __future__ import annotations

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
    cases = trimmed_cases(smoke, fused, S, T, dev)
    if routes:
        out["trimmed_routes"] = trimmed_routes(smoke, fused, cases)
        print(json.dumps(out), flush=True)
        return 0
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
    if trace:
        psrc, ptgt, pR, pt = smoke.load_bunny_partial()
        out["trace"] = smoke.profile_solve(smoke.Checks(), dev, "trimmed screen solve", psrc, ptgt,
                                           pR, pt, smoke.TRIM, smoke.PROFILE_TRIM_WALL_S,
                                           bound_backend="screen")
    print(json.dumps(out), flush=True)
    return 0


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
