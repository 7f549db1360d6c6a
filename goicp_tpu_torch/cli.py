"""Scenario runner — the application entry point (port of the JAX package's ``cli.py``).

Usage::

    python -m goicp_tpu_torch <scenario.toml> [--output DIR] [--profile DIR]
                              [--device cuda|cpu]

Loads the TOML config (the reference's schema, ``core/config.py``), the two
clouds, dispatches on ``params.mode`` (``src/common.h:7-11``), runs the
solver on the card (or on the CPU with ``--device cpu``) and writes the same
artifacts as the JAX CLI: the result TOML, the viz PLY (and PNG when
matplotlib is present), and for solves that publish progress the trajectory
CSV and HTML replay, plus ``metrics.json`` for the Go-ICP modes.

Modes:

- 0 ``ICP_CPU`` / 1 ``ICP_GPU``: iterated ICP with exact nearest neighbours
  (kernel K1).
- 2 ``ICP_KDTREE_GPU``: ICP on the index field of an EDT distance grid (the
  grid replaces the reference's flattened k-d tree).
- 3 ``GOICP_CPU`` / 4 ``GOICP_GPU``: the certified SE(3) branch-and-bound;
  mode 3 pins the axis-angle cube, mode 4 honours ``[tpu] rotation_param``.

``[tpu] full_cert`` certifies the whole source cloud by adaptive subset
refinement (``register_full_cert``), ``--checkpoint``/``checkpoint_path``
snapshots and resumes the BnB, and ``[tpu] engine = "nested"`` runs the
nested engine.  ``[tpu] mesh_cubes``/``mesh_points`` shard the SE(3)
engine's rounds over a device mesh of this process; ``mesh_cubes = 0``
(the default) means every local device: one card on a one-card host, one
shard on the CPU.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

import numpy as np
import torch

from goicp_tpu_torch.bnb import BnbParams, GoIcpResult, make_solver, register_full_cert
from goicp_tpu_torch.core.config import Config, Mode
from goicp_tpu_torch.core.device import resolve_device
from goicp_tpu_torch.core.logging import get_logger
from goicp_tpu_torch.core.progress import ProgressBus, SolverState
from goicp_tpu_torch.core.types import RigidTransform
from goicp_tpu_torch.geo.normals import estimate_normals
from goicp_tpu_torch.icp import (
    IcpParams,
    exact_correspondence,
    grid_correspondence,
    run_icp,
    run_icp_trace,
)
from goicp_tpu_torch.io import load_cloud, write_result_toml
from goicp_tpu_torch.nn.grid import build_distance_grid
from goicp_tpu_torch.viz import TrajectoryRecorder, write_registration_ply


def bnb_params_from_config(cfg: Config) -> BnbParams:
    t = cfg.tpu
    return BnbParams(
        mse_threshold=cfg.mse_threshold,
        trim_fraction=cfg.effective_trim_fraction,
        rotation_param=(
            "axis_angle" if cfg.mode == Mode.GOICP_CPU else t.rotation_param
        ),
        lookup=t.lookup,
        grid_resolution=t.grid_resolution,
        grid_expand=t.grid_expand,
        rot_pop=t.rot_batch,
        engine=t.engine,
        bound_backend=t.bound_backend,
        grid_method=t.grid_method,
        conservative=t.conservative,
        checkpoint_path=t.checkpoint_path or None,
        checkpoint_every=t.checkpoint_every,
        mesh_cubes=t.mesh_cubes,
        mesh_points=t.mesh_points,
        # honor [params.rotation/translation].search_depth: depth d ⇒
        # subdivision floor at root_span / 2^d (cli.py:74-81)
        min_rot_span=max(t.min_rot_span, 2.0 ** -cfg.rotation.search_depth),
        min_trans_span=max(
            t.min_trans_span,
            cfg.translation.span * 2.0 ** -cfg.translation.search_depth,
        ),
        se3_pop=t.se3_pop,
        trans_span=cfg.translation.span,
        trans_center=cfg.translation.center,
        icp_refine_factor=t.icp_refine_factor,
        icp_max_iter=t.icp_max_iter,
        icp_rel_tol=t.icp_rel_tol,
        icp_metric=t.icp_metric,
        normals_k=t.normals_k,
        max_wall_s=t.max_wall_s,
    )


def run_icp_mode(cfg: Config, src, tgt, bus: ProgressBus | None = None, device=None):
    """Modes 0/1/2: plain iterated ICP from the identity (``cli.py:94``).

    With a ``bus``, the traced runner records every iteration's pose and
    SSE and publishes them as :class:`SolverState` snapshots (the
    reference's frame-per-iteration animation, ``main.cpp:99-141``)."""
    dev = resolve_device(device)
    params = IcpParams(
        max_iter=cfg.tpu.icp_max_iter,
        rel_tol=min(cfg.tpu.icp_rel_tol, cfg.mse_threshold),
        trim_fraction=cfg.effective_trim_fraction,
        metric=cfg.tpu.icp_metric,
    )
    src_t = torch.as_tensor(np.asarray(src, np.float32), device=dev)
    tgt_t = torch.as_tensor(np.asarray(tgt, np.float32), device=dev)
    normals = None
    if cfg.tpu.icp_metric == "plane":
        normals = estimate_normals(tgt_t, k=cfg.tpu.normals_k)
    if cfg.mode == Mode.ICP_KDTREE_GPU:
        grid = build_distance_grid(
            tgt_t, n=cfg.tpu.grid_resolution, method="edt", with_index=True
        )
        corr = grid_correspondence(grid, tgt_t, normals=normals)
    else:
        corr = exact_correspondence(tgt_t, normals=normals)
    init = RigidTransform.identity(device=dev)

    def _wall(t0):
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        return time.perf_counter() - t0

    t0 = time.perf_counter()
    if bus is not None:
        res, trace = run_icp_trace(src_t, corr, init, params)
        wall = _wall(t0)
        R_tr, t_tr, sse_tr, act = (x.cpu().numpy() for x in trace)
        best = np.inf
        opt_R, opt_t = np.eye(3, dtype=np.float32), np.zeros(3, np.float32)
        for k in range(R_tr.shape[0]):
            if not act[k]:
                break
            if sse_tr[k] < best:
                best, opt_R, opt_t = float(sse_tr[k]), R_tr[k], t_tr[k]
            bus.publish(SolverState(
                opt_R=opt_R, opt_t=opt_t, cur_R=R_tr[k], cur_t=t_tr[k],
                best_sse=best, gap=0.0, finished=False,
                rot_nodes=0, trans_nodes=0, round=k,
            ))
    else:
        res = run_icp(src_t, corr, init, params)
        wall = _wall(t0)
    sse = float(res.sse)
    n_eff = max(1, int(round(src.shape[0] * (1 - cfg.effective_trim_fraction))))
    return {
        "R": res.transform.R.cpu().numpy(),
        "t": res.transform.t.cpu().numpy(),
        "sse": sse,
        "mse": sse / n_eff,
        # ≙ main.cpp:125-135: only reaching mse_threshold is success
        "converged": sse / n_eff <= cfg.mse_threshold,
        "icp_iters": int(res.iters),
        "rot_nodes": 0,
        "trans_nodes": 0,
        "wall_s": wall,
        "metrics": {},
    }


def run_goicp_mode(cfg: Config, src, tgt, bus: ProgressBus, device=None):
    """Modes 3/4: the certified solve (``cli.py:160``); with ``[tpu]
    full_cert`` its certificate covers the full source cloud."""
    params = bnb_params_from_config(cfg)
    if cfg.tpu.full_cert:
        res: GoIcpResult = register_full_cert(
            src, tgt, params, progress=bus, device=device,
            target_gap_mse=cfg.tpu.full_cert_mse or None,
        )
    else:
        res = make_solver(src, tgt, params, progress=bus, device=device).run()
    return {
        "R": np.asarray(res.transform.R),
        "t": np.asarray(res.transform.t),
        "sse": res.sse,
        "mse": res.mse,
        "converged": res.converged,
        "icp_iters": res.icp_iters,
        "rot_nodes": res.rot_nodes,
        "trans_nodes": res.trans_nodes,
        "wall_s": res.wall_s,
        "metrics": res.metrics.summary(),
        # full-cloud certificate fields (bound_points-capped solves only)
        "gap": res.gap,
        "sse_full": res.sse_full,
        "mse_full": res.mse_full,
        "gap_full": res.gap_full,
    }


def run_scenario(
    toml_path: str,
    output_dir: str | None = None,
    checkpoint: str | None = None,
    device=None,
) -> dict:
    """Full scenario: load → solve → artifacts (``cli.py:193``).  Returns the
    result dict.  ``device=None`` means CUDA."""
    log = get_logger()
    dev = resolve_device(device)
    log.info(
        "backend: %d x %s",
        torch.cuda.device_count() if dev.type == "cuda" else 1,
        torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu",
    )
    cfg = Config.from_toml(toml_path)
    if checkpoint:
        cfg.tpu.checkpoint_path = checkpoint
    seed = cfg.tpu.seed
    src = load_cloud(cfg.resolve(cfg.io.source), cfg.subsample, cfg.resize, seed)
    tgt = load_cloud(cfg.resolve(cfg.io.target), cfg.subsample, cfg.resize, seed)
    bus = ProgressBus()
    rec = TrajectoryRecorder(bus)
    outdir = output_dir or os.getcwd()
    if cfg.tpu.snapshot_every_s > 0:
        from goicp_tpu_torch.viz import LiveSnapshotter

        LiveSnapshotter(
            bus,
            os.path.join(outdir, "snapshots"),
            tgt,
            src,
            every_s=cfg.tpu.snapshot_every_s,
            png=cfg.tpu.snapshot_png,
            html=cfg.tpu.snapshot_html,
        )

    t0 = time.perf_counter()
    if cfg.mode in (Mode.ICP_CPU, Mode.ICP_GPU, Mode.ICP_KDTREE_GPU):
        out = run_icp_mode(cfg, src, tgt, bus, device=dev)
    else:
        out = run_goicp_mode(cfg, src, tgt, bus, device=dev)
    out["total_wall_s"] = time.perf_counter() - t0
    out["scenario"] = os.path.basename(toml_path)
    out["n_src"], out["n_tgt"] = src.shape[0], tgt.shape[0]

    os.makedirs(outdir, exist_ok=True)
    result_path = os.path.join(outdir, os.path.basename(cfg.io.output) or "output.toml")
    viz_path = os.path.join(
        outdir, os.path.basename(cfg.io.visualization) or "viz.ply"
    )
    write_result_toml(
        result_path,
        out["R"],
        out["t"],
        out["mse"],
        out["sse"],
        mode=int(cfg.mode),
        converged=out["converged"],
        rot_nodes=out["rot_nodes"],
        trans_nodes=out["trans_nodes"],
        icp_iters=out["icp_iters"],
        wall_s=out["wall_s"],
        extra={
            "scenario": out["scenario"], "n_src": out["n_src"],
            "n_tgt": out["n_tgt"],
            # full-cloud certificate (present only when the BnB solved a
            # bound_points subset — see GoIcpResult field docs)
            **{
                k: out[k]
                for k in ("gap", "sse_full", "mse_full", "gap_full")
                if out.get(k) is not None
            },
        },
    )
    write_registration_ply(viz_path, tgt, src, out["R"], out["t"])
    try:
        from goicp_tpu_torch.viz import render_png

        render_png(
            os.path.splitext(viz_path)[0] + ".png",
            tgt, src, out["R"], out["t"],
            phi=cfg.viz.phi, theta=cfg.viz.theta,
        )
    except Exception:  # matplotlib optional
        pass
    if rec.states:
        rec.dump_csv(os.path.join(outdir, "trajectory.csv"))
        from goicp_tpu_torch.viz import render_html

        # interactive replay of the solve (incumbent red / explored white /
        # model blue) — the headless form of watching the reference's window
        render_html(
            os.path.splitext(viz_path)[0] + ".html", tgt, src, rec.states,
            phi=cfg.viz.phi or 0.35,
            theta=cfg.viz.theta or 0.6,
            spin=cfg.viz.spin_after_finish,
        )
    if out["metrics"]:
        with open(os.path.join(outdir, "metrics.json"), "w") as f:
            json.dump(out["metrics"], f, indent=2, sort_keys=True, default=float)
            f.write("\n")
    log.info(
        "Scenario %s: mode=%d mse=%.6g converged=%s wall=%.2fs → %s",
        out["scenario"],
        int(cfg.mode),
        out["mse"],
        out["converged"],
        out["wall_s"],
        result_path,
    )
    out["output_toml"] = result_path
    out["viz_ply"] = viz_path
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="goicp_tpu_torch",
        description="(Go-)ICP registration on an NVIDIA GPU (PyTorch/CUDA port)",
    )
    ap.add_argument("config", help="scenario TOML (reference-compatible schema)")
    ap.add_argument("--output", default=None, help="artifact directory (default: cwd)")
    ap.add_argument(
        "--profile",
        default=None,
        metavar="DIR",
        help="capture a torch.profiler trace of the run into DIR/trace.json",
    )
    ap.add_argument(
        "--checkpoint",
        default=None,
        metavar="PATH",
        help="BnB frontier snapshot file: resumed from when it exists, written "
             "every [tpu] checkpoint_every rounds",
    )
    ap.add_argument(
        "--device",
        default="cuda",
        choices=("cuda", "cpu"),
        help="run on the CUDA device (default) or on the CPU's plain path",
    )
    args = ap.parse_args(argv)

    def run():
        return run_scenario(args.config, args.output, checkpoint=args.checkpoint,
                            device=args.device)

    if args.profile:
        from torch.profiler import ProfilerActivity, profile

        acts = [ProfilerActivity.CPU]
        if args.device == "cuda":
            acts.append(ProfilerActivity.CUDA)
        with profile(activities=acts) as prof:
            out = run()
        os.makedirs(args.profile, exist_ok=True)
        prof.export_chrome_trace(os.path.join(args.profile, "trace.json"))
    else:
        out = run()
    print(
        f"mode={out['scenario']} mse={out['mse']:.6g} sse={out['sse']:.6g} "
        f"converged={out['converged']} wall={out['wall_s']:.2f}s"
    )
    return 0 if out["converged"] else 1


if __name__ == "__main__":
    sys.exit(main())
