"""Flat SE(3) product-space BnB — the global solver engine (port of the JAX
package's ``bnb/se3.py``).

One best-first BnB over ``SO(3) × R³``.  Each node is a (rotation cube,
translation cube) pair with

    ub = Σ d(R_c p_i + t_c)²
    lb = Σ max(d(R_c p_i + t_c) − γr_i − γt, 0)²          (Yang et al. eq. 10)

and splits 8-way along whichever cube contributes more uncertainty.  Every
round pops a batch from the native frontier, evaluates all children's bounds
in one queued device round and refines the best few by batched ICP.  With
``checkpoint_path`` the frontiers and the incumbent are saved every
``checkpoint_every`` rounds and a solve resumes from the file when it
exists; the snapshot's format is the JAX package's, so either package
resumes the other's.  With ``mesh_cubes``/``mesh_points`` the rounds run
over a (cubes × points) mesh of this process's devices
(:mod:`goicp_tpu_torch.dist.se3`); a mesh keeps host angles (no
center-aware bound), as in the JAX package.
"""

from __future__ import annotations

import math
import os
import time
from collections import deque
from typing import Optional

import numpy as np

from goicp_tpu_torch.bnb.params import GoIcpResult
from goicp_tpu_torch.bnb.rounds import Se3RoundDriver
from goicp_tpu_torch.bnb.solver import GoIcpSolver, load_checkpoint, save_checkpoint
from goicp_tpu_torch.core.progress import SolverState
from goicp_tpu_torch.core.types import RigidTransform


def inflight_snapshot(drv, inflight, nodes: int):
    """What a checkpoint holds (``se3.py:158``): the frontiers, plus the
    popped parents of the rounds still queued (in neither frontier nor any
    pushed child; a resume re-expands them), and the node count ``nodes``
    less those rounds' children, which are already counted.  Returns
    ``(payload, lb, ub, nodes)``."""
    pay, lb, ub = drv.dump_frontiers()
    for w in inflight:
        ppay, plb, pub = w["parents"]
        if ppay.shape[0]:
            pay = np.concatenate([pay, ppay])
            lb = np.concatenate([lb, plb])
            ub = np.concatenate([ub, pub])
    return pay, lb, ub, nodes - sum(pt[-1] for w in inflight for pt in w["parts"])


class GoIcpSolverSE3(GoIcpSolver):
    """Product-space engine: owns the pipelined dispatch/absorb loop; the
    per-round machinery lives in :class:`bnb.rounds.Se3RoundDriver`."""

    def run(self, init: Optional[RigidTransform] = None) -> GoIcpResult:
        p, m = self.p, self.metrics
        t_start = time.perf_counter()

        best_R, best_t, best_sse = self._initial_icp(init)
        self.log.info(
            "Initial ICP: sse=%.6g mse=%.6g", best_sse, best_sse / self.ev.h
        )

        rounds = 0
        converged = best_sse <= self.sse_thresh
        se3_pop = p.se3_pop or max(
            64, min(4096, int(32e6 / (8 * self.src.shape[0])))
        )
        M_cap = 8 * se3_pop
        # the (cubes × points) mesh of this process's devices: each round's
        # jobs over cubes, the source over points (None: one device)
        from goicp_tpu_torch.dist.se3 import make_engine_mesh

        mesh = None
        _mesh = make_engine_mesh(
            p, self._backend, self.src, self.ev.norms.cpu().numpy(),
            h=(self.ev.h if p.trim_fraction > 0 else 0),
            icp_params=self._icp_params_round_mesh, icp_backend=self._icp_backend,
            device=self.device, log=self.log,
        )
        if _mesh is not None:
            sharded_round, src_pad, norms_pad, n_c, _ = _mesh
            M_cap = -(-M_cap // n_c) * n_c
            mesh = (sharded_round, src_pad, norms_pad, n_c)
        # center-aware rotation-cube angle bound, computed inside each round
        # (a mesh round takes host angles)
        tight_ang = (p.tight_rot_bound and p.rotation_param == "axis_angle"
                     and mesh is None)

        drv = Se3RoundDriver(
            self, pop_cap=se3_pop, M_cap=M_cap, mesh=mesh, tight_ang=tight_ang,
        )
        drv.best_R, drv.best_t, drv.best_sse = best_R, best_t, best_sse
        drv.push_root()
        inflight = deque()

        if p.checkpoint_path and os.path.exists(p.checkpoint_path):
            ck = load_checkpoint(p.checkpoint_path)
            drv.reset_frontiers()
            drv.push_classified(ck["payload"], ck["lb"], ck["ub"])
            if float(ck["best_sse"]) < drv.best_sse:
                drv.best_sse = float(ck["best_sse"])
                drv.best_R, drv.best_t = ck["best_R"], ck["best_t"]
            drv.leaf_lb = float(ck["leaf_lb"])
            rounds = int(ck["rounds"])
            m.count("se3_nodes", int(ck["nodes"]))
            self.log.info(
                "resumed from %s: round %d, frontier %d, best sse %.6g",
                p.checkpoint_path, rounds, drv.f_len(), drv.best_sse,
            )

        def checkpoint():
            """Frontiers + incumbent, with the queued rounds' parents."""
            pay, lb, ub, nodes = inflight_snapshot(
                drv, inflight, m.counters.get("se3_nodes", 0))
            save_checkpoint(
                p.checkpoint_path, pay, lb, ub, drv.best_R, drv.best_t,
                drv.best_sse, drv.leaf_lb, rounds, nodes,
            )

        def absorb(work):
            """Absorb one round, then the engine-side bookkeeping."""
            nonlocal converged
            drv.absorb(work)
            if drv.best_sse <= self.sse_thresh:
                converged = True
            if p.checkpoint_path and rounds % max(p.checkpoint_every, 1) == 0:
                checkpoint()
            if rounds % 10 == 0:
                self.log.info(
                    "round %d: best=%.5g frontier=%d+%d min_lb=%.4g leaf_lb=%.4g",
                    rounds, drv.best_sse, len(drv.fR), len(drv.fT),
                    drv.f_min_lb(), drv.leaf_lb,
                )
            child0, _, R_c0, _, _ = work["parts"][0]
            self.progress.publish(
                SolverState(
                    opt_R=drv.best_R,
                    opt_t=drv.best_t,
                    cur_R=R_c0[0],
                    cur_t=child0[0, 4:7],
                    best_sse=drv.best_sse,
                    gap=drv.best_sse - min(drv.f_min_lb(), drv.leaf_lb),
                    finished=False,
                    rot_nodes=int(m.counters.get("se3_nodes", 0)),
                    trans_nodes=int(m.counters.get("se3_nodes", 0)),
                    round=rounds,
                )
            )

        # Up to pipeline_depth rounds queued: round k+d is dispatched (popping
        # a disjoint frontier slice) before round k is absorbed.  Staleness
        # only weakens incumbent-driven pruning by a few rounds.
        budget_exceeded = False
        depth = max(1, p.pipeline_depth)
        with m.phase("bnb"):
            while True:
                if (
                    not budget_exceeded
                    and time.perf_counter() - t_start > p.max_wall_s
                ):
                    budget_exceeded = True
                    self.log.warning(
                        "wall budget %.0fs exceeded at round %d (gap %.4g)",
                        p.max_wall_s, rounds,
                        drv.best_sse - min(drv.f_min_lb(), drv.leaf_lb),
                    )
                can_dispatch = (
                    rounds < p.max_rounds
                    and drv.f_len()
                    and not converged
                    and not budget_exceeded
                )
                if can_dispatch and not inflight:
                    # gap test only in a settled state
                    gap_lb = min(drv.f_min_lb(), drv.leaf_lb)
                    if drv.best_sse - gap_lb <= self.sse_thresh:
                        converged = True
                        can_dispatch = False
                if can_dispatch and len(inflight) < depth:
                    rounds += 1
                    work = (
                        drv.dispatch_T(rounds)
                        if len(drv.fT) and drv.fT.min_lb() <= drv.fR.min_lb()
                        else drv.dispatch_singleton(drv.fR, rounds)
                    )
                    if work["parts"]:
                        inflight.append(work)
                    continue
                if inflight:
                    absorb(inflight.popleft())
                    continue
                gap_lb = min(drv.f_min_lb(), drv.leaf_lb)
                if (
                    converged
                    or drv.best_sse - gap_lb <= self.sse_thresh
                    or not drv.f_len()
                    or rounds >= p.max_rounds
                    or budget_exceeded
                ):
                    if drv.best_sse - gap_lb <= self.sse_thresh or not drv.f_len():
                        converged = True
                    break

        if not drv.f_len() and not converged:
            converged = True

        best_R, best_t, best_sse = self._full_polish(
            drv.best_R, drv.best_t, drv.best_sse
        )
        gap = best_sse - min(drv.f_min_lb(), drv.leaf_lb)
        sse_full, mse_full, gap_full = self._full_cert(best_R, best_t, best_sse, gap)
        wall = time.perf_counter() - t_start
        nodes = int(m.counters.get("se3_nodes", 0))
        result = GoIcpResult(
            transform=RigidTransform(best_R, best_t),
            sse=best_sse,
            mse=best_sse / self.ev.h,
            converged=converged,
            gap=float(max(gap, 0.0)) if math.isfinite(gap) else 0.0,
            rot_nodes=nodes,
            trans_nodes=nodes,
            icp_iters=int(m.counters.get("icp_iters", 0)),
            rounds=rounds,
            wall_s=wall,
            metrics=m,
            sse_full=sse_full,
            mse_full=mse_full,
            gap_full=gap_full,
        )
        self.progress.publish(
            SolverState(
                opt_R=best_R, opt_t=best_t, cur_R=best_R, cur_t=best_t,
                best_sse=best_sse, gap=result.gap, finished=True,
                rot_nodes=nodes, trans_nodes=nodes, round=rounds,
            )
        )
        self.log.info(
            "Go-ICP(SE3) done: sse=%.6g mse=%.6g rounds=%d nodes=%d wall=%.2fs",
            result.sse, result.mse, rounds, nodes, wall,
        )
        return result
