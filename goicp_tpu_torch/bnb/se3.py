"""Flat SE(3) product-space BnB — the global solver engine (port of the JAX
package's ``bnb/se3.py``, single device, without the device mesh and
checkpoints).

One best-first BnB over ``SO(3) × R³``.  Each node is a (rotation cube,
translation cube) pair with

    ub = Σ d(R_c p_i + t_c)²
    lb = Σ max(d(R_c p_i + t_c) − γr_i − γt, 0)²          (Yang et al. eq. 10)

and splits 8-way along whichever cube contributes more uncertainty.  Every
round pops a batch from the native frontier, evaluates all children's bounds
in one queued device round and refines the best few by batched ICP.
"""

from __future__ import annotations

import math
import time
from collections import deque
from typing import Optional

from goicp_tpu_torch.bnb.params import GoIcpResult
from goicp_tpu_torch.bnb.rounds import Se3RoundDriver
from goicp_tpu_torch.bnb.solver import GoIcpSolver
from goicp_tpu_torch.core.progress import SolverState
from goicp_tpu_torch.core.types import RigidTransform


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
        # center-aware rotation-cube angle bound, computed inside each round
        tight_ang = p.tight_rot_bound and p.rotation_param == "axis_angle"

        drv = Se3RoundDriver(
            self, pop_cap=se3_pop, M_cap=M_cap, tight_ang=tight_ang,
        )
        drv.best_R, drv.best_t, drv.best_sse = best_R, best_t, best_sse
        drv.push_root()
        inflight = deque()

        def absorb(work):
            """Absorb one round, then the engine-side bookkeeping."""
            nonlocal converged
            drv.absorb(work)
            if drv.best_sse <= self.sse_thresh:
                converged = True
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
