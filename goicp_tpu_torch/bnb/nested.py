"""The nested (reference-shaped) engine: an outer rotation BnB on the host
whose every round runs the inner translation BnB of all its child cubes in
one device call (port of ``GoIcpSolver.run`` of the JAX package's
``bnb/solver.py:543``).

Each round pops the ``rot_pop`` best rotation cubes, splits them 8-way
(keeping the children :meth:`rotparam.valid` accepts), pads the children to
``8·rot_pop`` with −inf caps (dead after one level) and calls
:func:`bnb.device_inner.inner_bnb_device`.  The promising children and the
``refine_top_k`` best by upper bound are ICP-refined in one batch; the
survivors go back on the frontier, and children below the span floor fold
their lower bounds into ``leaf_lb``.  With ``checkpoint_path`` the
frontier and the incumbent are saved every ``checkpoint_every`` rounds, in
the JAX package's format; the loop is synchronous, so that is the whole
search state.  Device meshes are not used by this engine: with
``mesh_cubes``/``mesh_points`` above 1 it warns and runs on one device, as
the JAX package does.
"""

from __future__ import annotations

import math
import os
import time
from typing import Optional

import numpy as np
import torch

from goicp_tpu_torch.bnb.device_inner import inner_bnb_device
from goicp_tpu_torch.bnb.frontier import make_cube_frontier
from goicp_tpu_torch.bnb.params import GoIcpResult
from goicp_tpu_torch.bnb.rounds import _OCTANTS
from goicp_tpu_torch.bnb.solver import GoIcpSolver, load_checkpoint, save_checkpoint
from goicp_tpu_torch.core.progress import SolverState
from goicp_tpu_torch.core.types import RigidTransform


class GoIcpSolverNested(GoIcpSolver):
    """Outer SO(3) BnB / inner R³ BnB engine (``engine="nested"``)."""

    def run(self, init: Optional[RigidTransform] = None) -> GoIcpResult:
        p, m = self.p, self.metrics
        t_start = time.perf_counter()
        if max(p.mesh_cubes, p.mesh_points) > 1:
            self.log.warning(
                "engine='nested' runs single-device; mesh_cubes/mesh_points "
                "are honored by the SE(3) engine only (engine='se3')"
            )
        best_R, best_t, best_sse = self._initial_icp(init)
        self.log.info("Initial ICP: sse=%.6g mse=%.6g", best_sse, best_sse / self.ev.h)

        frontier = make_cube_frontier()
        frontier.push(np.zeros((1, 3)), [self.rotparam.root_span], [0.0], [np.inf])
        rot_lb_leaf = float("inf")
        rounds = 0
        converged = best_sse <= self.sse_thresh  # ≙ fgoicp.cpp:21-24

        if p.checkpoint_path and os.path.exists(p.checkpoint_path):
            ck = load_checkpoint(p.checkpoint_path)
            frontier = make_cube_frontier()
            pay = ck["payload"]
            frontier.push(pay[:, :3], pay[:, 3], ck["lb"], ck["ub"])
            if float(ck["best_sse"]) < best_sse:
                best_sse = float(ck["best_sse"])
                best_R, best_t = ck["best_R"], ck["best_t"]
            rot_lb_leaf = float(ck["leaf_lb"])
            rounds = int(ck["rounds"])
            m.count("rot_nodes", int(ck["nodes"]))
            self.log.info(
                "resumed from %s: round %d, frontier %d, best sse %.6g",
                p.checkpoint_path, rounds, len(frontier), best_sse,
            )

        # the nested device-inner loop has no fused-kernel path: "mxu" and
        # "screen" run the exact expansion there, as in the JAX package
        # (solver.py:672-677)
        exact = self._backend in ("exact", "mxu", "screen")
        inner_kw = dict(
            levels=p.inner_levels, C=p.inner_cap,
            h=(self.ev.h if p.trim_fraction > 0 else 0), lookup=p.lookup,
            tile=p.point_tile, backend="exact" if exact else "grid",
        )
        slack = self._exact_slack if exact else self.ev.slack
        t_center = self._to(np.asarray(p.trans_center, np.float32))
        G_cap = 8 * p.rot_pop
        rot_floor = p.min_rot_span * self.rotparam.root_span

        with m.phase("bnb"):
            while not converged and len(frontier) and rounds < p.max_rounds:
                gap_lb = min(frontier.min_lb(), rot_lb_leaf)
                if best_sse - gap_lb <= self.sse_thresh:  # ≙ fgoicp.cpp:44-47
                    converged = True
                    break
                if time.perf_counter() - t_start > p.max_wall_s:
                    self.log.warning(
                        "wall budget %.0fs exceeded at round %d (gap %.4g)",
                        p.max_wall_s, rounds, best_sse - gap_lb,
                    )
                    break
                rounds += 1
                cen, spn, _, _ = frontier.pop_best(p.rot_pop)
                # 8-way children (≙ fgoicp.cpp:53-60)
                half = (spn / 2.0)[:, None]
                ccen = (cen[:, None, :] + _OCTANTS[None] * half[:, None, :]).reshape(-1, 3)
                cspn = np.repeat(spn / 2.0, 8)
                ok = self.rotparam.valid(ccen, cspn)
                ccen, cspn = ccen[ok], cspn[ok]
                C = ccen.shape[0]
                if C == 0:
                    continue
                m.count("rot_nodes", C)
                R_c = self.rotparam.rotation(ccen)
                ang_c = self.rotparam.max_angle(ccen, cspn).astype(np.float32)

                # one device call runs the dual-mode inner BnB of every child,
                # padded to G_cap; padding gets −inf caps and dies after one
                # level.  The ub search matters only below the ICP trigger
                # (refine_factor·best), the lb search below best.
                padn = G_cap - C
                R_pad = np.concatenate([R_c, np.tile(np.eye(3, dtype=np.float32), (padn, 1, 1))])
                ang_pad = np.concatenate([ang_c, np.zeros(padn, np.float32)])
                cap_ub = np.full(G_cap, p.icp_refine_factor * best_sse, np.float32)
                cap_lb = np.full(G_cap, best_sse, np.float32)
                cap_ub[C:] = -np.inf
                cap_lb[C:] = -np.inf
                inc_ub, inc_lb, t_g, _, unres_lb, nodes = inner_bnb_device(
                    self._src_dev, self.ev.norms, self.grid, self._tgt_dev, slack,
                    self._to(R_pad), self._to(ang_pad), self._to(cap_ub), self._to(cap_lb),
                    t_center, p.trans_span, self.sse_thresh, p.min_trans_span, **inner_kw,
                )
                ub_c = inc_ub.cpu().numpy()[:C]
                lb_c = torch.minimum(inc_lb, unres_lb).cpu().numpy()[:C]
                t_ub = t_g.cpu().numpy()[:C]
                m.count("trans_nodes", nodes)

                # ICP-refine all promising children in one batch (≙ the relaxed
                # trigger, fgoicp.cpp:75), and always the round's top-k by ub
                promising = ub_c < p.icp_refine_factor * best_sse
                if p.refine_top_k:
                    k = min(p.refine_top_k, C)
                    top = np.argpartition(ub_c, k - 1)[:k]
                    promising[top[np.isfinite(ub_c[top])]] = True
                if promising.any():
                    with m.phase("icp"):
                        Rs, ts, sses, iters = self._refine(R_c[promising], t_ub[promising])
                    m.count("icp_iters", int(iters.sum()))
                    j = int(np.argmin(sses))
                    if float(sses[j]) < best_sse:
                        best_sse = float(sses[j])
                        best_R, best_t = Rs[j], ts[j]
                        dropped = frontier.prune(best_sse)
                        self.log.info(
                            "round %d: new best sse=%.6g (mse=%.6g), pruned %d cubes",
                            rounds, best_sse, best_sse / self.ev.h, dropped,
                        )
                # direct incumbent update from the bound evaluation
                j = int(np.argmin(ub_c))
                if float(ub_c[j]) < best_sse:
                    best_sse = float(ub_c[j])
                    best_R, best_t = R_c[j], t_ub[j]
                    frontier.prune(best_sse)

                # push surviving children (≙ fgoicp.cpp:97-101)
                alive = lb_c < best_sse - self.sse_thresh
                at_floor = alive & (cspn / 2.0 < rot_floor)
                if at_floor.any():
                    rot_lb_leaf = min(rot_lb_leaf, float(lb_c[at_floor].min()))
                keep = alive & ~at_floor
                if keep.any():
                    frontier.push(ccen[keep], cspn[keep], lb_c[keep], ub_c[keep])

                if best_sse <= self.sse_thresh:
                    converged = True
                if p.checkpoint_path and rounds % max(p.checkpoint_every, 1) == 0:
                    pay, lb, ub = frontier.dump()
                    save_checkpoint(p.checkpoint_path, pay, lb, ub, best_R, best_t, best_sse,
                                    rot_lb_leaf, rounds, m.counters.get("rot_nodes", 0))
                if rounds % 10 == 0:
                    self.log.info(
                        "round %d: best=%.5g frontier=%d min_lb=%.4g leaf_lb=%.4g",
                        rounds, best_sse, len(frontier), frontier.min_lb(), rot_lb_leaf,
                    )
                self.progress.publish(SolverState(
                    opt_R=best_R, opt_t=best_t, cur_R=R_c[0], cur_t=t_ub[0],
                    best_sse=best_sse, gap=best_sse - min(frontier.min_lb(), rot_lb_leaf),
                    finished=False, rot_nodes=int(m.counters["rot_nodes"]),
                    trans_nodes=int(m.counters["trans_nodes"]), round=rounds,
                ))

        if not len(frontier) and not converged:
            # frontier exhausted: the search space is covered to the span
            # floor, optimal within the floor's resolution
            converged = True

        best_R, best_t, best_sse = self._full_polish(best_R, best_t, best_sse)
        gap = best_sse - min(frontier.min_lb(), rot_lb_leaf)
        sse_full, mse_full, gap_full = self._full_cert(best_R, best_t, best_sse, gap)
        wall = time.perf_counter() - t_start
        result = GoIcpResult(
            transform=RigidTransform(best_R, best_t),
            sse=best_sse,
            mse=best_sse / self.ev.h,
            converged=converged,
            gap=float(max(gap, 0.0)) if math.isfinite(gap) else 0.0,
            rot_nodes=int(m.counters["rot_nodes"]),
            trans_nodes=int(m.counters["trans_nodes"]),
            icp_iters=int(m.counters["icp_iters"]),
            rounds=rounds,
            wall_s=wall,
            metrics=m,
            sse_full=sse_full,
            mse_full=mse_full,
            gap_full=gap_full,
        )
        self.progress.publish(SolverState(
            opt_R=best_R, opt_t=best_t, cur_R=best_R, cur_t=best_t, best_sse=best_sse,
            gap=result.gap, finished=True, rot_nodes=result.rot_nodes,
            trans_nodes=result.trans_nodes, round=rounds,
        ))
        self.log.info(
            "Go-ICP done: sse=%.6g mse=%.6g rounds=%d rot_nodes=%d trans_nodes=%d wall=%.2fs",
            result.sse, result.mse, rounds, result.rot_nodes, result.trans_nodes, wall,
        )
        return result
