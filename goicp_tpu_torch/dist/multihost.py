"""Multi-process Go-ICP: the BnB frontier sharded across the processes of a
``torch.distributed`` group (port of the JAX package's
``dist/multihost.py``).

- **Disjoint partition.**  Every process expands the same root and keeps
  only the children whose index ≡ its rank (mod P); children inherit the
  partition, so the local frontiers stay disjoint and cover SE(3) together.
- **Pipelined lockstep.**  Each iteration a process dispatches one round
  ahead (up to ``pipeline_depth`` queued) or absorbs the oldest; every
  ``mh_exchange_every`` iterations all processes join one all-gather of 16
  floats: incumbent sse and pose, the least lower bound (queued parents
  included) and the work left, and a stop flag.  Pruning against a stale
  global incumbent is conservative: a stale incumbent is never below the
  true one.
- **Rebalancing.**  When a process cannot fill a round, or the largest
  frontier holds more than twice the smallest, every process offers its
  best nodes of both frontiers; the merged set, sorted by lower bound, is
  dealt out by index mod P, so every node lands on exactly one process.
- **Termination.**  Converged when the global incumbent is within ε of the
  least lower bound or no work is left; every process sees the same
  gathered values, so all stop on the same iteration.
- **Checkpoints.**  Each process writes its own slice ``{path}.p{rank}of{P}``
  in the JAX package's format at the same global iteration; a resume needs
  every process to hold a slice of the same iteration (a consistent cut).

The caller initialises the process group (``init_process_group``), as the
JAX package's caller runs ``jax.distributed.initialize``; every process
builds the solver with the same clouds and parameters.  The exchanged
records are host numpy, gathered as CPU tensors; when the default group is
not gloo (NCCL on a many-card host) a gloo group carries them.  Each
process solves on ``cuda:{rank % device_count}`` unless told otherwise, and
may shard its own rounds over a local mesh (``mesh_cubes``/``mesh_points``)
with no collectives between processes.
"""

from __future__ import annotations

import math
import os
import time
from collections import deque
from typing import Optional

import numpy as np
import torch
import torch.distributed as dist

from goicp_tpu_torch.bnb.params import BnbParams, GoIcpResult
from goicp_tpu_torch.bnb.rounds import Se3RoundDriver
from goicp_tpu_torch.bnb.solver import GoIcpSolver
from goicp_tpu_torch.core.device import resolve_device
from goicp_tpu_torch.core.progress import SolverState
from goicp_tpu_torch.core.types import RigidTransform
from goicp_tpu_torch.dist.se3 import make_engine_mesh

_gloo = {}


def _exchange_group():
    """The group that carries the host records: the default group when it
    is gloo, else one gloo group over the same processes, made once."""
    if dist.get_backend() == "gloo":
        return None
    key = id(dist.group.WORLD)
    if key not in _gloo:
        _gloo[key] = dist.new_group(backend="gloo")
    return _gloo[key]


def rank_and_size():
    """``(rank, world size)`` of the default group, ``(0, 1)`` without one."""
    if dist.is_available() and dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    return 0, 1


def allgather_np(x: np.ndarray) -> np.ndarray:
    """A same-shaped numpy array from every process → ``[P, ...]``, in rank
    order (``multihost.py:72``)."""
    t = torch.as_tensor(np.ascontiguousarray(x))
    outs = [torch.empty_like(t) for _ in range(dist.get_world_size())]
    dist.all_gather(outs, t, group=_exchange_group())
    return np.stack([o.numpy() for o in outs])


def rank_device(device=None) -> torch.device:
    """This process's device: ``cuda:{rank % device_count}`` for None (or a
    bare ``"cuda"``), else ``device``; a CUDA device is made current."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and dev.index is None and torch.cuda.is_available():
        dev = torch.device("cuda", rank_and_size()[0] % torch.cuda.device_count())
    dev = resolve_device(dev)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    return dev


class GoIcpSolverMultiHost(GoIcpSolver):
    """Frontier-sharded Go-ICP across the processes of the default
    ``torch.distributed`` group (``multihost.py:77``).  With one process it
    is an unpipelined-exchange SE(3) solve, the correctness baseline."""

    def __init__(self, src, tgt, params: BnbParams = BnbParams(), progress=None, device=None,
                 **kw):
        super().__init__(src, tgt, params, progress, device=rank_device(device), **kw)

    def run(self, init: Optional[RigidTransform] = None) -> GoIcpResult:
        p, m = self.p, self.metrics
        t_start = time.perf_counter()
        pid, P = rank_and_size()

        best_R, best_t, best_sse = self._initial_icp(init)
        # every process runs the same multistart; align on the global best
        # so that prune thresholds match exactly
        best_R, best_t, best_sse = self._exchange_incumbent(best_R, best_t, best_sse)
        self.log.info("[p%d/%d] initial ICP: sse=%.6g", pid, P, best_sse)

        rounds = 0          # local work rounds (metrics only)
        pop_cap = p.se3_pop or 256

        # an optional mesh of this process's devices (local collectives only)
        mesh = None
        _mesh = make_engine_mesh(
            p, self._backend, self.src, self.ev.norms.cpu().numpy(),
            h=(self.ev.h if p.trim_fraction > 0 else 0),
            icp_params=self._icp_params_round_mesh, icp_backend=self._icp_backend,
            device=self.device, log=self.log, tag=f"[p{pid}/{P}] ",
        )
        if _mesh is not None:
            sharded_round, src_pad, norms_pad, n_c, _ = _mesh
            pop_cap = -(-pop_cap // n_c) * n_c
            mesh = (sharded_round, src_pad, norms_pad, n_c)

        M_cap = 8 * pop_cap
        # host angles, partial rounds bucketed from 256 and mesh rounds
        # padded to the full cap (multihost.py:135)
        drv = Se3RoundDriver(
            self, pop_cap=pop_cap, M_cap=M_cap, bucket_base=256, mesh=mesh,
            tight_ang=False, sharded_pad_full=True,
        )
        drv.best_R, drv.best_t, drv.best_sse = best_R, best_t, best_sse
        root = drv.root

        # per-process checkpoint slices at the same global iteration form a
        # consistent cut; resume only if every process holds one of the
        # same iteration (the gathered pair keeps the decision unanimous)
        ck_path = f"{p.checkpoint_path}.p{pid}of{P}" if p.checkpoint_path else None
        ck = None
        if ck_path and os.path.exists(ck_path):
            with np.load(ck_path) as f:
                ck = {k: f[k] for k in f.files}
        my_it = float(ck["it"]) if ck is not None and "it" in ck else -1.0
        allck = self._gather(np.float32([float(ck is not None), my_it]), P)
        resume = bool(allck[:, 0].min() > 0 and allck[:, 1].max() == allck[:, 1].min()
                      and allck[0, 1] >= 0)
        if ck is not None and not resume:
            self.log.warning(
                "[p%d/%d] checkpoint slices are not a consistent cut (iterations %s) "
                "— starting fresh", pid, P, allck[:, 1].tolist(),
            )
        if resume:
            drv.push_classified(ck["payload"], ck["lb"], ck["ub"])
            if float(ck["best_sse"]) < drv.best_sse:
                drv.best_sse = float(ck["best_sse"])
                drv.best_R, drv.best_t = ck["best_R"], ck["best_t"]
            drv.leaf_lb = float(ck["leaf_lb"])
            rounds = int(ck["rounds"])
            m.count("se3_nodes", int(ck["nodes"]))
            self.log.info("[p%d/%d] resumed from %s: round %d, frontier %d, best %.6g",
                          pid, P, ck_path, rounds, drv.f_len(), drv.best_sse)
            # a snapshot may hold the root itself (taken while round 1 was
            # queued): its mod-P partition must fire again
            root_pending = bool(np.any(np.all(np.abs(ck["payload"] - root[None]) < 1e-6,
                                              axis=1)))
        else:
            # every process pushes the root and expands it identically,
            # keeping the children with index ≡ rank (mod P)
            drv.push_root()
            root_pending = True
        _sr0, _lf0 = drv.classify(root[None])
        root_in_T = bool((~_sr0 & ~_lf0)[0])
        # the global lockstep iteration: every collective-gating condition
        # derives from it; a resume continues it, so snapshots of different
        # resume generations never alias
        it = int(ck["it"]) if resume and "it" in ck else 0

        # rebalance sizes must be identical everywhere, and pop_cap is
        # rounded by the local mesh: one gather fixes the global value
        pop_cap_g = int(self._gather(np.float32([pop_cap]), P)[:, 0].max())
        exchange_k = max(64, 2 * pop_cap_g)
        converged = drv.best_sse <= self.sse_thresh

        inflight = deque()
        depth = max(1, p.pipeline_depth)

        def dispatch():
            """Pop, expand and queue one homogeneous local round (no
            collectives).  While the root is unexpanded the round is a
            singleton round from the root's frontier, whose children are
            partitioned mod P."""
            nonlocal root_pending
            use_T = (not root_pending and len(drv.fT)
                     and (not len(drv.fR) or drv.fT.min_lb() <= drv.fR.min_lb()))
            if use_T:
                return drv.dispatch_T()
            if root_pending:
                src_f = drv.fT if root_in_T else drv.fR
                if not len(src_f):
                    src_f = drv.fR if len(drv.fR) else drv.fT
            else:
                src_f = drv.fR if len(drv.fR) else drv.fT

            def partition_root(pay, child, keep):
                nonlocal root_pending
                if root_pending:
                    root_rows = np.all(np.abs(pay - root[None]) < 1e-6, axis=1)
                    if root_rows.any():
                        if P > 1:
                            from_root = np.repeat(root_rows, 8)
                            child_idx = np.tile(np.arange(8), pay.shape[0])
                            keep = keep & (~from_root | (child_idx % P == pid))
                        root_pending = False
                return keep

            return drv.dispatch_singleton(src_f, child_filter=partition_root)

        def save_checkpoint():
            """This process's slice, the queued rounds' parents re-included
            (they are in no frontier yet) and their counted children
            deducted."""
            pay, lb, ub = drv.dump_frontiers()
            for w in inflight:
                ppay, plb, _ = w["parents"]
                if ppay.shape[0]:
                    pay = np.concatenate([pay, ppay])
                    lb = np.concatenate([lb, plb])
                    ub = np.concatenate([ub, np.full(ppay.shape[0], np.inf, np.float32)])
            inflight_children = sum(pt[-1] for w in inflight for pt in w["parts"])
            tmp = ck_path + ".tmp.npz"
            np.savez(
                tmp, payload=pay, lb=lb, ub=ub, best_R=drv.best_R, best_t=drv.best_t,
                best_sse=np.float32(drv.best_sse), leaf_lb=np.float32(drv.leaf_lb),
                rounds=np.int64(max(rounds, 1)),
                nodes=np.int64(m.counters.get("se3_nodes", 0) - inflight_children),
                nproc=np.int64(P), it=np.int64(it),
            )
            os.replace(tmp, ck_path)

        exch = max(1, int(p.mh_exchange_every))
        ck_every = max(1, p.checkpoint_every // exch)   # in exchanges
        g_min_lb = float("inf")

        with m.phase("bnb"):
            while True:
                it += 1
                new_best = False
                if drv.f_len() and not converged and len(inflight) < depth:
                    rounds += 1
                    _t = time.perf_counter()
                    work = dispatch()
                    m.timers["mh_dispatch_s"] += time.perf_counter() - _t
                    if work["n_parents"] < pop_cap:
                        m.count("mh_starved_rounds", 1)
                    m.count("mh_jobs", sum(pt[-1] for pt in work["parts"]))
                    m.count("mh_padded_jobs", work["width"])
                    inflight.append(work)
                if inflight and (len(inflight) >= depth or not (drv.f_len() and not converged)):
                    _t = time.perf_counter()
                    new_best = drv.absorb(inflight.popleft())
                    m.timers["mh_absorb_s"] += time.perf_counter() - _t

                if it % exch != 0:
                    continue
                inflight_lb = min((w["min_parent_lb"] for w in inflight), default=float("inf"))
                # one fused gather: incumbent (13 floats) and status (3),
                # the status taken before the global prune (conservative)
                rec = np.zeros(16, np.float32)
                rec[0] = drv.best_sse
                rec[1:10] = np.asarray(drv.best_R, np.float32).reshape(9)
                rec[10:13] = np.asarray(drv.best_t, np.float32)
                rec[13] = min(drv.f_min_lb(), drv.leaf_lb, inflight_lb)
                rec[14] = float(drv.f_len() + sum(w["n_parents"] for w in inflight))
                rec[15] = float(it >= p.max_rounds
                                or time.perf_counter() - t_start > p.max_wall_s)
                _t = time.perf_counter()
                allr = self._gather(rec, P)                              # [P, 16]
                m.timers["mh_gather_s"] += time.perf_counter() - _t
                j = int(np.argmin(allr[:, 0]))
                if float(allr[j, 0]) <= drv.best_sse:
                    # adopt on ties too, so the pose is the same everywhere
                    drv.best_sse = float(allr[j, 0])
                    drv.best_R = allr[j, 1:10].reshape(3, 3)
                    drv.best_t = allr[j, 10:13]
                drv.f_prune(drv.best_sse - self.sse_thresh)
                if ck_path and (it // exch) % ck_every == 0:
                    save_checkpoint()
                g_min_lb = float(allr[:, 13].min())
                sizes = allr[:, 14]
                total = float(sizes.sum())

                if drv.best_sse <= self.sse_thresh:
                    converged = True
                if drv.best_sse - g_min_lb <= self.sse_thresh or total == 0:
                    converged = True
                if new_best or it % 16 == 0:
                    _n = int(m.counters.get("se3_nodes", 0))
                    self.progress.publish(SolverState(
                        opt_R=np.asarray(drv.best_R), opt_t=np.asarray(drv.best_t),
                        cur_R=np.asarray(drv.best_R), cur_t=np.asarray(drv.best_t),
                        best_sse=float(drv.best_sse),
                        gap=float(max(drv.best_sse - g_min_lb, 0.0)),
                        finished=False, rot_nodes=_n, trans_nodes=_n, round=it,
                    ))
                # unanimous: every input of this test is gathered
                if converged or allr[:, 15].max() > 0:
                    break

                force = sizes.min() == 0 and total > 0
                if force or (
                    it % 4 == 0 and total > P * pop_cap_g / 2
                    and (sizes.min() < pop_cap_g or sizes.max() > 2 * max(sizes.min(), 1.0))
                ):
                    _t = time.perf_counter()
                    payR, lbR, ubR = drv.fR.pop_best(exchange_k)
                    payT, lbT, ubT = drv.fT.pop_best(exchange_k)
                    pay = np.concatenate([payR, payT])
                    buf = np.full((2 * exchange_k, 10), np.inf, np.float32)
                    n = pay.shape[0]
                    buf[:n, :8] = pay
                    buf[:n, 8] = np.concatenate([lbR, lbT])
                    buf[:n, 9] = np.concatenate([ubR, ubT])
                    merged = self._gather(buf, P).reshape(-1, 10)
                    merged = merged[np.isfinite(merged[:, 8])]
                    mine = np.argsort(merged[:, 8], kind="stable")[pid::P]
                    if mine.size:
                        drv.push_classified(merged[mine, :8], merged[mine, 8],
                                            merged[mine, 9])
                    m.count("rebalances", 1)
                    m.timers["mh_rebalance_s"] += time.perf_counter() - _t

            # queued rounds may hold a better incumbent: absorb them, then
            # one unconditional exchange restores the common incumbent
            while inflight:
                drv.absorb(inflight.popleft())
            drv.best_R, drv.best_t, drv.best_sse = self._exchange_incumbent(
                drv.best_R, drv.best_t, drv.best_sse)
            m.counters["mh_iters"] = it

        best_R, best_t, best_sse = self._full_polish(drv.best_R, drv.best_t, drv.best_sse)
        gap = best_sse - min(g_min_lb, drv.leaf_lb)
        wall = time.perf_counter() - t_start
        nodes = int(m.counters.get("se3_nodes", 0))
        self.log.info(
            "[p%d/%d] Go-ICP(multihost) done: sse=%.6g rounds=%d local_nodes=%d "
            "rebalances=%d wall=%.2fs", pid, P, best_sse, rounds, nodes,
            int(m.counters.get("rebalances", 0)), wall,
        )
        gap = float(max(gap, 0.0)) if math.isfinite(gap) else 0.0
        self.progress.publish(SolverState(
            opt_R=np.asarray(best_R), opt_t=np.asarray(best_t),
            cur_R=np.asarray(best_R), cur_t=np.asarray(best_t), best_sse=float(best_sse),
            gap=gap, finished=True, rot_nodes=nodes, trans_nodes=nodes, round=rounds,
        ))
        sse_full, mse_full, gap_full = self._full_cert(best_R, best_t, best_sse,
                                                       best_sse - min(g_min_lb, drv.leaf_lb))
        return GoIcpResult(
            transform=RigidTransform(best_R, best_t), sse=best_sse, mse=best_sse / self.ev.h,
            converged=converged, gap=gap, rot_nodes=nodes, trans_nodes=nodes,
            icp_iters=int(m.counters.get("icp_iters", 0)), rounds=rounds, wall_s=wall,
            metrics=m, sse_full=sse_full, mse_full=mse_full, gap_full=gap_full,
        )

    @staticmethod
    def _gather(x, P: int) -> np.ndarray:
        return allgather_np(x) if P > 1 else np.asarray(x)[None]

    def _exchange_incumbent(self, best_R, best_t, best_sse):
        """Global min of the incumbent, its pose along (``multihost.py:530``)."""
        _, P = rank_and_size()
        if P == 1:
            return best_R, best_t, best_sse
        rec = np.zeros(13, np.float32)
        rec[0] = best_sse
        rec[1:10] = np.asarray(best_R, np.float32).reshape(9)
        rec[10:13] = np.asarray(best_t, np.float32)
        allr = allgather_np(rec)                                        # [P, 13]
        j = int(np.argmin(allr[:, 0]))
        return allr[j, 1:10].reshape(3, 3), allr[j, 10:13], float(allr[j, 0])
