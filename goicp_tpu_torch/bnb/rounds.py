"""The SE(3) round driver (port of the JAX package's ``bnb/rounds.py``
without the device-mesh branch).

Each round pops a homogeneous batch from one of two frontiers (split by next
split type), expands it 8-way, pads it to a job-count bucket and queues one
device round; ``absorb`` fetches a round, updates the incumbent, prunes and
pushes the survivors.  All of this is host numpy except three places: the
dispatch of a T-round and of an R-round, and ``absorb``.

Dispatch only queues work on the CUDA stream (the host arrays go up through
pinned memory, see ``core.device.to_device``), so up to ``pipeline_depth``
rounds sit in the queue.  The round's ICP refine tail tests its loop
condition on the host, which waits for the device, so it runs in
``absorb``: its inputs (the round's ub, its poses and the refine gate) are
all fixed at dispatch, which gives the JAX package's results.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from goicp_tpu_torch.bnb.frontier import make_frontier
from goicp_tpu_torch.bnb.se3_eval import (
    _refine_tail,
    se3_round_bounds,
    se3_round_grouped_bounds,
)
from goicp_tpu_torch.core.device import to_device

_OCTANTS = (
    np.array([[(j >> a) & 1 for a in range(3)] for j in range(8)], np.float32) * 2.0
    - 1.0
)  # {-1,+1}^3
_BUCKET_BASE = 2048  # smallest job-count bucket; buckets double up to M_cap


class Se3RoundDriver:
    """Frontiers + expansion + round dispatch + absorption for one SE(3) BnB
    engine instance (``rounds.py:42``)."""

    def __init__(
        self,
        solver,
        *,
        pop_cap: int,
        M_cap: int,
        tight_ang: bool = False,
    ):
        self.s = solver
        self.m = solver.metrics
        self.pop_cap = pop_cap
        self.M_cap = M_cap
        self.tight_ang = tight_ang

        p = solver.p
        self.mean_norm = float(np.mean(np.linalg.norm(solver.src, axis=1)))
        self.rot_floor = p.min_rot_span * solver.rotparam.root_span
        self.trans_floor = max(p.min_trans_span, 1e-5)
        self.beta = max(p.split_beta, 1e-6)

        # two frontiers, by next split type, so every round is homogeneous
        self.fR = make_frontier(8)
        self.fT = make_frontier(8)

        self.best_R = None
        self.best_t = None
        self.best_sse = float("inf")
        self.leaf_lb = float("inf")

        self.root = np.array(
            [0.0, 0.0, 0.0, solver.rotparam.root_span,
             *p.trans_center, p.trans_span],
            np.float32,
        )

        buckets = []
        b = _BUCKET_BASE
        while b < M_cap:
            buckets.append(b)
            b *= 2
        buckets.append(M_cap)
        self._buckets = buckets

        self._h = solver.ev.h if p.trim_fraction > 0 else 0
        self._slack = float(solver._exact_slack)

    # -- frontier management -------------------------------------------------

    def classify(self, pay):
        """Next split type per node (the one shared rule, ``bnb.split``)."""
        from goicp_tpu_torch.bnb.split import classify_split

        return classify_split(
            pay, self.mean_norm, self.s.rotparam, beta=self.beta,
            rot_floor=self.rot_floor, trans_floor=self.trans_floor,
        )

    def push_classified(self, pay, lb, ub):
        split_rot, is_leaf = self.classify(pay)
        to_t = ~split_rot & ~is_leaf
        if to_t.any():
            self.fT.push(pay[to_t], lb[to_t], ub[to_t])
        if not to_t.all():
            self.fR.push(pay[~to_t], lb[~to_t], ub[~to_t])

    def push_root(self):
        self.push_classified(
            self.root[None],
            np.zeros(1, np.float32),
            np.full(1, np.inf, np.float32),
        )

    def f_len(self) -> int:
        return len(self.fR) + len(self.fT)

    def f_min_lb(self) -> float:
        return min(self.fR.min_lb(), self.fT.min_lb())

    def f_prune(self, thr: float):
        self.fR.prune(thr)
        self.fT.prune(thr)

    def bucket(self, n: int) -> int:
        for b in self._buckets:
            if n <= b:
                return b
        return self.M_cap

    def thresh(self) -> float:
        """Incumbent − ε at dispatch time (the screened kernel's prune level;
        stale by up to pipeline_depth rounds — conservative)."""
        return float(np.float32(self.best_sse - self.s.sse_thresh))

    def refine_gate(self) -> float:
        """ICP-trigger level at dispatch time: only candidates with
        ``ub < icp_refine_factor·best`` iterate the refine tail
        (``fgoicp.cpp:75``)."""
        return float(np.float32(self.s.p.icp_refine_factor * self.best_sse))

    def _dev(self, x, dtype=torch.float32):
        return to_device(np.ascontiguousarray(x), self.s.device, dtype)

    def _angles(self, centers, spans, angles):
        """The round's angle input: the ``(centers, spans)`` tuple whose tight
        bound the round computes on the device, or host angles."""
        if self.tight_ang:
            return (self._dev(centers), self._dev(spans))
        return self._dev(angles)

    # -- dispatch ------------------------------------------------------------

    def dispatch_T(self, round_idx: int = 0) -> dict:
        """Pop translation-split nodes → 8 octant t-children per parent, all
        sharing the parent rotation → one grouped round (kernel K3, or K6 on
        trimmed "screen" solves)."""
        s, m = self.s, self.m
        pay, pop_lb, pop_ub = self.fT.pop_best(self.pop_cap)
        B = pay.shape[0]
        m.count("pops_trans", B)
        m.count("se3_nodes", 8 * B)

        half_t = pay[:, 7] / 2.0
        t8 = pay[:, None, 4:7] + _OCTANTS[None] * half_t[:, None, None]
        t8 = t8.astype(np.float32)                  # [B,8,3]
        R_g = s.rotparam.rotation(pay[:, 0:3])      # [B,3,3]
        ang_g = s.rotparam.max_angle(pay[:, 0:3], pay[:, 3]).astype(np.float32)
        child = np.repeat(pay, 8, axis=0)           # group-major (kernel order)
        child[:, 4:7] = t8.reshape(8 * B, 3)
        child[:, 7] = np.repeat(half_t, 8)
        C = 8 * B

        G_cap = self.bucket(C) // 8
        padg = G_cap - B
        R_pad = np.concatenate(
            [R_g, np.tile(np.eye(3, dtype=np.float32), (padg, 1, 1))]
        )
        ts8 = np.repeat(half_t, 8).reshape(B, 8)
        mask = np.zeros(8 * G_cap, bool)
        mask[:C] = True
        ub, lb, R_flat, t_flat = se3_round_grouped_bounds(
            s._src_dev, s.ev.norms, s._tgt_dev, self._slack, self.thresh(),
            self._dev(R_pad),
            self._angles(
                np.concatenate([pay[:, 0:3], np.zeros((padg, 3), np.float32)]),
                np.concatenate([pay[:, 3], np.zeros(padg, np.float32)]),
                np.concatenate([ang_g, np.zeros(padg, np.float32)]),
            ),
            self._dev(np.concatenate([t8, np.zeros((padg, 8, 3), np.float32)])),
            self._dev(np.concatenate([ts8, np.zeros((padg, 8), np.float32)])),
            self._dev(mask, torch.bool),
            h=self._h,
            backend=s._backend,
        )
        out = {"bounds": (ub, lb, R_flat, t_flat), "gate": self.refine_gate()}
        return {
            "parts": [(child, np.zeros(C, bool),
                       np.repeat(R_g, 8, axis=0), out, C)],
            "parents": (pay, pop_lb, pop_ub),
            "grouped": B,
            "round": round_idx,
            "t0": time.perf_counter(),
            "n_parents": B,
            "min_parent_lb": float(pop_lb.min()) if B else float("inf"),
            "width": 8 * G_cap,
        }

    def dispatch_singleton(self, frontier, round_idx: int = 0) -> dict:
        """Pop from ``frontier`` (fR: rotation splits and leaves) → octant
        children as singleton jobs → one round (kernel K2 or K5 on the
        "screen" backend, K4 on "mxu")."""
        m = self.m
        pay, pop_lb, pop_ub = frontier.pop_best(self.pop_cap)
        B = pay.shape[0]
        split_rot, is_leaf = self.classify(pay)
        m.count("pops_rot", int(split_rot.sum()))
        m.count("pops_leaf", int(is_leaf.sum()))
        child = np.repeat(pay, 8, axis=0)          # [8B, 8]
        oct8 = np.tile(_OCTANTS, (B, 1))           # [8B, 3]
        sr = np.repeat(split_rot, 8)
        lf = np.repeat(is_leaf, 8)
        half_r = np.repeat(pay[:, 3], 8) / 2.0
        half_t = np.repeat(pay[:, 7], 8) / 2.0
        tr = ~sr & ~lf
        child[sr, 0:3] += oct8[sr] * half_r[sr, None]
        child[sr, 3] = half_r[sr]
        child[tr, 4:7] += oct8[tr] * half_t[tr, None]
        child[tr, 7] = half_t[tr]
        # leaves: keep only one copy (slot 0 of each 8-block)
        keep = np.ones(8 * B, bool)
        if lf.any():
            keep &= ~lf | (np.arange(8 * B) % 8 == 0)
        # rotation-ball validity (jly_goicp.cpp:443-446)
        keep &= self.s.rotparam.valid(child[:, 0:3], child[:, 3])
        child, lf = child[keep], lf[keep]
        C = child.shape[0]
        parts = []
        width = 0
        if C:
            assert C <= self.M_cap
            m.count("se3_nodes", C)
            out, R_c, width = self._eval_singleton(child)
            parts = [(child, lf, R_c, out, C)]
        return {
            "parts": parts,
            "parents": (pay, pop_lb, pop_ub),
            "round": round_idx,
            "t0": time.perf_counter(),
            "n_parents": B,
            "min_parent_lb": float(pop_lb.min()) if B else float("inf"),
            "width": width,
        }

    def _eval_singleton(self, child):
        """Pad ``child [C,8]`` payloads to a bucket and queue one singleton
        round.  Returns ``(out, R_c, width)``."""
        s = self.s
        C = child.shape[0]
        cap = self.bucket(C)
        padn = cap - C
        R_c = s.rotparam.rotation(child[:, 0:3])
        ang_c = s.rotparam.max_angle(child[:, 0:3], child[:, 3]).astype(np.float32)
        R_dev = self._dev(np.concatenate(
            [R_c, np.tile(np.eye(3, dtype=np.float32), (padn, 1, 1))]
        ))
        t_dev = self._dev(
            np.concatenate([child[:, 4:7], np.zeros((padn, 3), np.float32)])
        )
        ub, lb = se3_round_bounds(
            s._src_dev, s.ev.norms, s._tgt_dev, self._slack, self.thresh(),
            R_dev,
            self._angles(
                np.concatenate([child[:, 0:3], np.zeros((padn, 3), np.float32)]),
                np.concatenate([child[:, 3], np.zeros(padn, np.float32)]),
                np.concatenate([ang_c, np.zeros(padn, np.float32)]),
            ),
            t_dev,
            self._dev(np.concatenate([child[:, 7], np.zeros(padn, np.float32)])),
            self._dev(np.concatenate([np.ones(C, bool), np.zeros(padn, bool)]),
                      torch.bool),
            h=self._h,
            backend=s._backend,
        )
        out = {"bounds": (ub, lb, R_dev, t_dev), "gate": self.refine_gate()}
        return out, R_c, cap

    # -- absorb --------------------------------------------------------------

    def _finish(self, out):
        """Run the round's refine tail and fetch everything to the host."""
        s = self.s
        ub, lb, R, t = out["bounds"]
        res = _refine_tail(
            ub, lb, R, t, s._src_dev, s._tgt_dev, s.p.refine_top_k,
            s._icp_params_round, out["gate"],
        )
        return [x.cpu().numpy() for x in res]

    def absorb(self, work: dict):
        """Fetch one queued round; update the incumbent, prune the frontiers
        on a new incumbent, update leaf_lb, push surviving children.  Returns whether the
        incumbent improved."""
        s, m = self.s, self.m
        new_best = False
        for child, lf, R_c, out, C in work["parts"]:
            ub_d, lb_d, R_ref, t_ref, sse_ref, it_ref = self._finish(out)
            m.timers[
                "round_T_s" if work.get("grouped") else "round_R_s"
            ] += time.perf_counter() - work["t0"]
            ub_c, lb_c = ub_d[:C], lb_d[:C]
            m.count("icp_iters", int(it_ref.sum()))

            j = int(np.argmin(sse_ref))
            if float(sse_ref[j]) < self.best_sse:
                self.best_sse = float(sse_ref[j])
                self.best_R, self.best_t = R_ref[j], t_ref[j]
                new_best = True
                self.f_prune(self.best_sse - s.sse_thresh)
                s.log.info(
                    "round %d: new best sse=%.6g (mse=%.6g)",
                    work.get("round", 0),
                    self.best_sse,
                    self.best_sse / s.ev.h,
                )
            j = int(np.argmin(ub_c))
            if float(ub_c[j]) < self.best_sse:
                self.best_sse = float(ub_c[j])
                self.best_R, self.best_t = R_c[j], child[j, 4:7]
                new_best = True
                self.f_prune(self.best_sse - s.sse_thresh)

            alive = lb_c < self.best_sse - s.sse_thresh
            if (alive & lf).any():
                self.leaf_lb = min(self.leaf_lb, float(lb_c[alive & lf].min()))
            keep = alive & ~lf
            if keep.any():
                self.push_classified(child[keep], lb_c[keep], ub_c[keep])
        return new_best
