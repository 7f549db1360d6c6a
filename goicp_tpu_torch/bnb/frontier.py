"""Host-side BnB frontier: structure-of-arrays node store.

Replaces the reference's ``std::priority_queue<RotNode/TransNode>``
(``src/common.h:88-95,123-130``, ``fgoicp.cpp:34,117``) with a payload-generic
SoA store supporting *batch* pops (the device evaluates thousands of cubes per
step, so a one-at-a-time heap is the wrong shape) and incumbent-driven
re-filtering (≙ the queue rebuild at ``jly_goicp.cpp:533-543``).

Two implementations with one interface:
- :class:`PyFrontier` — numpy (always available; the reference for tests);
- :class:`NativeFrontier` — C++ introselect (``_native/goicp_native.cpp``),
  no concat/argsort churn per round.

Payload layouts used by the solvers (copied from the JAX package's
``bnb/frontier.py``):
- nested rotation frontier: ``[cx, cy, cz, span]`` (dim 4, :class:`Frontier`)
- SE(3) product frontier: ``[rx, ry, rz, rspan, tx, ty, tz, tspan]`` (dim 8)
"""

from __future__ import annotations

import ctypes

import numpy as np

_F32P = ctypes.POINTER(ctypes.c_float)


class PyFrontier:
    """Nodes ``(payload [K, dim], lb [K], ub [K])``; pops are best-first by
    ``(lb, ub)`` lexicographic — early in the search most lower bounds are
    exactly 0, so the inherited upper bound is the only signal separating
    promising regions from noise."""

    def __init__(self, dim: int):
        self.dim = dim
        self.payload = np.zeros((0, dim), np.float32)
        self.lb = np.zeros((0,), np.float32)
        self.ub = np.zeros((0,), np.float32)

    def __len__(self) -> int:
        return self.lb.shape[0]

    def push(self, payload, lb, ub):
        self.payload = np.concatenate(
            [self.payload, np.asarray(payload, np.float32).reshape(-1, self.dim)]
        )
        self.lb = np.concatenate([self.lb, np.asarray(lb, np.float32).reshape(-1)])
        self.ub = np.concatenate([self.ub, np.asarray(ub, np.float32).reshape(-1)])

    def pop_best(self, k: int):
        k = min(k, len(self))
        if k == 0:
            z = np.zeros((0,), np.float32)
            return np.zeros((0, self.dim), np.float32), z, z
        idx = np.lexsort((self.ub, self.lb))[:k]
        keep = np.ones(len(self), bool)
        keep[idx] = False
        out = (self.payload[idx], self.lb[idx], self.ub[idx])
        self.payload, self.lb, self.ub = (
            self.payload[keep],
            self.lb[keep],
            self.ub[keep],
        )
        return out

    def prune(self, threshold: float) -> int:
        keep = self.lb < threshold
        dropped = int((~keep).sum())
        if dropped:
            self.payload, self.lb, self.ub = (
                self.payload[keep],
                self.lb[keep],
                self.ub[keep],
            )
        return dropped

    def min_lb(self) -> float:
        return float(self.lb.min()) if len(self) else float("inf")

    def dump(self):
        """Snapshot for checkpointing: ``(payload, lb, ub)`` copies."""
        return self.payload.copy(), self.lb.copy(), self.ub.copy()


class NativeFrontier:
    """C++ SoA frontier: introselect batch pops, in-place prune."""

    def __init__(self, dim: int):
        from goicp_tpu_torch import _native

        self._n = _native.lib()
        if self._n is None:
            raise RuntimeError("native library unavailable")
        self.dim = dim
        self._h = self._n.gn_frontier_new(dim)

    def __len__(self) -> int:
        return int(self._n.gn_frontier_size(self._h))

    def __del__(self):
        try:
            self._n.gn_frontier_free(self._h)
        except Exception:
            pass

    def push(self, payload, lb, ub):
        pay = np.ascontiguousarray(
            np.asarray(payload, np.float32).reshape(-1, self.dim)
        )
        lb = np.ascontiguousarray(np.asarray(lb, np.float32).reshape(-1))
        ub = np.ascontiguousarray(np.asarray(ub, np.float32).reshape(-1))
        self._n.gn_frontier_push(
            self._h,
            lb.size,
            pay.ctypes.data_as(_F32P),
            lb.ctypes.data_as(_F32P),
            ub.ctypes.data_as(_F32P),
        )

    def pop_best(self, k: int):
        k = min(k, len(self))
        pay = np.empty((max(k, 1), self.dim), np.float32)
        lb = np.empty(max(k, 1), np.float32)
        ub = np.empty(max(k, 1), np.float32)
        if k > 0:
            k = int(
                self._n.gn_frontier_pop_best(
                    self._h,
                    k,
                    pay.ctypes.data_as(_F32P),
                    lb.ctypes.data_as(_F32P),
                    ub.ctypes.data_as(_F32P),
                )
            )
        return pay[:k], lb[:k], ub[:k]

    def prune(self, threshold: float) -> int:
        return int(self._n.gn_frontier_prune(self._h, float(threshold)))

    def min_lb(self) -> float:
        if len(self) == 0:
            return float("inf")
        return float(self._n.gn_frontier_min_lb(self._h))

    def dump(self):
        """Snapshot for checkpointing: ``(payload, lb, ub)``."""
        n = len(self)
        pay = np.empty((max(n, 1), self.dim), np.float32)
        lb = np.empty(max(n, 1), np.float32)
        ub = np.empty(max(n, 1), np.float32)
        if n:
            self._n.gn_frontier_dump(
                self._h,
                pay.ctypes.data_as(_F32P),
                lb.ctypes.data_as(_F32P),
                ub.ctypes.data_as(_F32P),
            )
        return pay[:n], lb[:n], ub[:n]


def make_frontier(dim: int):
    """Native frontier when the C++ runtime is available, numpy otherwise."""
    try:
        return NativeFrontier(dim)
    except RuntimeError:
        return PyFrontier(dim)


class Frontier:
    """Cube frontier of the nested engine (payload = center[3] + span)."""

    def __init__(self, impl=None):
        self._f = impl if impl is not None else PyFrontier(4)

    def __len__(self):
        return len(self._f)

    def push(self, center, span, lb, ub=None):
        span = np.asarray(span, np.float32).reshape(-1)
        if ub is None:
            ub = np.full(span.size, np.inf, np.float32)
        pay = np.concatenate(
            [np.asarray(center, np.float32).reshape(-1, 3), span[:, None]], axis=1
        )
        self._f.push(pay, lb, ub)

    def pop_best(self, k: int):
        pay, lb, ub = self._f.pop_best(k)
        return pay[:, :3], pay[:, 3], lb, ub

    def prune(self, threshold: float) -> int:
        return self._f.prune(threshold)

    def min_lb(self) -> float:
        return self._f.min_lb()

    def dump(self):
        """Snapshot for checkpointing: ``(payload [K,4], lb, ub)``."""
        return self._f.dump()


def make_cube_frontier() -> Frontier:
    return Frontier(make_frontier(4))
