"""Live solver-state reporting.

The reference shares ``{optR, optT, curR, curT, finished, error}`` between the
solver thread and the render thread under a mutex
(``src/main.hpp:37``, ``src/goicp_kernel.cu:33-46``, ``fgoicp.hpp:65-69``) so
the OpenGL window can draw the incumbent (red) and in-progress (white) poses.

Here there is no GL window and no shared mutable state: the solver publishes
an immutable :class:`SolverState` snapshot per outer round through a callback.
Consumers (a progress printer, a trajectory dumper) subscribe; nothing
blocks the device pipeline.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, List, Optional

import numpy as np


@dataclasses.dataclass(frozen=True)
class SolverState:
    """One snapshot of solver progress (≙ the mutex-guarded globals)."""

    opt_R: np.ndarray          # incumbent rotation [3,3]
    opt_t: np.ndarray          # incumbent translation [3]
    cur_R: np.ndarray          # rotation currently being explored [3,3]
    cur_t: np.ndarray          # translation currently being explored [3]
    best_sse: float            # incumbent error (ref best_sse / optError)
    gap: float                 # best_sse - min frontier lb
    finished: bool
    rot_nodes: int             # ≙ rNodeCount (jly_goicp.cpp:35)
    trans_nodes: int           # ≙ tNodeCount (jly_goicp.cpp:34)
    round: int


ProgressFn = Callable[[SolverState], None]


class ProgressBus:
    """Fan-out of solver snapshots to any number of subscribers."""

    def __init__(self):
        self._subs: List[ProgressFn] = []
        self.last: Optional[SolverState] = None

    def subscribe(self, fn: ProgressFn):
        self._subs.append(fn)

    def publish(self, state: SolverState):
        self.last = state
        for fn in self._subs:
            fn(state)
