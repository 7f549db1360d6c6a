"""Structured per-phase timers and counters.

Replaces the reference's ad-hoc observability — FPS in the window title
(``src/main.cpp:164-178``), ``clock()`` prints (``jly_goicp.cpp:379-390``) and
node counters ``tNodeCount``/``rNodeCount`` (``jly_goicp.cpp:34-35``) — with
first-class metrics: named counters, phase wall-clock timers, derived rates
(BnB nodes/s, ICP iters/s), all dumpable as a JSON dict.
"""

from __future__ import annotations

import contextlib
import json
import time
from collections import defaultdict
from typing import Dict


class Metrics:
    def __init__(self):
        self.counters: Dict[str, float] = defaultdict(float)
        self.timers: Dict[str, float] = defaultdict(float)
        self._starts: Dict[str, float] = {}

    def count(self, name: str, n: float = 1.0):
        self.counters[name] += n

    @contextlib.contextmanager
    def phase(self, name: str):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.timers[name] += time.perf_counter() - t0

    def rate(self, counter: str, timer: str) -> float:
        t = self.timers.get(timer, 0.0)
        return self.counters.get(counter, 0.0) / t if t > 0 else 0.0

    def summary(self) -> dict:
        out = {f"count/{k}": v for k, v in self.counters.items()}
        out.update({f"time_s/{k}": v for k, v in self.timers.items()})
        # Standard derived rates (reference counterparts: tNodeCount/rNodeCount
        # per solve, jly_goicp.cpp:574-580).
        if "trans_nodes" in self.counters and "bnb" in self.timers:
            out["rate/trans_nodes_per_s"] = self.rate("trans_nodes", "bnb")
        if "rot_nodes" in self.counters and "bnb" in self.timers:
            out["rate/rot_nodes_per_s"] = self.rate("rot_nodes", "bnb")
        if "icp_iters" in self.counters and "icp" in self.timers:
            out["rate/icp_iters_per_s"] = self.rate("icp_iters", "icp")
        return out

    def dump_json(self, path: str):
        with open(path, "w") as f:
            json.dump(self.summary(), f, indent=2, sort_keys=True)
            f.write("\n")
