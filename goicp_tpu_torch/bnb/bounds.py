"""The part of the JAX package's ``bnb/bounds.py:BoundsEvaluator`` that the
SE(3) engine reads: the source norms, the inlier count ``h`` and the grid
slack.  The grid bound code waits for the grid backend (ROADMAP queue 1)."""

from __future__ import annotations

import torch


class BoundsEvaluator:
    """Bound-evaluation constants for one source cloud (``bounds.py:124``)."""

    def __init__(self, src: torch.Tensor, *, trim_fraction: float = 0.0):
        self.src = src                                     # [N,3]
        # ≙ normData, jly_goicp.cpp:142; summed ((x² + y²) + z²) like XLA
        self.norms = torch.sqrt((src[:, 0] * src[:, 0] + src[:, 1] * src[:, 1])
                                + src[:, 2] * src[:, 2])
        self.n_points = int(src.shape[0])
        self.trim_fraction = float(trim_fraction)
        self.h = max(1, int(round(self.n_points * (1.0 - self.trim_fraction))))
        # lattice slack of a distance grid: no grid backend yet, so none
        self.slack = 0.0
