"""Rigid transforms as batched tensors (``R [..., 3, 3]``, ``t [..., 3]``).

Port of the JAX package's ``core/types.py:RigidTransform``.  The fields may
also hold numpy arrays (solver results carry host poses, as in the JAX
package); ``apply``/``compose``/``inverse`` take tensors.
"""

from __future__ import annotations

import dataclasses
from typing import Any

import torch


@dataclasses.dataclass(frozen=True)
class RigidTransform:
    """A (batch of) rigid transform(s): ``y = R @ x + t``."""

    R: Any  # [..., 3, 3]
    t: Any  # [..., 3]

    @staticmethod
    def identity(batch_shape=(), device=None, dtype=torch.float32) -> "RigidTransform":
        R = torch.eye(3, dtype=dtype, device=device).expand(*batch_shape, 3, 3)
        t = torch.zeros((*batch_shape, 3), dtype=dtype, device=device)
        return RigidTransform(R, t)

    def apply(self, points):
        """Transform points ``[..., N, 3]`` by this transform."""
        return points @ self.R.transpose(-1, -2) + self.t[..., None, :]

    def compose(self, other: "RigidTransform") -> "RigidTransform":
        """Return ``self ∘ other`` (apply ``other`` first):
        ``R = R_s R_o``, ``t = R_s t_o + t_s``."""
        R = self.R @ other.R
        t = (self.R @ other.t[..., None])[..., 0] + self.t
        return RigidTransform(R, t)

    def inverse(self) -> "RigidTransform":
        Rt = self.R.transpose(-1, -2)
        return RigidTransform(Rt, -(Rt @ self.t[..., None])[..., 0])

    @property
    def batch_shape(self):
        return tuple(self.t.shape[:-1])
