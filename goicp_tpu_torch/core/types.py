"""Core data types as batched tensors: rigid transforms, search-cube
batches and their bounds (port of the JAX package's ``core/types.py``).

:class:`RigidTransform` holds ``R [..., 3, 3]`` and ``t [..., 3]``; its
fields may also hold numpy arrays (solver results carry host poses, as in
the JAX package), while ``apply``/``compose``/``inverse`` take tensors.
:class:`CubeBatch` is a structure-of-arrays batch of axis-aligned cubes and
:class:`Bounds` the lower and upper bounds of one.
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


@dataclasses.dataclass(frozen=True)
class CubeBatch:
    """A batch of axis-aligned search cubes, structure-of-arrays
    (``core/types.py:80``): ``center [B, 3]``, half edge ``span [B]``,
    inherited bounds ``lb``/``ub [B]`` and ``mask [B]`` (False: padding)."""

    center: Any  # [B, 3]
    span: Any  # [B]
    lb: Any  # [B]
    ub: Any  # [B]
    mask: Any  # [B] bool

    @property
    def size(self) -> int:
        return self.center.shape[0]

    @staticmethod
    def root(span: float = 1.0, ub: float = float("inf"), device=None,
             dtype=torch.float32) -> "CubeBatch":
        """The single root cube centered at the origin."""
        return CubeBatch(
            center=torch.zeros((1, 3), dtype=dtype, device=device),
            span=torch.full((1,), span, dtype=dtype, device=device),
            lb=torch.zeros((1,), dtype=dtype, device=device),
            ub=torch.full((1,), ub, dtype=dtype, device=device),
            mask=torch.ones((1,), dtype=torch.bool, device=device),
        )

    def subdivide(self) -> "CubeBatch":
        """8-way octant subdivision of every cube, a batch of ``8·B``: child
        ``j`` of a cube is centered at ``center + (±1, ±1, ±1)·span/2``
        (the signs of bits 0-2 of ``j``) with half the span, and inherits
        the parent's bounds and mask."""
        c, s = self.center, self.span
        j = torch.arange(8, device=c.device)
        offs = (torch.stack([(j >> k) & 1 for k in range(3)], dim=1).to(c.dtype) * 2.0 - 1.0)
        half = s[:, None] / 2.0
        child_c = (c[:, None, :] + offs[None, :, :] * half[..., None]).reshape(-1, 3)
        rep = lambda x: torch.repeat_interleave(x, 8)  # noqa: E731
        return CubeBatch(child_c, rep(s / 2.0), rep(self.lb), rep(self.ub), rep(self.mask))


@dataclasses.dataclass(frozen=True)
class Bounds:
    """Lower and upper SSE bounds of a cube batch, ``[B]`` each
    (``core/types.py:134``)."""

    lb: Any
    ub: Any
