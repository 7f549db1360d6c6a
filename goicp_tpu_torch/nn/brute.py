"""Exact brute-force nearest neighbour — the plain PyTorch version of K1
(port of the JAX package's ``nn/brute.py:nearest_neighbor``).

A loop over target tiles keeps a running ``(min, argmin)``: within a tile
the first minimum wins, across tiles a strict ``<``, so the earliest target
reaching the global minimum wins, as in the TPU kernel
(``goicp_tpu/nn/mxu.py:131-135``) and the CUDA kernel
(``csrc/nn_min_d2.cu``).  Distances are coordinate differences in f32, one
rounding per operation.  Queries are chunked so no temporary exceeds
``2**24`` elements.
"""

from __future__ import annotations

import torch

_MAX_ELEMS = 1 << 24


def nearest_neighbor(queries, targets, tile: int = 512):
    """Exact NN: ``queries [..., Q, 3]``, ``targets [Nt, 3]`` →
    ``(dist_sq [..., Q] f32, index [..., Q] int32)``."""
    shape = queries.shape[:-1]
    q = queries.reshape(-1, 3)
    nq = q.shape[0]
    best = torch.full((nq,), float("inf"), dtype=torch.float32, device=q.device)
    bidx = torch.zeros((nq,), dtype=torch.int64, device=q.device)
    qc = max(1, _MAX_ELEMS // tile)
    for q0 in range(0, nq, qc):
        qs = q[q0:q0 + qc]
        b, bi = best[q0:q0 + qc], bidx[q0:q0 + qc]
        for m0 in range(0, targets.shape[0], tile):
            tt = targets[m0:m0 + tile]
            dx = tt[None, :, 0] - qs[:, 0:1]
            dy = tt[None, :, 1] - qs[:, 1:2]
            dz = tt[None, :, 2] - qs[:, 2:3]
            d2 = (dx * dx + dy * dy) + dz * dz
            val, arg = torch.min(d2, dim=1)
            take = val < b
            b.copy_(torch.where(take, val, b))
            bi.copy_(torch.where(take, arg + m0, bi))
    return best.reshape(shape), bidx.to(torch.int32).reshape(shape)
