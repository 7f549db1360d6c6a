"""Batched 3x3 orthogonal Procrustes (the ICP pose update), port of the JAX
package's ``geo/procrustes.py``.

Horn's quaternion method: the optimal rotation is the dominant eigenvector
of a 4x4 symmetric matrix built from the cross-covariance.  It is found by
repeated matrix squaring and a few power-iteration steps — no ``eigh``, no
SVD, no determinant correction — exactly as the JAX version does, so both
packages take the same steps.
"""

from __future__ import annotations

import functools

import torch

from goicp_tpu_torch.geo.rotation import quat_to_matrix

_Q0 = (1.0, 0.3, 0.2, 0.1)  # fixed, generically non-orthogonal start


@functools.lru_cache(maxsize=None)
def _q0(dtype, device) -> torch.Tensor:
    """:data:`_Q0` as a tensor, built once per device and dtype: a CUDA
    graph that runs :func:`horn_quaternion` reads it and copies no host
    memory (``icp/solver.py`` captures the ICP iteration)."""
    return torch.tensor(_Q0, dtype=dtype, device=device)


def _horn_K(C):
    """Horn's 4x4 symmetric matrix from cross-covariance ``C[...,3,3]``."""
    Sxx, Sxy, Sxz = C[..., 0, 0], C[..., 0, 1], C[..., 0, 2]
    Syx, Syy, Syz = C[..., 1, 0], C[..., 1, 1], C[..., 1, 2]
    Szx, Szy, Szz = C[..., 2, 0], C[..., 2, 1], C[..., 2, 2]
    row0 = torch.stack([Sxx + Syy + Szz, Syz - Szy, Szx - Sxz, Sxy - Syx], -1)
    row1 = torch.stack([Syz - Szy, Sxx - Syy - Szz, Sxy + Syx, Szx + Sxz], -1)
    row2 = torch.stack([Szx - Sxz, Sxy + Syx, -Sxx + Syy - Szz, Syz + Szy], -1)
    row3 = torch.stack([Sxy - Syx, Szx + Sxz, Syz + Szy, -Sxx - Syy + Szz], -1)
    return torch.stack([row0, row1, row2, row3], dim=-2)


def horn_quaternion(C, squarings: int = 5, iters: int = 8):
    """Dominant eigen-quaternion of Horn's matrix, ``[...,3,3] → [...,4]``.

    ``K + 2|C|_F I`` is PSD with the same dominant eigenvector; squaring
    raises the spectral ratio to the ``2^squarings`` power, then power
    iteration polishes.  ``C = 0`` gives the identity quaternion."""
    K = _horn_K(C)
    eye = torch.eye(4, dtype=C.dtype, device=C.device)
    shift = 2.0 * torch.linalg.matrix_norm(C, keepdim=True) + 1e-30
    Ks = (K + shift * eye) / shift
    for _ in range(squarings):
        Ks = Ks @ Ks
        Ks = Ks / torch.clamp(torch.linalg.matrix_norm(Ks, keepdim=True), min=1e-30)
    q = _q0(C.dtype, C.device).expand(*C.shape[:-2], 4)
    for _ in range(iters):
        q = (Ks @ q[..., None])[..., 0]
        q = q / torch.clamp(torch.linalg.vector_norm(q, dim=-1, keepdim=True), min=1e-30)
    return q * torch.where(q[..., :1] < 0, -1.0, 1.0)


def procrustes(src, dst, weights=None, iters: int = 8):
    """Weighted least-squares rigid alignment, batched.

    ``src``/``dst``: ``[..., N, 3]``; ``weights``: optional ``[..., N]``.
    Returns ``(R, t)`` minimizing ``sum_i w_i |R src_i + t - dst_i|^2``."""
    if weights is None:
        w = torch.ones(src.shape[:-1], dtype=src.dtype, device=src.device)
    else:
        w = weights
    wsum = torch.clamp(torch.sum(w, dim=-1, keepdim=True), min=1e-30)
    mu_s = torch.sum(src * w[..., None], dim=-2) / wsum
    mu_d = torch.sum(dst * w[..., None], dim=-2) / wsum
    a = src - mu_s[..., None, :]
    b = dst - mu_d[..., None, :]
    C = (a * w[..., None]).transpose(-1, -2) @ b
    q = horn_quaternion(C, iters=iters)
    R = quat_to_matrix(q)
    t = mu_d - (R @ mu_s[..., None])[..., 0]
    return R, t
