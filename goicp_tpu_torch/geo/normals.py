"""Surface normals by PCA over the k nearest neighbours — port of the JAX
package's ``geo/normals.py`` (plain PyTorch; the JAX package computes them
in XLA, outside any Pallas kernel).

Normals feed the point-to-plane ICP metric (:mod:`goicp_tpu_torch.icp`).
The kNN is the tiled dense pattern of the exact NN: blocks of queries
against the whole cloud, with an exact ``torch.topk`` everywhere (the JAX
package switches to ``approx_min_k`` on a TPU above 2,048 points; on the
CPU it is exact, as here).  The smallest eigenvector of each 3x3
neighbourhood covariance is closed-form (trigonometric eigenvalues and a
cross-product eigenvector), so no ``eigh`` runs.
"""

from __future__ import annotations

import torch


def _det_3x3(a):
    """The closed form ``jnp.linalg.det`` uses for 3x3 matrices."""
    return (a[..., 0, 0] * a[..., 1, 1] * a[..., 2, 2]
            + a[..., 0, 1] * a[..., 1, 2] * a[..., 2, 0]
            + a[..., 0, 2] * a[..., 1, 0] * a[..., 2, 1]
            - a[..., 0, 2] * a[..., 1, 1] * a[..., 2, 0]
            - a[..., 0, 0] * a[..., 1, 2] * a[..., 2, 1]
            - a[..., 0, 1] * a[..., 1, 0] * a[..., 2, 2])


def _pick_row(X, idx):
    """``X[..., idx, :]`` per batch element: ``X [..., 3, 3]``, ``idx [...]``."""
    return torch.gather(X, -2, idx[..., None, None].expand(*idx.shape, 1, 3))[..., 0, :]


def _smallest_eigvec_3x3(C):
    """Unit eigenvector of the smallest eigenvalue of symmetric ``[...,3,3]``
    (``normals.py:25``).

    Eigenvalues via the trigonometric closed form (Smith 1961); the
    eigenvector is the largest cross product of two rows of ``C − lmin·I``.
    Rank-1 ``C − lmin·I`` (collinear neighbourhoods) crosses its largest row
    with the axis it is least aligned with; isotropic neighbourhoods fall
    back to +z.
    """
    eye = torch.eye(3, dtype=C.dtype, device=C.device)
    q = torch.diagonal(C, dim1=-2, dim2=-1).sum(-1)[..., None, None] / 3.0
    A = C - q * eye
    p2 = (A * A).sum((-2, -1)) / 6.0
    p = torch.sqrt(torch.clamp(p2, min=0.0))
    ps = torch.clamp(p, min=1e-30)[..., None, None]
    B = A / ps
    r = torch.clamp(_det_3x3(B) / 2.0, -1.0, 1.0)
    phi = torch.arccos(r) / 3.0
    lmin = q[..., 0, 0] + 2.0 * p * torch.cos(phi + 2.0 * torch.pi / 3.0)

    M = C - lmin[..., None, None] * eye
    c01 = torch.linalg.cross(M[..., 0, :], M[..., 1, :])
    c02 = torch.linalg.cross(M[..., 0, :], M[..., 2, :])
    c12 = torch.linalg.cross(M[..., 1, :], M[..., 2, :])
    cands = torch.stack([c01, c02, c12], dim=-2)                  # [...,3,3]
    n2 = (cands * cands).sum(-1)                                  # [...,3]
    v = _pick_row(cands, torch.argmax(n2, dim=-1))
    vn2 = (v * v).sum(-1, keepdim=True)

    rn2 = (M * M).sum(-1)
    row = _pick_row(M, torch.argmax(rn2, dim=-1))
    axis = torch.nn.functional.one_hot(
        torch.argmin(torch.abs(row), dim=-1), 3).to(C.dtype)
    v2 = torch.linalg.cross(row, axis)
    v2n2 = (v2 * v2).sum(-1, keepdim=True)

    fallback = torch.zeros_like(v)
    fallback[..., 2] = 1.0
    v2 = torch.where(v2n2 > 1e-18, v2 / torch.sqrt(torch.clamp(v2n2, min=1e-30)), fallback)
    # relative tolerance: cross-product magnitudes scale with |M|^2
    scale2 = torch.clamp(rn2.sum(-1, keepdim=True) ** 2, min=1e-30)
    return torch.where(vn2 > 1e-12 * scale2, v / torch.sqrt(torch.clamp(vn2, min=1e-30)), v2)


def estimate_normals(points, k: int = 16, block: int = 1024):
    """PCA normals of ``points [N,3]`` (a tensor, on its own device) from
    each point's ``k`` nearest neighbours, the point itself included
    (``normals.py:83``).  Returns unit normals ``[N,3]``, sign-ambiguous (the
    plane metric squares the residual).  Each block of queries makes one
    ``[block, N]`` distance tile."""
    pts = points.to(torch.float32)
    n = pts.shape[0]
    kk = min(k, n)
    pn = (pts * pts).sum(-1)
    out = []
    for s in range(0, n, block):
        qb = pts[s:s + block]
        d2 = ((qb * qb).sum(-1)[:, None] - 2.0 * (qb @ pts.T)) + pn[None, :]
        idx = torch.topk(-d2, kk, dim=1).indices                  # [b, kk]
        nbr = pts[idx]                                            # [b, kk, 3]
        d = nbr - nbr.mean(dim=1, keepdim=True)
        C = torch.einsum("bki,bkj->bij", d, d) / kk
        out.append(_smallest_eigvec_3x3(C))
    return torch.cat(out) if out else pts.new_zeros((0, 3))
