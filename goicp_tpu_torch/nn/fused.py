"""Fused min-distance and bound kernels — the port of the JAX package's
``nn/mxu.py`` under the same function names.

Layouts are the JAX package's: sources ``srcT [8, Np]`` with rows
(x, y, z, 0…) from :func:`pack_sources` or (x, y, z, ‖p‖, valid, 0…) from
:func:`pack_sources_ext`; targets ``wm [Mp, 8]`` with columns
(m_x, m_y, m_z, 1, |m|², 0…) and padded targets at 1e15; ``Np`` and ``Mp``
padded to multiples of 128; one parameter row per node or group.  The
``pack_*`` functions take numpy arrays or tensors and give the JAX
package's arrays bit for bit.

Each wrapper (:func:`nearest_neighbor_mxu` K1, :func:`min_d2_groups` K3,
:func:`bounds_nodes` K2) runs its CUDA kernel (``csrc/``) for CUDA tensors
and its plain PyTorch version for CPU tensors; there is no fallback from one
to the other.  Every kernel launch adds one to :data:`launches`.
"""

from __future__ import annotations

import torch

from goicp_tpu_torch.nn import kernels
from goicp_tpu_torch.nn.brute import nearest_neighbor

_PAD_TGT = 1e15     # padded targets: far off every min
TQB = 384           # point-block cap of the screened bounds (mxu.py:391)
_MAX_ELEMS = 1 << 24
_INF = float("inf")

# launches of each kernel in this process (plain integers; reset by callers
# that measure a run, e.g. chip_smoke.py)
launches = {"nearest_neighbor_mxu": 0, "min_d2_groups": 0, "bounds_nodes": 0}


def reset_launch_counts():
    for k in launches:
        launches[k] = 0


def _pick_tile(n: int, cap: int, quantum: int = 128) -> int:
    """Largest divisor of ``n`` that is a multiple of ``quantum`` and ≤ cap
    (``mxu.py:50``)."""
    best = quantum
    t = quantum
    while t <= cap:
        if n % t == 0:
            best = t
        t += quantum
    return best


def _f32(x, device=None) -> torch.Tensor:
    return torch.as_tensor(x, dtype=torch.float32, device=device)


def _sq3(v):
    """``sum(v*v, -1)`` over 3 columns, in the order ((x² + y²) + z²)."""
    return (v[..., 0] * v[..., 0] + v[..., 1] * v[..., 1]) + v[..., 2] * v[..., 2]


# ---------------------------------------------------------------------------
# packing (bit-identical to goicp_tpu.nn.mxu.pack_*)
# ---------------------------------------------------------------------------


def pack_targets(targets) -> torch.Tensor:
    """``[Nt,3] → wm [Mp, 8]`` cols (m_x, m_y, m_z, 1, |m|², 0…), padded to
    the 128-row quantum with off-scale sentinels (``mxu.py:320``)."""
    t = _f32(targets)
    padt = (-t.shape[0]) % 128
    if padt:
        t = torch.cat([t, torch.full((padt, 3), _PAD_TGT, dtype=torch.float32,
                                     device=t.device)])
    wm = torch.zeros((t.shape[0], 8), dtype=torch.float32, device=t.device)
    wm[:, 0:3] = t
    wm[:, 3] = 1.0
    wm[:, 4] = _sq3(t)
    return wm


def pack_sources(src) -> torch.Tensor:
    """``[N,3] → srcT [8, Np]`` rows (x, y, z, 0…), zero-padded to the
    128-lane quantum (``mxu.py:340``)."""
    s = _f32(src)
    n = s.shape[0]
    out = torch.zeros((8, n + (-n) % 128), dtype=torch.float32, device=s.device)
    out[0:3, :n] = s.T
    return out


def pack_sources_ext(src, norms) -> torch.Tensor:
    """``[N,3] → srcT [8, Np]`` rows (x, y, z, ‖p‖, valid, 0…) for the fused
    bounds kernel; padding has valid = 0 (``mxu.py:616``)."""
    s = _f32(src)
    n = s.shape[0]
    out = torch.zeros((8, n + (-n) % 128), dtype=torch.float32, device=s.device)
    out[0:3, :n] = s.T
    out[3, :n] = _f32(norms, s.device)
    out[4, :n] = 1.0
    return out


def pack_params(R, t) -> torch.Tensor:
    """``R [B,3,3], t [B,3] → [B,16]`` rigid-transform rows (``mxu.py:351``)."""
    R = _f32(R)
    B = R.shape[0]
    return torch.cat(
        [R.reshape(B, 9), _f32(t, R.device),
         torch.zeros((B, 4), dtype=torch.float32, device=R.device)], dim=1
    )


def pack_group_params(R, t8) -> torch.Tensor:
    """``R [G,3,3], t8 [G,8,3] → [G,48]`` rows (R×9, 8×t×3, 8×|t|², pad)
    (``mxu.py:290``)."""
    R = _f32(R)
    t8 = _f32(t8, R.device)
    G = R.shape[0]
    return torch.cat(
        [R.reshape(G, 9), t8.reshape(G, 24), _sq3(t8),
         torch.zeros((G, 7), dtype=torch.float32, device=R.device)], dim=1
    )


def pack_params_bounds(R, t, af, gt, slack, thresh) -> torch.Tensor:
    """``[B,16]`` rows (R×9, t×3, af, γt, slack, thresh) (``mxu.py:974``).
    ``slack`` and ``thresh`` are scalars."""
    R = _f32(R)
    B = R.shape[0]
    dev = R.device
    return torch.cat(
        [
            R.reshape(B, 9),
            _f32(t, dev),
            _f32(af, dev)[:, None],
            _f32(gt, dev)[:, None],
            torch.full((B, 1), float(slack), dtype=torch.float32, device=dev),
            torch.full((B, 1), float(thresh), dtype=torch.float32, device=dev),
        ],
        dim=1,
    )


# ---------------------------------------------------------------------------
# kernel plumbing
# ---------------------------------------------------------------------------


def _route(name: str, *tensors) -> bool:
    """True: launch the CUDA kernel; False: run the plain version.  Inputs
    must share one device, and only CPU or CUDA is accepted."""
    dev = tensors[0].device
    for t in tensors:
        if t.device != dev:
            raise ValueError(f"{name}: inputs on {dev} and {t.device}")
    if dev.type == "cuda":
        return True
    if dev.type == "cpu":
        return False
    raise ValueError(f"{name}: unsupported device {dev}")


def _expect(name: str, t: torch.Tensor, shape, dtype=torch.float32):
    if t.dtype != dtype or not t.is_contiguous() or tuple(t.shape) != tuple(shape):
        raise ValueError(
            f"{name}: expected contiguous {dtype} {tuple(shape)}, got "
            f"{t.dtype} {tuple(t.shape)} contiguous={t.is_contiguous()}"
        )


def _stream(t: torch.Tensor):
    return torch.cuda.current_stream(t.device).cuda_stream


def _rows(P, r0: int, px, py, pz):
    """``((px·P[r0] + py·P[r0+1]) + pz·P[r0+2])`` for every row of ``P``:
    one row of R·p per node, ``[B, Np]``, in the kernels' order."""
    return (px[None] * P[:, r0:r0 + 1] + py[None] * P[:, r0 + 1:r0 + 2]) \
        + pz[None] * P[:, r0 + 2:r0 + 3]


def _transform(params, srcT):
    px, py, pz = srcT[0], srcT[1], srcT[2]
    qx = _rows(params, 0, px, py, pz) + params[:, 9:10]
    qy = _rows(params, 3, px, py, pz) + params[:, 10:11]
    qz = _rows(params, 6, px, py, pz) + params[:, 11:12]
    return qx, qy, qz


def _min_d2_plain(qx, qy, qz, wm, tile: int = 512):
    """Min over targets of |m − q|² (diff form) for query coordinate
    tensors of any shape; chunked over queries."""
    shape = qx.shape
    qx, qy, qz = qx.reshape(-1), qy.reshape(-1), qz.reshape(-1)
    best = torch.full_like(qx, _INF)
    qc = max(1, _MAX_ELEMS // tile)
    for q0 in range(0, qx.shape[0], qc):
        sl = slice(q0, q0 + qc)
        b = best[sl]
        for m0 in range(0, wm.shape[0], tile):
            w = wm[m0:m0 + tile]
            dx = w[None, :, 0] - qx[sl, None]
            dy = w[None, :, 1] - qy[sl, None]
            dz = w[None, :, 2] - qz[sl, None]
            b.copy_(torch.minimum(b, ((dx * dx + dy * dy) + dz * dz).amin(dim=1)))
    return best.reshape(shape)


# ---------------------------------------------------------------------------
# K1: exact nearest neighbour (csrc/nn_min_d2.cu)
# ---------------------------------------------------------------------------


def _nn_kernel(flat, targets):
    srcT = pack_sources(flat)
    wm = pack_targets(targets)
    dev = flat.device
    params = pack_params(torch.eye(3, device=dev)[None], torch.zeros((1, 3), device=dev))
    Np, Mp = srcT.shape[1], wm.shape[0]
    _expect("nearest_neighbor_mxu", srcT, (8, Np))
    _expect("nearest_neighbor_mxu", wm, (Mp, 8))
    d2 = torch.empty((1, Np), dtype=torch.float32, device=dev)
    idx = torch.empty((1, Np), dtype=torch.int32, device=dev)
    err = kernels.lib().goicp_nn_min_d2(
        params.data_ptr(), 1, srcT.data_ptr(), Np, wm.data_ptr(), Mp,
        d2.data_ptr(), idx.data_ptr(), _stream(flat),
    )
    kernels.check(err, "nearest_neighbor_mxu")
    launches["nearest_neighbor_mxu"] += 1
    return idx[0, :flat.shape[0]]


def nearest_neighbor_mxu(queries, targets):
    """Exact NN (values + indices), the drop-in of ``nn.brute.nearest_neighbor``
    (``mxu.py:1026``): ``queries [..., Q, 3]``, ``targets [Nt, 3]`` →
    ``(d2 [..., Q], idx [..., Q] int32)``.  As in the JAX wrapper, the index
    is clamped to ``Nt − 1`` and ``d2`` recomputed from the gathered winner.
    """
    batch_shape = queries.shape[:-2]
    Q = queries.shape[-2]
    flat = queries.reshape(-1, 3).contiguous()
    if _route("nearest_neighbor_mxu", flat, targets):
        if flat.shape[0] == 0:
            idx = torch.zeros((0,), dtype=torch.int32, device=flat.device)
        else:
            idx = _nn_kernel(flat, targets.contiguous())
    else:
        _, idx = nearest_neighbor(flat, targets)
    idx = torch.clamp(idx, max=targets.shape[0] - 1)
    d2 = _sq3(flat - targets.index_select(0, idx))
    return d2.reshape(*batch_shape, Q), idx.reshape(*batch_shape, Q)


# ---------------------------------------------------------------------------
# K3: grouped min distances (csrc/min_d2_grouped.cu)
# ---------------------------------------------------------------------------


def min_d2_groups_plain(srcT, wm, gparams, tile: int = 512):
    """Plain version of K3 (``mxu.py:196``, diff form): ``d2 [8G, Np]``."""
    P = gparams
    G, Np = P.shape[0], srcT.shape[1]
    px, py, pz = srcT[0], srcT[1], srcT[2]
    ux = _rows(P, 0, px, py, pz)
    uy = _rows(P, 3, px, py, pz)
    uz = _rows(P, 6, px, py, pz)                          # [G, Np]
    t = P[:, 9:33].reshape(G, 8, 3)
    tn = P[:, 33:41]
    wx, wy, wz = wm[:, 0], wm[:, 1], wm[:, 2]
    s = (t[..., 0:1] * wx + t[..., 1:2] * wy) + t[..., 2:3] * wz
    b = tn[..., None] - 2.0 * s                           # [G, 8, Mp]
    best = torch.full((G, 8, Np), _INF, dtype=torch.float32, device=srcT.device)
    gc = max(1, _MAX_ELEMS // (Np * tile))
    for g0 in range(0, G, gc):
        gs = slice(g0, g0 + gc)
        for m0 in range(0, wm.shape[0], tile):
            ms = slice(m0, m0 + tile)
            dx = wx[None, None, ms] - ux[gs, :, None]
            dy = wy[None, None, ms] - uy[gs, :, None]
            dz = wz[None, None, ms] - uz[gs, :, None]
            Gp = (dx * dx + dy * dy) + dz * dz            # [gc, Np, tile]
            for j in range(8):
                cur = (Gp + b[gs, j, None, ms]).amin(dim=2)
                best[gs, j] = torch.minimum(best[gs, j], cur)
    a = 2.0 * ((t[..., 0:1] * ux[:, None] + t[..., 1:2] * uy[:, None])
               + t[..., 2:3] * uz[:, None])               # [G, 8, Np]
    return torch.clamp(best + a, min=0.0).reshape(8 * G, Np)


def min_d2_groups(srcT, wm, gparams):
    """Exact min squared distances for 8-sibling translation groups:
    ``d2 [8·G, Np]``, row ``8g+j`` = node (R_g, t_{g,j}) (``mxu.py:303``)."""
    if not _route("min_d2_groups", srcT, wm, gparams):
        return min_d2_groups_plain(srcT, wm, gparams)
    G, Np, Mp = gparams.shape[0], srcT.shape[1], wm.shape[0]
    _expect("min_d2_groups", srcT, (8, Np))
    _expect("min_d2_groups", wm, (Mp, 8))
    _expect("min_d2_groups", gparams, (G, 48))
    d2 = torch.empty((8 * G, Np), dtype=torch.float32, device=srcT.device)
    if G == 0:
        return d2
    err = kernels.lib().goicp_min_d2_grouped(
        gparams.data_ptr(), G, srcT.data_ptr(), Np, wm.data_ptr(), Mp,
        d2.data_ptr(), _stream(srcT),
    )
    kernels.check(err, "min_d2_groups")
    launches["min_d2_groups"] += 1
    return d2


# ---------------------------------------------------------------------------
# K2: screened fused bounds (csrc/bounds.cu)
# ---------------------------------------------------------------------------


def bounds_block_sums_plain(srcT_ext, wm, params):
    """Per point-block sums of the ub and lb terms, ``[B, nb]`` each, with
    blocks of ``tq = _pick_tile(Np, 384)`` points (no screening)."""
    B, Np = params.shape[0], srcT_ext.shape[1]
    tq = _pick_tile(Np, TQB)
    qx, qy, qz = _transform(params, srcT_ext)
    d = torch.sqrt(torch.clamp(_min_d2_plain(qx, qy, qz, wm), min=0.0))
    slack = params[:, 14:15]
    d_hi = d + slack
    d_lo = torch.clamp(d - slack, min=0.0)
    defl = params[:, 12:13] * srcT_ext[3][None] + params[:, 13:14]
    lb_c = torch.clamp(d_lo - defl, min=0.0)
    pv = srcT_ext[4][None]
    ub_t = (d_hi * d_hi) * pv
    lb_t = (lb_c * lb_c) * pv
    nb = Np // tq
    return ub_t.reshape(B, nb, tq).sum(-1), lb_t.reshape(B, nb, tq).sum(-1)


def screen_scan(ub_blk, lb_blk, thresh):
    """The screening rule over block sums: a block is added only while the
    carried lb is below ``thresh``; ub = 1e30 once lb ≥ thresh
    (``mxu.py:462-473``).  Returns ``(ub, lb, blocks_run)``."""
    B, nb = ub_blk.shape
    ub = torch.zeros((B,), dtype=torch.float32, device=ub_blk.device)
    lb = torch.zeros_like(ub)
    blocks = torch.zeros((B,), dtype=torch.int64, device=ub_blk.device)
    for n in range(nb):
        run = lb < thresh
        ub = torch.where(run, ub + ub_blk[:, n], ub)
        lb = torch.where(run, lb + lb_blk[:, n], lb)
        blocks += run
    return torch.where(lb < thresh, ub, torch.full_like(ub, 1e30)), lb, blocks


def bounds_nodes_plain(srcT_ext, wm, params):
    """Plain version of K2 (``mxu.py:403``): ``(ub, lb) [B]``."""
    ub_blk, lb_blk = bounds_block_sums_plain(srcT_ext, wm, params)
    ub, lb, _ = screen_scan(ub_blk, lb_blk, params[:, 15])
    return ub, lb


def bounds_nodes(srcT_ext, wm, params):
    """Fused screened bounds for singleton nodes: ``(ub, lb) [B]``
    (``mxu.py:1012``)."""
    if not _route("bounds_nodes", srcT_ext, wm, params):
        return bounds_nodes_plain(srcT_ext, wm, params)
    B, Np, Mp = params.shape[0], srcT_ext.shape[1], wm.shape[0]
    _expect("bounds_nodes", srcT_ext, (8, Np))
    _expect("bounds_nodes", wm, (Mp, 8))
    _expect("bounds_nodes", params, (B, 16))
    ub = torch.empty((B,), dtype=torch.float32, device=params.device)
    lb = torch.empty_like(ub)
    if B == 0:
        return ub, lb
    err = kernels.lib().goicp_bounds_nodes(
        params.data_ptr(), B, srcT_ext.data_ptr(), Np, wm.data_ptr(), Mp,
        _pick_tile(Np, TQB), ub.data_ptr(), lb.data_ptr(), _stream(params),
    )
    kernels.check(err, "bounds_nodes")
    launches["bounds_nodes"] += 1
    return ub, lb
