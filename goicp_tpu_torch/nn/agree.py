"""The rule that holds a screened bound kernel (K2, K5, K6, K7) to its plain
version, shared by ``chip_smoke.py`` and ``tests/test_torch_kernels.py``.

The kernels reduce their sums in another order than the plain versions, so
ub and lb agree to 1e-5 + 1e-5·|ref|, and the screen (which compares a
carried sum with a threshold) may fall differently only where that sum sits
within the same tolerance of the threshold.
"""

from __future__ import annotations

import torch

RTOL = ATOL = 1e-5


def screened_agree(ub, lb, ub_p, lb_p, thresh: float, scale: float, group: int = 1):
    """Hold a kernel's ``(ub, lb)`` against its plain version's ``(ub_p,
    lb_p)``.  A node (or a group of ``group`` siblings, screened together)
    reporting ub = 1e30 is screened; kernel and plain version may screen
    differently only where the side that screened has its (smallest) lb
    within ``RTOL·|scale| + ATOL`` of ``thresh``.  Elsewhere ub and lb must
    agree to ``ATOL + RTOL·|ref|``.  Returns ``(ok, max |err|, units
    screened by the plain version, screened-set differences)``."""
    scr = (ub >= 1e29).reshape(-1, group).all(1)
    scr_p = (ub_p >= 1e29).reshape(-1, group).all(1)
    differ = scr != scr_p
    at = torch.where(scr, lb.reshape(-1, group).amin(1), lb_p.reshape(-1, group).amin(1))
    ok = bool(torch.all(torch.abs(at[differ] - thresh) <= RTOL * abs(scale) + ATOL))
    same = (~differ).repeat_interleave(group)
    err = 0.0
    for a, r in ((ub[same], ub_p[same]), (lb[same], lb_p[same])):
        if a.numel():
            err = max(err, float((a - r).abs().max()))
            ok = ok and float(((a - r).abs() - RTOL * r.abs()).max()) <= ATOL
    return ok, err, int(scr_p.sum()), int(differ.sum())


def trim_levels(lb_open, h: int, drop: int, frac: float = 0.5):
    """The trimmed screen's ``(thresh, thresh', τ)`` for thresh = ``frac`` ×
    the median positive unscreened lb (random nodes that overlap the target
    give lb = 0), with τ = 2·thresh/h and thresh' = thresh + drop·τ."""
    thresh = frac * float(lb_open[lb_open > 0].median())
    tau = 2.0 * thresh / h
    return thresh, thresh + drop * tau, tau
