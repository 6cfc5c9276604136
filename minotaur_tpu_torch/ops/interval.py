"""Linear-row FBBT, batched over (B, n) boxes.

Port of minotaur_tpu/ops/interval.py::linear_fbbt (the JAX function is one
box, vmapped by its callers; here the lane axis is written out).  The
interval rules of nonlinear expression graphs (`stage_interval`,
`stage_fbbt`) belong to the NL path, which is not ported yet.
"""

from __future__ import annotations

import torch

_INF = float("inf")


def linear_fbbt(A: torch.Tensor, row_lo: torch.Tensor, row_hi: torch.Tensor,
                xlo: torch.Tensor, xhi: torch.Tensor):
    """One vectorized FBBT sweep over all linear rows, for every lane.

    A (m, n) and row_lo/row_hi (m,) are shared; xlo/xhi are (B, n).
    Returns (new_xlo, new_xhi, infeasible (B,) bool).  Infinities are
    tracked explicitly exactly as in the JAX function: zero coefficients
    are masked inside the products (0 * inf = NaN), and the activity
    excluding column j distinguishes 0, 1 and several infinite terms.
    """
    m = A.shape[0]
    pos = torch.clamp(A, min=0.0)[None]          # (1, m, n)
    neg = torch.clamp(A, max=0.0)[None]
    lo = xlo[:, None, :]                          # (B, 1, n)
    hi = xhi[:, None, :]

    def _sm(a, b):
        return torch.where(a == 0.0, 0.0, a * b)

    term_min = _sm(pos, lo) + _sm(neg, hi)        # (B, m, n)
    term_max = _sm(pos, hi) + _sm(neg, lo)
    inf_min = ~torch.isfinite(term_min)
    inf_max = ~torch.isfinite(term_max)
    tmin_f = torch.where(inf_min, 0.0, term_min)
    tmax_f = torch.where(inf_max, 0.0, term_max)
    fin_min = tmin_f.sum(dim=2)                   # (B, m)
    fin_max = tmax_f.sum(dim=2)
    ninf_min = inf_min.sum(dim=2)
    ninf_max = inf_max.sum(dim=2)
    minact = torch.where(ninf_min > 0, -_INF, fin_min)
    maxact = torch.where(ninf_max > 0, _INF, fin_max)
    infeas = (minact > row_hi[None] + 1e-7).any(dim=1) | \
        (maxact < row_lo[None] - 1e-7).any(dim=1)

    # min-activity excluding column j:
    #   0 infinite terms          -> fin_min - term_min[:, j]
    #   1 infinite term, it is j  -> fin_min (the finite remainder)
    #   otherwise                 -> -inf
    rmin = torch.where(ninf_min[:, :, None] == 0, fin_min[:, :, None] - tmin_f,
                       torch.where((ninf_min[:, :, None] == 1) & inf_min,
                                   fin_min[:, :, None], -_INF))
    rmax = torch.where(ninf_max[:, :, None] == 0, fin_max[:, :, None] - tmax_f,
                       torch.where((ninf_max[:, :, None] == 1) & inf_max,
                                   fin_max[:, :, None], _INF))

    Ab = A[None]
    safe = torch.where(Ab == 0.0, 1.0, Ab)
    # a_ij > 0: x_j <= (hi_i - rmin_ij)/a_ij ; x_j >= (lo_i - rmax_ij)/a_ij
    ub_pos = (row_hi[None, :, None] - rmin) / safe
    lb_pos = (row_lo[None, :, None] - rmax) / safe
    # a_ij < 0: x_j >= (hi_i - rmin_ij)/a_ij ; x_j <= (lo_i - rmax_ij)/a_ij
    new_ub = torch.where(Ab > 0.0, ub_pos, torch.where(Ab < 0.0, lb_pos, _INF))
    new_lb = torch.where(Ab > 0.0, lb_pos, torch.where(Ab < 0.0, ub_pos, -_INF))
    # ignore rows with infinite activities (no information)
    new_ub = torch.where(torch.isfinite(new_ub), new_ub, _INF)
    new_lb = torch.where(torch.isfinite(new_lb), new_lb, -_INF)
    if m:
        xhi2 = torch.minimum(xhi, new_ub.amin(dim=1))
        xlo2 = torch.maximum(xlo, new_lb.amax(dim=1))
    else:
        xhi2, xlo2 = xhi, xlo
    infeas = infeas | (xlo2 > xhi2 + 1e-9).any(dim=1)
    return xlo2, xhi2, infeas
