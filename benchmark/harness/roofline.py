"""The least time one NVIDIA H100 could take for a kernel call.

Frozen copies of `chip_smoke.py`'s `bound`, `k1_bound` and `k2_bound`
(the card's data-sheet peaks at 700 W; dense rates), so that a change to
the program cannot move the yardstick.  `k2_bound_rhs` extends `k2_bound`
to R right-hand sides: R times the products and vectors, the matrices
read once; at R = 1 it is `k2_bound`.
"""

from __future__ import annotations

HBM_BYTES_S = 3.35e12
PEAK_FLOPS = {4: 67e12, 8: 67e12}


def bound(flops, nbytes, itemsize):
    """(bound_ms, bound_by): the larger of operations over the peak rate
    for the type and bytes over the memory rate."""
    t_ops = flops / PEAK_FLOPS[itemsize]
    t_bytes = nbytes / HBM_BYTES_S
    return max(t_ops, t_bytes) * 1e3, ("operations" if t_ops >= t_bytes
                                        else "bytes")


def k1_bound(B, k, itemsize):
    """K1: potrf + trtri + lauum, k^3/3 flops each per lane; one read of
    the lower triangle of ms (all the function needs) and one write of
    Minv."""
    return bound(B * k ** 3, B * (k * (k + 1) // 2 + k * k) * itemsize,
                 itemsize)


def k2_bound(B, k, sf, sm=None, steps=0):
    """K2 on (B, k) lanes with one right-hand side, factor and operator
    element sizes sf and sm: 2 k^2 flops a product, one product at refine
    0, and with refinement 2 + 2 steps (the first solve and residual, then
    a solve and a residual a round); reads Minv once, M once when refining
    (one pass each is all the function needs), dinv, r (and shift when
    refining) once, and writes x once."""
    sm = sm or sf
    prods = 1 if steps == 0 else 2 + 2 * steps
    nbytes = B * k * k * sf + (B * k * k * sm if steps else 0) + \
        B * k * sm * (2 if steps else 1) + 2 * B * k * sm
    return bound(2 * B * k * k * prods, nbytes, max(sf, sm))


def k2_bound_rhs(B, k, sf, sm=None, steps=0, R=1):
    """`k2_bound` with R right-hand sides."""
    if R == 1:
        return k2_bound(B, k, sf, sm, steps)
    sm = sm or sf
    prods = 1 if steps == 0 else 2 + 2 * steps
    nbytes = B * k * k * sf + (B * k * k * sm if steps else 0) + \
        B * k * sm * (2 if steps else 1) + 2 * B * k * sm * R
    return bound(2 * B * k * k * prods * R, nbytes, max(sf, sm))
