"""Cut generators.

CoverCutGenerator — reference: src/base/CoverCutGenerator.{h,cpp} (used by
KnapCovHandler): for binary knapsack rows sum(a_j x_j) <= b, a fractional
LP point violating a minimal cover C yields the globally valid cut
sum_{j in C} x_j <= |C| - 1.

Separation is host-side numpy over a handful of LP points per superstep;
the cuts land in the same preallocated pool as the QG linearizations.
"""

from __future__ import annotations

from typing import List, Tuple

import numpy as np


def find_knapsack_rows(A: np.ndarray, clb: np.ndarray, cub: np.ndarray,
                       int_mask: np.ndarray, vlb: np.ndarray,
                       vub: np.ndarray,
                       nl_rows=()) -> List[Tuple[int, np.ndarray, float]]:
    """Rows usable for cover cuts: finite ub, all-nonneg coefficients on
    binary variables only (reference: KnapsackList.cpp).  Returns
    (row, var_indices, b).

    ``nl_rows`` MUST list the rows carrying a nonlinear part: their
    linear coefficients alone do not bound the row, so treating them as
    knapsacks yields invalid cuts (cover cuts there once pruned feasible
    tls4 children as 'infeasible')."""
    out = []
    skip = set(int(r) for r in nl_rows)
    is_bin = int_mask & (vlb >= -1e-9) & (vub <= 1.0 + 1e-9)
    for r in range(A.shape[0]):
        if r in skip or not np.isfinite(cub[r]):
            continue
        nz = np.nonzero(A[r])[0]
        if len(nz) < 2:
            continue
        if np.isfinite(clb[r]):
            continue  # ranged/equality rows are not plain knapsacks
        if not np.all(A[r, nz] > 0):
            continue
        if not np.all(is_bin[nz]):
            continue
        out.append((r, nz, float(cub[r]), A[r, nz].copy()))
    return out


def separate_cover_cuts(knap_rows, x: np.ndarray, max_cuts: int = 8,
                        viol_tol: float = 1e-4, extend: bool = True):
    """Greedy minimal-cover separation at x (reference:
    CoverCutGenerator::GNS separation).  Returns [(var_indices, rhs)] for
    cuts sum_{j in C} x_j <= rhs.

    With `extend`, each minimal cover C is grown to the EXTENDED cover
    E(C) = C + {j : a_j >= max_{i in C} a_i} (reference
    CoverCutGenerator cover extension): any |C|-subset of E(C) weighs at
    least as much as C itself (> b), so the same rhs stays valid and the
    cut dominates the plain cover inequality."""
    cuts = []
    for r, nz, b, a in knap_rows:
        xs = x[nz]
        if xs.max() <= viol_tol:
            continue
        order = np.argsort(-xs)
        tot = 0.0
        cover = []
        for o in order:
            cover.append(o)
            tot += a[o]
            if tot > b + 1e-9:
                break
        else:
            continue  # row cannot be violated
        # minimize the cover: drop items whose removal keeps tot > b
        keep = list(cover)
        for o in sorted(cover, key=lambda o: xs[o]):
            if len(keep) > 1 and tot - a[o] > b + 1e-9:
                keep.remove(o)
                tot -= a[o]
        rhs = len(keep) - 1
        members = list(keep)
        if extend:
            amax = max(a[o] for o in keep)
            members += [o for o in range(len(nz))
                        if o not in keep and a[o] >= amax - 1e-12]
        if xs[members].sum() > rhs + viol_tol:
            cuts.append((nz[members], float(rhs)))
            if len(cuts) >= max_cuts:
                break
    return cuts


def _greedy_min_cover(xs: np.ndarray, a: np.ndarray, b: float):
    """Greedy minimal cover at the fractional point xs: add items by
    descending xs until the weights exceed b, then drop redundant items.
    Returns the list of (local) cover members or None."""
    order = np.argsort(-xs)
    tot = 0.0
    cover = []
    for o in order:
        cover.append(int(o))
        tot += a[o]
        if tot > b + 1e-9:
            break
    else:
        return None  # row cannot be violated
    keep = list(cover)
    for o in sorted(cover, key=lambda o: xs[o]):
        if len(keep) > 1 and tot - a[o] > b + 1e-9:
            keep.remove(o)
            tot -= a[o]
    return keep


def separate_lgci_cuts(knap_rows, gub_rows, x: np.ndarray,
                       max_cuts: int = 8, viol_tol: float = 1e-4,
                       max_lift: int = 24):
    """Lifted GUB cover inequalities (reference: LGCIGenerator.{h,cpp},
    the GNS procedure LGCIGenerator.cpp:368-660: cover generation,
    GUB-aware lifting via lifting subproblems).

    TPU-native redesign: separation is host-side data generation (cuts
    land in the preallocated device pool), and the lifting subproblems —
    the reference solves LPs — are solved EXACTLY by a
    min-weight-per-profit knapsack DP that allows at most one item per
    GUB group.  Sequential up-lifting: for each variable j outside the
    cover (most fractional first),

        alpha_j = rhs - max{ sum_i coef_i x_i : sum_i a_i x_i <= b - a_j,
                             <=1 item per GUB, x_j's own GUB excluded }

    which is the strongest valid coefficient given the items lifted so
    far (profits are capped at rhs; the cap is exact because validity of
    the current inequality bounds every feasible completion by rhs).
    Returns [(global_var_indices, coefs, rhs)] for cuts
    sum coef_j x_j <= rhs."""
    # non-overlapping GUB assignment (reference: elimination of
    # duplicates, LGCIGenerator::generateNonOverlap): first GUB wins
    gub_of = {}
    for gid, (_, nz) in enumerate(gub_rows):
        for v in nz:
            gub_of.setdefault(int(v), gid)
    cuts = []
    for r, nz, b, a in knap_rows:
        xs = x[nz]
        if xs.max() <= viol_tol:
            continue
        cover = _greedy_min_cover(xs, a, b)
        if cover is None:
            continue
        rhs = len(cover) - 1
        if rhs < 1:
            continue
        # group id per local var (singleton groups for non-GUB vars)
        nsingle = [0]

        def gid_of(loc):
            g = gub_of.get(int(nz[loc]))
            if g is None:
                nsingle[0] += 1
                return -nsingle[0]
            return g

        items = [(loc, 1, float(a[loc]), gid_of(loc)) for loc in cover]
        in_cut = set(cover)
        rest = [loc for loc in np.argsort(-xs) if int(loc) not in in_cut]
        for loc in rest[:max_lift]:
            loc = int(loc)
            gj = gid_of(loc)
            budget = b - a[loc]
            if budget < -1e-9:
                alpha = rhs        # a_j > b: x_j = 0 in every feasible sol
            else:
                # dp[p] = min weight achieving profit >= p, <=1 per group
                dp = np.full(rhs + 1, np.inf)
                dp[0] = 0.0
                by_group = {}
                for it in items:
                    if it[3] != gj:    # x_j = 1 blocks its own GUB
                        by_group.setdefault(it[3], []).append(it)
                for grp in by_group.values():
                    ndp = dp.copy()
                    for _, alph, w, _ in grp:
                        for p in range(rhs + 1):
                            if np.isfinite(dp[p]):
                                q = min(rhs, p + alph)
                                ndp[q] = min(ndp[q], dp[p] + w)
                    dp = ndp
                best = max(p for p in range(rhs + 1)
                           if dp[p] <= budget + 1e-9)
                alpha = rhs - best
            if alpha > 0:
                items.append((loc, int(alpha), float(a[loc]), gj))
        coefs = np.zeros(len(nz))
        for loc, alph, _, _ in items:
            coefs[loc] = alph
        if float(coefs @ xs) > rhs + viol_tol:
            cuts.append((nz.copy(), coefs, float(rhs)))
            if len(cuts) >= max_cuts:
                break
    return cuts


def find_gub_rows(A: np.ndarray, clb: np.ndarray, cub: np.ndarray,
                  int_mask: np.ndarray, vlb: np.ndarray, vub: np.ndarray,
                  nl_rows=()) -> List[Tuple[int, np.ndarray]]:
    """Generalized-upper-bound rows: sum_{j in S} x_j <= 1 over binaries
    (reference: ProbStructure.{h,cpp} GUB detection, feeding the LGCI
    generator).  Returns (row, var_indices).  Rows with a nonlinear part
    (``nl_rows``) are never GUBs — their linear slice does not bound
    them."""
    out = []
    skip = set(int(r) for r in nl_rows)
    is_bin = int_mask & (vlb >= -1e-9) & (vub <= 1.0 + 1e-9)
    for r in range(A.shape[0]):
        if r in skip or not np.isfinite(cub[r]) or \
                abs(cub[r] - 1.0) > 1e-12:
            continue
        nz = np.nonzero(A[r])[0]
        if len(nz) < 2 or not np.all(is_bin[nz]):
            continue
        if not np.allclose(A[r, nz], 1.0):
            continue
        out.append((r, nz))
    return out
