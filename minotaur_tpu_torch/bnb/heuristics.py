"""Host-only rounding helpers of minotaur_tpu/bnb/heuristics.py.

Copied verbatim: `find_partition_rows`, `partition_round` and
`swap_local_search` serve the B&B driver's in-tree rounding
(`BranchAndBound._try_round_incumbent`).  The engine-driven heuristics
of that module (pump, sampling, fix-vars, dives) are not ported yet.
"""

from __future__ import annotations

import numpy as np


def find_partition_rows(A: np.ndarray, clb: np.ndarray, cub: np.ndarray,
                        int_mask: np.ndarray, nl_rows=()):
    """Rows of the form sum(binary vars) == k (set partition / cardinality)
    — the structure that naive rounding always breaks.  Returns a list of
    (var_indices, k).  Rows with a nonlinear part are excluded (their
    linear slice is not the whole row)."""
    rows = []
    skip = set(int(r) for r in nl_rows)
    m, n = A.shape
    for r in range(m):
        if r in skip or \
                not (np.isfinite(clb[r]) and abs(clb[r] - cub[r]) <= 1e-12):
            continue
        k = clb[r]
        if abs(k - round(k)) > 1e-9 or k < 0:
            continue
        nz = np.nonzero(A[r])[0]
        if len(nz) < 2:
            continue
        if not np.all(np.abs(A[r, nz] - 1.0) <= 1e-12):
            continue
        if not np.all(int_mask[nz]):
            continue
        rows.append((nz, int(round(k))))
    return rows


def partition_round(x: np.ndarray, partition_rows, int_mask: np.ndarray,
                    rng=None, noise: float = 0.0) -> np.ndarray:
    """Round integers, then repair every partition row by selecting its
    top-k fractional variables (reference analogue: the repair step of
    diving heuristics).  Optional noise diversifies repeated calls.

    Rows may OVERLAP (a variable in two partition rows): variables a
    previous row already committed to 1 count toward the current row's
    quota, and variables committed to 0 are never re-raised — naive
    independent per-row repair breaks earlier rows."""
    xr = x.copy()
    xr[int_mask] = np.round(xr[int_mask])
    part_vars = set()
    for nz, _ in partition_rows:
        part_vars.update(int(j) for j in nz)
    committed = {}  # var -> 0.0 or 1.0 decided by an earlier row
    for nz, k in partition_rows:
        score = x[nz].astype(float)
        if noise and rng is not None:
            score = score + rng.uniform(0, noise, size=len(nz))
        already = [i for i, j in enumerate(nz) if committed.get(int(j)) == 1.0]
        free = [i for i, j in enumerate(nz) if int(j) not in committed]
        need = k - len(already)
        picks = []
        if need > 0 and free:
            order = sorted(free, key=lambda i: -score[i])
            picks = order[:need]
        for i, j in enumerate(nz):
            j = int(j)
            if j in committed:
                xr[j] = committed[j]
            elif i in picks:
                xr[j] = 1.0
                committed[j] = 1.0
            else:
                xr[j] = 0.0
                committed[j] = 0.0
    return xr


def swap_local_search(x: np.ndarray, partition_rows, c: np.ndarray,
                      Qobj=None, max_passes: int = 6) -> np.ndarray:
    """1-swap improvement over partition rows: move the selected variable
    of a row to another member if the objective drops (classic local
    search for assignment/coloring MIQPs; reference analogue: the
    improvement phase of MultiSolHeur).  Objective deltas are O(1) using
    the cached gradient g = c + (Q+Q')x:
        f(x + e_a - e_b) - f(x) = g_a - g_b + Q_aa + Q_bb - (Q+Q')_ab.
    Only valid for swaps *within* non-overlapping structure; the caller
    re-checks feasibility before accepting the point."""
    xr = x.copy()
    if Qobj is not None:
        Qs = Qobj + Qobj.T
        g = c + Qs @ xr
    else:
        Qs = None
        g = c.copy()
    improved = True
    passes = 0
    while improved and passes < max_passes:
        improved = False
        passes += 1
        for nz, k in partition_rows:
            ones = [int(j) for j in nz if xr[j] > 0.5]
            zeros = [int(j) for j in nz if xr[j] <= 0.5]
            for b in ones:
                best_a, best_d = None, -1e-9
                for a in zeros:
                    if Qs is None:
                        d = g[a] - g[b]
                    else:
                        d = (g[a] - g[b] + Qobj[a, a] + Qobj[b, b]
                             - Qs[a, b])
                    if d < best_d:
                        best_a, best_d = a, d
                if best_a is not None:
                    a = best_a
                    xr[b] = 0.0
                    xr[a] = 1.0
                    if Qs is not None:
                        g = g + Qs[:, a] - Qs[:, b]
                    zeros.remove(a)
                    zeros.append(b)
                    improved = True
    return xr
