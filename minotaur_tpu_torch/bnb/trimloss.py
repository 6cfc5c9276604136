"""Constructive heuristic for square-encoded trimloss models (tls*).

The reference reaches trimloss incumbents only through deep tree descent:
QGHandler fixes the integers of an integral LP solution and polishes with
an NLP solve (QGHandler.cpp:205 fixInts_, :627 solveNLP_) — but on the
tls* family every naive rounding violates the demand rows by orders of
magnitude, so incumbents appear only after thousands of nodes, if at all.

The tls* instances (trimloss members of scripts/convex_inst_list.csv)
share one documented structure — the Harjunkoski-Westerlund *convex*
reformulation of the cutting-stock problem:

  - each small integer q (pattern multiplicity m_j, or piece count
    n_ij of product i in pattern j) is one-hot encoded as
    q = sum_k k*b_k with sum_k b_k <= 1;
  - a "square link" equality  s = 1 + sum_k k(k+2)*b_k  makes
    s = (q+1)^2 exactly;
  - the bilinear demand  sum_j m_j*n_ij >= d_i  becomes the CONVEX row
      sum_j m_j + sum_j n_ij - sum_j sqrt(M_j*N_ij) <= -d_i - P
    via m*n = sqrt((m+1)^2 (n+1)^2) - m - n - 1  (M=(m+1)^2, N=(n+1)^2);
  - per-pattern linear rows bound the pattern contents (roll width
    window, knife count), and y_j binaries gate pattern use.

This module *detects* that structure from the IR (no instance names
involved) and solves the underlying cutting-stock problem EXACTLY by
pattern enumeration + a layered DP over patterns, then assembles and
verifies a full solution vector.  The construction is a domain-structure
heuristic in the same sense as the reference's structure handlers
(PerspCon detection, kPowHandler): detect a documented special form,
exploit it.

Soundness: the assembled point is only accepted after
``problem.is_feasible`` on the true model — detection errors can only
cost the heuristic, never correctness.
"""

from __future__ import annotations

import dataclasses
import itertools
from typing import Dict, List, Optional, Tuple

import numpy as np

from ..ir.problem import Problem
from ..ops.opcodes import Op

_INF = float("inf")


@dataclasses.dataclass
class _SqGroup:
    """One square-encoded small integer: value = sum_k (k+1_offset)."""
    square_var: int                  # s with s = (value+1)^2
    bvars: List[int]                 # binaries, position k-1 has weight k
    y_var: int = -1                  # gating binary (m-groups only)
    pattern: int = -1                # pattern id (content + m groups)
    product: int = -1                # demand row index (content groups)

    @property
    def cap(self) -> int:
        return len(self.bvars)


@dataclasses.dataclass
class TrimlossStructure:
    m_groups: List[_SqGroup]                  # one per pattern
    content: Dict[Tuple[int, int], _SqGroup]  # (product, pattern) -> group
    demands: List[float]                      # d_i per product
    n_products: int
    n_patterns: int
    local_rows: Dict[int, List[int]]          # pattern -> constraint idxs


def _sqlink_groups(p: Problem) -> List[_SqGroup]:
    """Find rows  s - sum_k k(k+2) b_k = 1  (the square-link encoding)."""
    out = []
    for c in p.cons:
        if c.fun.nlf is not None or c.fun.qf is not None or c.fun.lf is None:
            continue
        if not (np.isfinite(c.lb) and c.lb == c.ub and abs(c.lb - 1.0) < 1e-12):
            continue
        pos = [(j, v) for j, v in c.fun.lf.terms.items() if v > 0]
        neg = [(j, v) for j, v in c.fun.lf.terms.items() if v < 0]
        if len(pos) != 1 or not neg:
            continue
        s = pos[0][0]
        if abs(pos[0][1] - 1.0) > 1e-12 or \
                p.vars[s].vtype.name == "BINARY":
            continue
        neg.sort(key=lambda t: abs(t[1]))             # ascending |coef|
        bvars = []
        ok = True
        for k, (j, v) in enumerate(neg, start=1):
            if not p.vars[j].vtype.name == "BINARY" or \
                    abs(-v - k * (k + 2)) > 1e-9:
                ok = False
                break
            bvars.append(j)
        if ok and bvars:
            out.append(_SqGroup(square_var=s, bvars=bvars))
    return out


def _mult_sqrt_pairs(graph) -> List[Tuple[int, int]]:
    """(a, b) variable pairs appearing as sqrt(a*b) in the graph."""
    ops = list(graph._op)
    a1 = list(graph._arg1)
    a2 = list(graph._arg2)
    var = list(graph._var)
    pairs = []
    for i, o in enumerate(ops):
        if o != Op.SQRT:
            continue
        m = a1[i]
        if m < 0 or ops[m] != Op.MULT:
            continue
        l, r = a1[m], a2[m]
        if l >= 0 and r >= 0 and ops[l] == Op.VAR and ops[r] == Op.VAR:
            pairs.append((var[l], var[r]))
    return pairs


def detect_trimloss(p: Problem) -> Optional[TrimlossStructure]:
    groups = _sqlink_groups(p)
    if len(groups) < 2:
        return None
    by_square = {g.square_var: g for g in groups}

    # demand rows: NL rows whose graph is a sum of sqrt(M*N) products of
    # two square vars (negated), with a finite upper bound
    demand_rows = []
    for c in p.cons:
        if c.fun.nlf is None or not np.isfinite(c.ub):
            continue
        pairs = _mult_sqrt_pairs(c.fun.nlf)
        if not pairs:
            continue
        if not all(a in by_square and b in by_square for a, b in pairs):
            continue
        demand_rows.append((c, pairs))
    if not demand_rows:
        return None

    # m-groups appear in EVERY demand row (the sum_j m_j term); their
    # partner in each pair is that row's product-content group.  Identify
    # m squares as the squares appearing in >1 demand row's pairs (or
    # gated by a y link); fall back to "integer square var".
    count: Dict[int, int] = {}
    for _, pairs in demand_rows:
        for a, b in pairs:
            count[a] = count.get(a, 0) + 1
            count[b] = count.get(b, 0) + 1
    m_squares = {s for s, n in count.items() if n >= max(
        2, len(demand_rows))} if len(demand_rows) > 1 else {
        s for s in count if p.vars[s].is_integer()}
    if not m_squares:
        return None

    m_list = sorted(m_squares)
    pattern_of_m = {s: j for j, s in enumerate(m_list)}
    m_groups = [by_square[s] for s in m_list]
    P = len(m_groups)
    for j, g in enumerate(m_groups):
        g.pattern = j

    # y gating: rows  y - sum_k k*b_k <= 0  with y binary
    for c in p.cons:
        if c.fun.nlf is not None or c.fun.lf is None or c.fun.qf is not None:
            continue
        if np.isfinite(c.lb) or not np.isfinite(c.ub) or abs(c.ub) > 1e-12:
            continue
        pos = [(j, v) for j, v in c.fun.lf.terms.items() if v > 0]
        if len(pos) != 1 or abs(pos[0][1] - 1.0) > 1e-12:
            continue
        yv = pos[0][0]
        if p.vars[yv].vtype.name != "BINARY":
            continue
        negb = sorted([j for j, v in c.fun.lf.terms.items() if v < 0])
        for g in m_groups:
            if negb == sorted(g.bvars):
                g.y_var = yv

    # content groups + demands
    content: Dict[Tuple[int, int], _SqGroup] = {}
    demands = []
    for i, (c, pairs) in enumerate(demand_rows):
        d = -float(c.ub) - P
        if d <= 0:
            return None
        demands.append(d)
        for a, b in pairs:
            if a in m_squares and b not in m_squares:
                ms, ns = a, b
            elif b in m_squares and a not in m_squares:
                ms, ns = b, a
            else:
                return None
            g = by_square[ns]
            g.pattern = pattern_of_m[ms]
            g.product = i
            content[(i, g.pattern)] = g

    # pattern-local linear rows: support entirely inside one pattern's
    # content binaries (width window / knife count / one-hot rows) —
    # these validate an enumerated content assignment directly
    bin_of_pattern: Dict[int, set] = {}
    for (i, j), g in content.items():
        bin_of_pattern.setdefault(j, set()).update(g.bvars)
    local_rows: Dict[int, List[int]] = {j: [] for j in bin_of_pattern}
    for c in p.cons:
        if c.fun.nlf is not None or c.fun.qf is not None or c.fun.lf is None:
            continue
        sup = set(c.fun.lf.terms.keys())
        for j, bins in bin_of_pattern.items():
            if sup and sup <= bins:
                local_rows[j].append(c.index)
    return TrimlossStructure(m_groups=m_groups, content=content,
                             demands=demands, n_products=len(demand_rows),
                             n_patterns=P, local_rows=local_rows)


def _enumerate_contents(p: Problem, st: TrimlossStructure, j: int,
                        max_enum: int = 200_000) -> np.ndarray:
    """All content vectors (n_i)_i for pattern j feasible w.r.t. the
    pattern-local linear rows.  Returns (nc, n_products) int array."""
    gs = [st.content.get((i, j)) for i in range(st.n_products)]
    ranges = [range(0, (g.cap if g else 0) + 1) for g in gs]
    total = int(np.prod([len(r) for r in ranges]))
    if total > max_enum:
        return np.zeros((0, st.n_products), dtype=np.int64)
    rows = [p.cons[r] for r in st.local_rows.get(j, [])]
    out = []
    for combo in itertools.product(*ranges):
        # binary assignment for this pattern
        val = {}
        for g, n in zip(gs, combo):
            if g is None:
                continue
            for k, b in enumerate(g.bvars, start=1):
                val[b] = 1.0 if k == n else 0.0
        ok = True
        for c in rows:
            a = sum(v * val.get(jj, 0.0) for jj, v in c.fun.lf.terms.items())
            if a > c.ub + 1e-9 or a < c.lb - 1e-9:
                ok = False
                break
        if ok:
            out.append(combo)
    return np.asarray(out, dtype=np.int64).reshape(-1, st.n_products)


def _pareto_max(C: np.ndarray) -> np.ndarray:
    """Componentwise-maximal rows (more pieces never hurts coverage)."""
    keep = []
    for i in range(len(C)):
        dominated = False
        for k in range(len(C)):
            if k != i and np.all(C[k] >= C[i]) and np.any(C[k] > C[i]):
                dominated = True
                break
        if not dominated:
            keep.append(i)
    return C[keep]


def construct_trimloss(p: Problem, st: Optional[TrimlossStructure] = None,
                       ) -> Optional[Tuple[np.ndarray, float]]:
    """Exact cutting-stock solve over the detected structure.

    Layered DP over patterns: state = remaining demand vector (clipped at
    0), transition = (multiplicity m_j, Pareto-maximal content c_j), cost
    = m_j*unit_cost_j + use_cost_j.  Returns (x, obj) verified feasible
    on the true model, or None."""
    if st is None:
        st = detect_trimloss(p)
    if st is None:
        return None
    obj = p.obj.fun.lf.terms if (p.obj and p.obj.fun.lf) else {}

    contents = []
    feas_any = []
    for j in range(st.n_patterns):
        C = _enumerate_contents(p, st, j)
        if len(C) == 0:
            return None
        feas_any.append(C[np.argmin(C.sum(axis=1))])  # for unused patterns
        contents.append(_pareto_max(C))

    d0 = tuple(int(np.ceil(d - 1e-9)) for d in st.demands)
    # unit cost of one roll of pattern j = objective weight of m_j's
    # first binary (weights scale linearly with k); pattern-use cost =
    # objective weight of y_j
    unit = [float(obj.get(g.bvars[0], 0.0)) for g in st.m_groups]
    ycost = [float(obj.get(g.y_var, 0.0)) if g.y_var >= 0 else 0.0
             for g in st.m_groups]

    # layered DP with per-layer dicts for exact backtracking
    zero = tuple([0] * st.n_products)
    layers: List[Dict[tuple, Tuple[float, Optional[tuple]]]] = [
        {d0: (0.0, None)}]
    for j in range(st.n_patterns):
        C = contents[j]
        Mj = st.m_groups[j].cap
        ndp = {}
        for s_, (cost, _) in layers[-1].items():
            r = np.asarray(s_)
            prev = ndp.get(s_)
            if prev is None or cost < prev[0]:
                ndp[s_] = (cost, (s_, 0, -1))
            for m in range(1, Mj + 1):
                newr = np.maximum(r[None, :] - m * C, 0)
                costs = cost + m * unit[j] + ycost[j]
                for ci in range(len(C)):
                    key = tuple(int(v) for v in newr[ci])
                    prev = ndp.get(key)
                    if prev is None or costs < prev[0]:
                        ndp[key] = (costs, (s_, m, ci))
        layers.append(ndp)
    if zero not in layers[-1]:
        return None
    state = zero
    plan = {}
    for j in reversed(range(st.n_patterns)):
        cost, back = layers[j + 1][state]
        prev_state, m, ci = back
        plan[j] = (m, ci)
        state = prev_state

    # assemble the full solution vector
    x = np.zeros(len(p.vars))
    for v in p.vars:
        lo = v.lb if np.isfinite(v.lb) else 0.0
        x[v.index] = lo
    for j in range(st.n_patterns):
        m, ci = plan[j]
        g = st.m_groups[j]
        for k, b in enumerate(g.bvars, start=1):
            x[b] = 1.0 if k == m else 0.0
        x[g.square_var] = float((m + 1) ** 2)
        if g.y_var >= 0:
            x[g.y_var] = 1.0 if m >= 1 else 0.0
        cvec = contents[j][ci] if ci >= 0 else feas_any[j]
        for i in range(st.n_products):
            cg = st.content.get((i, j))
            if cg is None:
                continue
            n = int(cvec[i])
            for k, b in enumerate(cg.bvars, start=1):
                x[b] = 1.0 if k == n else 0.0
            x[cg.square_var] = float((n + 1) ** 2)
    if not p.is_feasible(x, atol=1e-6, int_tol=1e-6):
        return None
    return x, float(p.eval_objective(x))


def trimloss_valid_rows(p: Problem,
                        st: Optional[TrimlossStructure] = None,
                        ) -> List[Tuple[np.ndarray, float, float]]:
    """Valid linear rows implied by the BILINEAR demand semantics of the
    detected structure — the rows the convex sqrt reformulation loses
    (its continuous relaxation is notoriously loose: tls4's root LP sits
    at 1.71 vs optimum 8.3).

    Derivation (valid for every integer-feasible point, which is all a
    cut needs):  d_i <= sum_j m_j n_ij  with  n_ij <= K_ij  and
    sum_i n_ij <= K_j, where K_ij / K_j are the exact per-roll content
    caps obtained by enumerating pattern j's local rows
    (_enumerate_contents — the true model's own constraints).  Hence
      (i)  per product:   sum_j K_ij m_j >= d_i
      (ii) per product CG: sum_{j: K_ij>0} m_j >= ceil(d_i / max_j K_ij)
      (iii) aggregate:     sum_j K_j m_j >= sum_i d_i
      (iv) aggregate CG:   sum_j m_j >= ceil(sum_i d_i / max_j K_j)
    with m_j = sum_k k b_jk (the one-hot encoding).  (ii)/(iv) are
    Chvatal rounding steps on integer m.  Reference analogue: the
    knapsack-cover/LGCI machinery (CoverCutGenerator.cpp) — these are
    the same class of implied knapsack rows, specialized to the
    trimloss structure."""
    if st is None:
        st = detect_trimloss(p)
    if st is None:
        return []
    n = p.n_vars
    P, I = st.n_patterns, st.n_products
    Kij = np.zeros((I, P))
    Kj = np.zeros(P)
    for j in range(P):
        C = _enumerate_contents(p, st, j)
        if len(C) == 0:
            return []          # enumeration overflow: no cuts, no harm
        Kij[:, j] = C.max(axis=0)
        Kj[j] = C.sum(axis=1).max()
    if Kj.max() <= 0:
        return []

    def m_coefs(weights) -> np.ndarray:
        c = np.zeros(n)
        for j, g in enumerate(st.m_groups):
            for k, b in enumerate(g.bvars, start=1):
                c[b] += float(weights[j]) * k
        return c

    rows: List[Tuple[np.ndarray, float, float]] = []
    dsum = float(sum(st.demands))
    # (v) pattern-cover cuts on the y gates: a subset S of patterns
    # cannot cover demand even in the RELAXATION m_j = cap_j with
    # per-product per-roll caps K_ij (each cap independently achieved —
    # a superset of the true feasible covers, so its infeasibility is
    # certified), hence some pattern OUTSIDE S must be used:
    # sum_{j not in S} y_j >= 1.  Also the aggregate Chvatal form
    # sum_j y_j >= k* (k* = min size of a sufficient subset).  These
    # close the y-cost part of the lb that the m-rows cannot see.
    have_y = all(g.y_var >= 0 for g in st.m_groups)
    if have_y and P <= 12:
        caps = np.array([g.cap for g in st.m_groups], dtype=float)
        full = caps[None, :] * Kij                    # (I, P) max pieces
        kstar = P + 1
        for size in range(1, P):
            any_sufficient = False
            for S in itertools.combinations(range(P), size):
                cover_ok = all(full[i, list(S)].sum() >=
                               st.demands[i] - 1e-9 for i in range(I))
                if cover_ok:
                    any_sufficient = True
                else:
                    c = np.zeros(n)
                    for j in range(P):
                        if j not in S:
                            c[st.m_groups[j].y_var] = 1.0
                    rows.append((c, 1.0, _INF))
            if any_sufficient and kstar > P:
                kstar = size
        if kstar <= P:
            c = np.zeros(n)
            for g in st.m_groups:
                c[g.y_var] = 1.0
            rows.append((c, float(kstar), _INF))
    # (iii) aggregate capacity row
    rows.append((m_coefs(Kj), dsum, _INF))
    # (iv) aggregate Chvatal rounding
    rows.append((m_coefs(np.ones(P)),
                 float(np.ceil(dsum / Kj.max() - 1e-9)), _INF))
    for i in range(I):
        if Kij[i].max() <= 0:
            continue
        # (i) per-product capacity row
        rows.append((m_coefs(Kij[i]), float(st.demands[i]), _INF))
        # (ii) per-product Chvatal rounding over supporting patterns
        sup = (Kij[i] > 0).astype(float)
        rows.append((m_coefs(sup),
                     float(np.ceil(st.demands[i] / Kij[i].max() - 1e-9)),
                     _INF))
    return rows
