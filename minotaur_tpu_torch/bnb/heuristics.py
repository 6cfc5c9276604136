"""Primal heuristics.

Port of minotaur_tpu/bnb/heuristics.py.  FeasibilityPump — reference:
FeasibilityPump/LinFeasPump (src/base/LinFeasPump.cpp): alternate between
rounding and solving a distance-LP until an integral LP point appears.
A whole *population* of trajectories is pumped as one lane-batched IPM
call with per-lane objectives (the JAX package vmaps a one-lane solver;
the port's `build_single_solver(...).with_objective` takes the lane axis
itself), so the per-iteration cost is one device call regardless of
population size (the reference pumps one trajectory).

The host-only helpers (partition rounding, swap search, sampling, the
dive scheme library) are the JAX package's code as it is; the engine-
driven ones (pump, fix-vars) run on the device named by the caller.
"""

from __future__ import annotations

from typing import List, Optional

import numpy as np

from ..engines.ipm import IPMOptions, build_single_solver, to_device
from ..engines.staging import StagedProblem


class FeasibilityPump:
    def __init__(self, master: StagedProblem, ipm: IPMOptions,
                 population: int = 16, max_rounds: int = 25,
                 seed: int = 0, device="cuda"):
        self._solver = build_single_solver(master, ipm, device)
        self.master = master
        self.population = population
        self.max_rounds = max_rounds
        self.int_idx = np.where(master.int_mask)[0]
        self.rng = np.random.default_rng(seed)

    def _solve(self, A, clb, cub, vlb_b, vub_b, x, c):
        """One distance-LP round on all lanes: (x, status) as numpy."""
        dev = self._solver.device
        t = lambda a: to_device(a, dev)  # noqa: E731
        m, n = len(clb), self.master.n
        res = self._solver.with_objective(t(A).reshape(m, n), t(clb), t(cub),
                                          t(vlb_b), t(vub_b), t(x), t(c))
        return res.x.cpu().numpy(), res.status.cpu().numpy()

    def _distance_obj(self, x_round: np.ndarray) -> np.ndarray:
        """Linear objective whose minimization approximates
        sum_j |x_j - x_round_j| over integer coords: move-down costs +1
        when rounded to the lower integer, move-up costs -1 otherwise."""
        B = x_round.shape[0]
        c = np.zeros((B, self.master.n))
        ints = self.int_idx
        vlb = self.master.vlb[ints]
        vub = self.master.vub[ints]
        at_lo = x_round[:, ints] <= np.maximum(vlb, -1e18) + 0.5
        at_hi = x_round[:, ints] >= np.minimum(vub, 1e18) - 0.5
        c[:, ints] = np.where(at_lo, 1.0, np.where(at_hi, -1.0, 0.0))
        return c

    def run(self, A, clb, cub, vlb: np.ndarray, vub: np.ndarray,
            x_start: np.ndarray, int_tol: float = 1e-6
            ) -> List[np.ndarray]:
        """Pump from x_start (an LP-feasible point); returns integral
        LP-feasible points found (master space)."""
        B = self.population
        n = self.master.n
        ints = self.int_idx
        if len(ints) == 0:
            return []
        vlb_b = np.tile(vlb, (B, 1))
        vub_b = np.tile(vub, (B, 1))
        x = np.tile(x_start, (B, 1))
        # diversify initial roundings: lane 0 = nearest; others flip a
        # random subset of near-half coordinates
        xr = x.copy()
        xr[:, ints] = np.round(x[:, ints])
        for b in range(1, B):
            frac = np.abs(x[b, ints] - np.round(x[b, ints]))
            k = max(1, int(len(ints) * 0.15))
            cand = np.argsort(-frac)[:max(k * 2, 4)]
            flip = self.rng.choice(cand, size=min(k, len(cand)),
                                   replace=False)
            xr[b, ints[flip]] = np.where(
                x[b, ints[flip]] > np.round(x[b, ints[flip]]),
                np.round(x[b, ints[flip]]) + 1.0,
                np.round(x[b, ints[flip]]) - 1.0)
        xr[:, ints] = np.clip(xr[:, ints], vlb_b[:, ints], vub_b[:, ints])

        found: List[np.ndarray] = []
        prev = xr.copy()
        for _ in range(self.max_rounds):
            c = self._distance_obj(xr)
            x, status = self._solve(A, clb, cub, vlb_b, vub_b, x, c)
            frac = np.abs(x[:, ints] - np.round(x[:, ints]))
            integral = (frac.max(axis=1) <= int_tol) & (status == 1)
            for b in np.where(integral)[0]:
                found.append(x[b].copy())
            if found:
                break
            # next rounding; perturb stalled lanes
            new_xr = x.copy()
            new_xr[:, ints] = np.round(x[:, ints])
            for b in range(B):
                if np.all(new_xr[b, ints] == prev[b, ints]):
                    k = max(1, int(len(ints) * 0.1))
                    order = np.argsort(-frac[b])[:max(2 * k, 4)]
                    flip = self.rng.choice(order, size=min(k, len(order)),
                                           replace=False)
                    new_xr[b, ints[flip]] = 1.0 - new_xr[b, ints[flip]] \
                        if np.all(self.master.vub[ints] <= 1.0) else \
                        new_xr[b, ints[flip]] + self.rng.choice([-1.0, 1.0],
                                                                size=len(flip))
            new_xr[:, ints] = np.clip(new_xr[:, ints], vlb_b[:, ints],
                                      vub_b[:, ints])
            prev = xr
            xr = new_xr
        return found


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


class SamplingHeur:
    """Random-sampling primal heuristic (reference: SamplingHeur.{h,cpp}):
    sample points in the box, round integers, keep feasible improvers.
    Host evaluation only — no solves — so it runs in microseconds per
    candidate; the TPU version simply evaluates many more candidates."""

    def __init__(self, problem, sp, seed: int = 0, n_samples: int = 256):
        self.problem = problem
        self.sp = sp
        self.rng = np.random.default_rng(seed)
        self.n_samples = n_samples

    def run(self, vlb: np.ndarray, vub: np.ndarray,
            around=None, int_tol: float = 1e-6):
        """Returns [(x, val)] feasible candidates, best first."""
        lo = np.where(np.isfinite(vlb), vlb, -100.0)
        hi = np.where(np.isfinite(vub), np.maximum(vub, lo), 100.0)
        pts = self.rng.uniform(size=(self.n_samples, self.sp.n)) * \
            (hi - lo) + lo
        if around is not None and np.all(np.isfinite(around)):
            k = self.n_samples // 2
            pts[:k] = 0.75 * around[None, :] + 0.25 * pts[:k]
        ints = self.sp.int_mask
        pts[:, ints] = np.round(pts[:, ints])
        pts = np.clip(pts, vlb[None, :], vub[None, :])
        out = []
        for x in pts:
            if self.problem.is_feasible(x, atol=1e-6, int_tol=int_tol):
                out.append((x.copy(),
                            float(self.problem.eval_objective(x))))
        out.sort(key=lambda t: t[1])
        return out[:10]


class FixVarsHeur:
    """Fix-and-solve primal heuristic (reference: FixVarsHeur.{h,cpp}):
    fix the integer variables at a rounding of a reference point and
    solve the remaining continuous problem.  All K candidate fixings
    solve as ONE vmapped batch (the reference solves them one at a time).
    """

    def __init__(self, problem, sp, ipm=None, seed: int = 0,
                 device="cuda"):
        from ..engines.ipm import build_batch_solver
        self.problem = problem
        self.sp = sp
        self.rng = np.random.default_rng(seed)
        self._solve = build_batch_solver(sp, ipm or IPMOptions(), device)

    def run(self, vlb: np.ndarray, vub: np.ndarray, x_ref: np.ndarray,
            n_tries: int = 8, int_tol: float = 1e-6):
        """Returns [(x, val)] feasible candidates, best first."""
        from ..utils.types import EngineStatus
        ints = self.sp.int_mask
        if not ints.any() or x_ref is None or \
                not np.all(np.isfinite(x_ref)):
            return []
        B = max(1, n_tries)
        vlb2 = np.tile(vlb, (B, 1))
        vub2 = np.tile(vub, (B, 1))
        x0 = np.tile(x_ref, (B, 1))
        base = np.round(x_ref[ints])
        for b in range(B):
            fix = base.copy()
            if b:  # perturb a random subset of the fixing
                flip = self.rng.uniform(size=fix.shape) < 0.25
                direction = np.where(self.rng.uniform(size=fix.shape) < 0.5,
                                     -1.0, 1.0)
                fix = np.where(flip, fix + direction, fix)
            fix = np.clip(fix, vlb[ints], vub[ints])
            vlb2[b, ints] = fix
            vub2[b, ints] = fix
        res = self._solve(self.sp.A, self.sp.clb, self.sp.cub,
                          vlb2, vub2, x0)
        xs = np.asarray(res.x)
        sts = np.asarray(res.status)
        out = []
        for b in range(B):
            if sts[b] in (EngineStatus.SOLVED_OPTIMAL,
                          EngineStatus.ITERATION_LIMIT) and \
                    np.all(np.isfinite(xs[b])) and \
                    self.problem.is_feasible(xs[b], atol=1e-5,
                                             int_tol=int_tol):
                out.append((xs[b].copy(),
                            float(self.problem.eval_objective(xs[b]))))
        out.sort(key=lambda t: t[1])
        return out


# --------------------------------------------------------------------------
# MINLP diving scheme library (reference: MINLPDiving.h:47-53 Scoretype —
# Fractional / VectorLength / LexBound / ReducedCost — and the Direction
# enum Floor/Ceil/Nearest/Farthest at MINLPDiving.h:33-40).  The reference
# runs the 4x8 scheme/direction combinations SEQUENTIALLY per dive call
# (implementDive_ loop); here each vmapped dive LANE gets its own
# (scheme, direction) pair, so one batched dive covers the whole family.

DIVE_SCHEMES = ("frac", "veclen", "lex", "rcost")


def dive_scheme_for_lane(option_value: str, lane: int) -> str:
    """Lane -> scoring scheme.  A concrete option value pins every lane;
    "auto" deals the four reference schemes round-robin across lanes."""
    if option_value == "auto":
        return DIVE_SCHEMES[lane % len(DIVE_SCHEMES)]
    return option_value


def dive_scores(scheme: str, x: np.ndarray, ints: np.ndarray,
                frac: np.ndarray, grad_obj: np.ndarray,
                ncols: np.ndarray, avg_rc: np.ndarray) -> np.ndarray:
    """Selection score over the integer variables (LOWER = fixed first).

    - frac:   least-fractional first (MINLPDiving getScore_ Fractional)
    - lex:    lowest index first (LexBound)
    - veclen: grad_obj * frac / max(1, column nnz) — the variable whose
      rounding moves the objective least per constraint touched
      (MINLPDiving.cpp:262-283 vl_score)
    - rcost:  running-average reduced cost (MINLPDiving.cpp:286-292,
      avgDual_); most-negative average rc is fixed first, mirroring the
      reference's Least ordering over the copied dual vector
    """
    if scheme == "lex":
        return np.arange(len(ints), dtype=float)
    if scheme == "veclen":
        return grad_obj[ints] * frac / np.maximum(1.0, ncols[ints])
    if scheme == "rcost":
        return avg_rc[ints]
    return frac


def dive_round(direction: str, xv: np.ndarray, int_tol: float = 1e-6
               ) -> np.ndarray:
    """Round the picked values in a scheme direction (reference
    MINLPDiving Direction enum: Floor/Ceil/Nearest/Farthest)."""
    if direction == "ceil":
        return np.ceil(xv - int_tol)
    if direction == "floor":
        return np.floor(xv + int_tol)
    if direction == "farthest":
        lo = np.floor(xv)
        return np.where(xv - lo >= 0.5, lo, lo + 1.0)
    return np.round(xv)


class DiveBacktrack:
    """Per-lane bound-flip backtracking, depth 2 (reference
    MINLPDiving::backtrack_ MINLPDiving.cpp:99-137: undo the last fix,
    push the variable one unit the OTHER way; the dive loop at :369
    allows a second backtrack one level further up before giving up).

    push() records (pre-fix box, picked vars, fixed values) after each
    fixing round; on_death() restores the most recent un-flipped level's
    box and flips its picks — if the most recent level was already
    flipped, it is discarded and the flip happens one level up."""

    def __init__(self, depth: int = 2):
        self.depth = depth
        self.stack = []                  # entries [lo, hi, pick, v, flipped]

    def push(self, lo: np.ndarray, hi: np.ndarray, pick: np.ndarray,
             v: np.ndarray) -> None:
        self.stack.append([lo.copy(), hi.copy(), pick, v, False])
        if len(self.stack) > self.depth:
            self.stack.pop(0)

    def on_death(self, x_lane: np.ndarray):
        """Returns (new_lo, new_hi) for the flipped sibling, or None if
        the flip budget is exhausted (lane dies)."""
        while self.stack:
            lo, hi, pick, v, flipped = self.stack.pop()
            if flipped:
                continue                 # both children dead: go one up
            lpv = x_lane[pick]
            alt = np.where(v <= lpv, v + 1.0, v - 1.0)
            alt = np.clip(alt, lo[pick], hi[pick])
            nlo, nhi = lo.copy(), hi.copy()
            nlo[pick] = alt
            nhi[pick] = alt
            self.stack.append([lo, hi, pick, alt, True])
            return nlo, nhi
        return None
