"""The IPM's constraint operator in its three formats, behind one set of
methods (`engines/ipm.py` asks nothing else of it):

- `SharedDense`: a dense (m, n) tensor, the same rows in every lane (the
  host tree, the device pool, QG, root OBBT, the glob polish);
- `LaneDense`: a dense (B, m, n) tensor, one matrix a lane (tests hold
  the per-lane IPM to the JAX package's `vmap` through it, and the
  structured form to it);
- `LaneRows`: the global path's operator (`glob/glob_step.py`): the
  model's base rows, dense and shared, then the envelope rows of each
  lane's box, whose nonzeros sit at (row, col) places fixed when the step
  is built and whose values are the lane's.  `RowPattern` holds the
  places and the index maps of every product; `LaneRows` holds one
  batch's values (B, nnz) in one dtype, so a lane of the 100-item QKP
  carries 14,868 values, not a (4957, 1339) matrix.

`as_operator` turns what a caller passes (a tensor or a `LaneRows`) into
its operator; it is the one place that looks at the operand's type.
Each kind answers the same questions: `mv` (A x) and `tv` (A' y) per
lane, `gram` (A' diag(w) A), `row_gram` (A diag(h) A'), `rows(idx)` (a
dense operator of the selected rows), `split()` (the f64-class
products: the hi/lo float32 split of a dense operator, or a `LaneRows`
itself, which multiplies in float64), `to(dtype)` (one copy a dtype,
kept) and `abs()`; and for the solve's route, `replayable` (a solve may
replay a tape of CUDA graphs: the shared kind only) and `counts` (the
count a solve's iterations add: `structured` on a `LaneRows`).  The
dense kinds also give the per-lane expansion (`expand`) that the NL
Jacobian starts from.  Each dense method is the torch call the IPM made
on that kind of tensor, so the bits are the same.

Every sum of a `LaneRows` runs in an order fixed by the pattern
(`_SegSum`): the terms of an output are gathered into a padded block and
summed along it, never scattered with atomics, so a repeated call gives
the same bits.  The weighted Gram A' diag(w) A is the base rows' dense
rank-m_base product plus, for every pair of entries within an envelope
row, w_r v_a v_b at (a, b); its pairs are listed once, when the pattern
is built.
"""

from __future__ import annotations

import functools
from typing import List, Optional

import numpy as np
import torch
import torch.nn.functional as F

from ..device import F32, F64

# a padded block costs its slots plus about this many slots a lane for
# the launches that one more block takes (`_buckets`)
_BLOCK_SLOTS = 4096


def _buckets(counts: np.ndarray) -> List[np.ndarray]:
    """Groups of the outputs (positions into `counts`, each > 0) whose
    terms are padded to one width: contiguous runs of the outputs sorted
    by count, cut only between powers of two, so as to minimise the
    slots (outputs x widest count) plus `_BLOCK_SLOTS` a group."""
    order = np.argsort(counts, kind="stable")
    c = counts[order]
    cls = np.ceil(np.log2(c)).astype(np.int64)
    cuts = np.concatenate([[0], np.nonzero(np.diff(cls))[0] + 1, [len(c)]])
    # best[j]: cost of the outputs before cut j, split optimally
    best = [0.0] + [np.inf] * (len(cuts) - 1)
    prev = [0] * len(cuts)
    for j in range(1, len(cuts)):
        for i in range(j):
            cost = best[i] + (cuts[j] - cuts[i]) * c[cuts[j] - 1] + \
                _BLOCK_SLOTS
            if cost < best[j]:
                best[j], prev[j] = cost, i
    groups, j = [], len(cuts) - 1
    while j > 0:
        i = prev[j]
        groups.append(order[cuts[i]:cuts[j]])
        j = i
    return groups[::-1]


class _SegSum:
    """out[:, t] = sum of coef[:, e] * u[:, at[e]] over the terms e with
    key[e] == t, each output's terms in index order.

    The outputs are grouped by term count (`_buckets`); a group's terms
    are padded to its widest count with a zero coefficient at u's column
    0.  `coef_blocks` lays a batch's coefficients out once; each call
    gathers u into the same blocks and sums along them."""

    def __init__(self, key, at, n_out: int, dev):
        key = np.asarray(key, dtype=np.int64)
        at = np.asarray(at, dtype=np.int64)
        self.n_terms, self.n_out = len(key), n_out
        order = np.argsort(key, kind="stable")
        counts = np.bincount(key, minlength=n_out)
        start = np.concatenate([[0], np.cumsum(counts)[:-1]])
        outs = np.nonzero(counts)[0]
        self.terms, self.at = [], []
        placed = []
        for g in (_buckets(counts[outs]) if len(outs) else []):
            ts = outs[g]
            j = np.arange(counts[ts].max())[None, :]
            real = j < counts[ts][:, None]
            pos = np.minimum(start[ts][:, None] + j, len(key) - 1)
            terms = np.where(real, order[pos], self.n_terms)
            self.terms.append(torch.as_tensor(terms, device=dev))
            self.at.append(torch.as_tensor(
                np.where(real, at[np.minimum(terms, len(key) - 1)], 0),
                device=dev))
            placed.append(ts)
        placed = np.concatenate(placed) if placed else np.zeros(0, np.int64)
        # the outputs in the order of the joined group sums; outputs with
        # no term read one zero column past them
        self.empty = len(placed) < n_out
        src = np.full(n_out, len(placed), dtype=np.int64)
        src[placed] = np.arange(len(placed))
        self.perm = None if np.array_equal(src, np.arange(n_out)) else \
            torch.as_tensor(src, device=dev)

    def coef_blocks(self, coef: torch.Tensor) -> list:
        """The (B, k, width) blocks of a batch's term coefficients."""
        padded = F.pad(coef, (0, 1))
        return [padded[:, t] for t in self.terms]

    def __call__(self, blocks: list, u: torch.Tensor) -> torch.Tensor:
        B = u.shape[0]
        if not self.n_out:
            return u.new_zeros((B, 0))
        sums = [(c * u[:, a]).sum(dim=-1) for c, a in zip(blocks, self.at)]
        if self.empty:
            sums.append(u.new_zeros((B, 1)))
        out = sums[0] if len(sums) == 1 else torch.cat(sums, dim=1)
        return out if self.perm is None else out[:, self.perm]


def _pairs(group: np.ndarray, other: np.ndarray):
    """Every pair (a, b), a <= b, of entries that share a group, where the
    entries are sorted by (group, other): the pairs in group order."""
    E = len(group)
    if E == 0:
        z = np.zeros(0, np.int64)
        return z, z
    counts = np.bincount(group)
    start = np.concatenate([[0], np.cumsum(counts)[:-1]])
    end = (start + counts)[group]
    ea, eb = [], []
    e = np.arange(E)
    for d in range(int(counts.max())):
        ok = e + d < end
        ea.append(e[ok])
        eb.append(e[ok] + d)
    ea, eb = np.concatenate(ea), np.concatenate(eb)
    o = np.lexsort((eb, ea, group[ea]))
    return ea[o], eb[o]


class _Gram:
    """Sum over groups g of w[g] v_a v_b at (key_a, key_b), for every pair
    of entries (a, b) in one group, into a dense (B, size, size) output:
    the pairs' places, the places' sums (`_SegSum` over the pairs, in
    group order) and the mirrored places off the diagonal."""

    def __init__(self, group, key, size: int, dev):
        ea, eb = _pairs(group, key)
        self.ea = torch.as_tensor(ea, device=dev)
        self.eb = torch.as_tensor(eb, device=dev)
        place = key[ea] * size + key[eb]
        places, slot = np.unique(place, return_inverse=True)
        self.sums = _SegSum(slot, group[ea], len(places), dev)
        a, b = places // size, places % size
        off = np.nonzero(a != b)[0]
        self.places = torch.as_tensor(
            np.concatenate([places, b[off] * size + a[off]]), device=dev)
        self.slots = torch.as_tensor(
            np.concatenate([np.arange(len(places)), off]), device=dev)
        self.size = size

    def coef_blocks(self, v: torch.Tensor) -> list:
        return self.sums.coef_blocks(v[:, self.ea] * v[:, self.eb])

    def __call__(self, blocks: list, w: torch.Tensor,
                 out: Optional[torch.Tensor] = None) -> torch.Tensor:
        """Adds the pairs' sums into `out` (B, size, size), or into
        zeros."""
        s = self.sums(blocks, w)[:, self.slots]
        B, k = w.shape[0], self.size
        if out is None:
            out = w.new_zeros((B, k, k))
            out.view(B, k * k).index_copy_(1, self.places, s)
        else:
            flat = out.view(B, k * k)
            flat.index_copy_(1, self.places, flat[:, self.places] + s)
        return out


class RowPattern:
    """The static part of a `LaneRows`: `base` (m_base, n) float64, shared
    by every lane, then `m_extra` rows whose nonzeros sit at (rows, cols)
    (row within the block).  A (row, col) place given more than once is
    one slot, its values summed in the order given (`merge`); the slots
    are sorted by (row, col)."""

    def __init__(self, base: torch.Tensor, rows, cols, m_extra: int):
        dev = base.device
        self.base = base
        self.m_base, self.n = base.shape
        self.m_extra = m_extra
        self.m = self.m_base + m_extra
        rows = np.asarray(rows, dtype=np.int64)
        cols = np.asarray(cols, dtype=np.int64)
        places, slot = np.unique(rows * self.n + cols, return_inverse=True)
        self.nnz = len(places)
        self.rows, self.cols = places // self.n, places % self.n
        # merge[s, j]: the j-th given value of slot s (one past the given
        # values in the padding)
        counts = np.bincount(slot, minlength=self.nnz)
        order = np.argsort(slot, kind="stable")
        start = np.concatenate([[0], np.cumsum(counts)[:-1]])
        j = np.arange(counts.max() if self.nnz else 1)[None, :]
        pos = np.minimum(start[:, None] + j, max(len(slot) - 1, 0))
        merge = np.where(j < counts[:, None], order[pos] if len(slot)
                         else 0, len(slot))
        self._merge = torch.as_tensor(merge, device=dev)
        self.rows_t = torch.as_tensor(self.rows, device=dev)
        self.cols_t = torch.as_tensor(self.cols, device=dev)
        self.mv_sums = _SegSum(self.rows, self.cols, m_extra, dev)
        self.tv_sums = _SegSum(self.cols, self.rows, self.n, dev)
        self._gram = self._row_gram = None

    def merge(self, given: torch.Tensor) -> torch.Tensor:
        """(B, nnz) slot values from the (B, len(rows)) given values:
        each slot's values added one at a time, from 0."""
        g = F.pad(given, (0, 1))[:, self._merge]
        out = g[:, :, 0] + 0.0
        for j in range(1, g.shape[2]):
            out = out + g[:, :, j]
        return out

    def gram_sums(self) -> _Gram:
        """Pairs within each block row, at (col, col) places."""
        if self._gram is None:
            self._gram = _Gram(self.rows, self.cols, self.n,
                               self.base.device)
        return self._gram

    def row_gram_sums(self):
        """Pairs within each column over every row, base rows' nonzeros
        included, at (row, row) places; and the base nonzeros' places."""
        if self._row_gram is None:
            base = self.base.cpu().numpy()
            br, bc = np.nonzero(base)
            rows = np.concatenate([br, self.m_base + self.rows])
            cols = np.concatenate([bc, self.cols])
            o = np.lexsort((rows, cols))
            dev = self.base.device
            self._row_gram = (_Gram(cols[o], rows[o], self.m, dev),
                              torch.as_tensor(br, device=dev),
                              torch.as_tensor(bc, device=dev),
                              torch.as_tensor(o, device=dev))
        return self._row_gram


def as_operator(A) -> "_Operator":
    """The operator of a solve's operand: an operator as it is, a dense
    (m, n) tensor shared by every lane, or a dense (B, m, n) one."""
    if isinstance(A, _Operator):
        return A
    return SharedDense(A) if A.dim() == 2 else LaneDense(A)


class _Operator:
    """What every kind shares: the copies in other dtypes, made once, and
    the answers about the solve's route."""
    __slots__ = ()
    replayable = False      # a solve on it may replay a tape
    counts = ()             # the counts each iteration of its solve adds

    def to(self, dtype: torch.dtype) -> "_Operator":
        """Itself in its own dtype; else its copy in `dtype`, made at the
        first call and kept, so that later calls launch nothing."""
        if dtype != self.dtype and dtype not in self._copies:
            self._copies[dtype] = self._map(lambda t: t.to(dtype))
        return self._copies.get(dtype, self)

    def abs(self) -> "_Operator":
        return self._map(torch.abs)


class _Split:
    """f64-class products of a float64 dense operator through its hi/lo
    float32 split (hi + lo == A exactly; see the JAX spmv)."""

    def __init__(self, A: "LaneDense"):
        hi = A.data.to(F32)
        self.hi, self.lo = type(A)(hi), type(A)((A.data - hi.to(F64)).to(F32))

    def _prod(self, name: str, v64: torch.Tensor) -> torch.Tensor:
        hi, lo = getattr(self.hi, name), getattr(self.lo, name)
        vh = v64.to(F32)
        vl = (v64 - vh.to(F64)).to(F32)
        main = hi(vh)
        corr = hi(vl) + lo(vh)
        return main.to(F64) + corr.to(F64)

    mv = functools.partialmethod(_prod, "mv")
    tv = functools.partialmethod(_prod, "tv")


class LaneDense(_Operator):
    """A dense (B, m, n) operator, one matrix a lane (`data`)."""

    def __init__(self, data: torch.Tensor):
        self.data, self.dtype, self._copies = data, data.dtype, {}

    def _map(self, fn) -> "LaneDense":
        return type(self)(fn(self.data))

    def split(self) -> _Split:
        return _Split(self)

    def mv(self, x: torch.Tensor) -> torch.Tensor:
        return torch.matmul(self.data, x.unsqueeze(-1)).squeeze(-1)

    def tv(self, y: torch.Tensor) -> torch.Tensor:
        return torch.matmul(y.unsqueeze(-2), self.data).squeeze(-2)

    def gram(self, w: torch.Tensor) -> torch.Tensor:
        return torch.matmul(self.data.mT * w[:, None, :], self.data)

    def row_gram(self, h: torch.Tensor) -> torch.Tensor:
        return torch.matmul(self.data * h[:, None, :], self.data.mT)

    def rows(self, idx: torch.Tensor) -> "LaneDense":
        return type(self)(self.data.index_select(-2, idx))

    def expand(self, B: int) -> torch.Tensor:
        """The (B, m, n) tensor of every lane (a view)."""
        return self.data.expand(B, *self.data.shape[-2:])

    def jac_tv(self, y: torch.Tensor, jac) -> torch.Tensor:
        """y' J per lane, J = jac(self) the (B, m, n) Jacobian of the rows
        (the dual warm start's product)."""
        return (y[:, None, :] @ jac(self))[:, 0]


class SharedDense(LaneDense):
    """A dense (m, n) operator, the same in every lane (`data`): the
    per-lane kind's methods, with the products of one matrix."""
    replayable = True

    def mv(self, x: torch.Tensor) -> torch.Tensor:
        return x @ self.data.T

    def tv(self, y: torch.Tensor) -> torch.Tensor:
        return y @ self.data


class LaneRows(_Operator):
    """A batch's constraint operator on a `RowPattern`: the shared base
    rows (in this operator's dtype) and `vals` (B, nnz), lane b's value
    of each slot.  The products that the IPM takes of a dense (B, m, n)
    operator, in `vals`' dtype."""
    __slots__ = ("pattern", "vals", "base", "dtype", "_blocks", "_copies")
    counts = ("structured",)

    def __init__(self, pattern: RowPattern, vals: torch.Tensor,
                 base: Optional[torch.Tensor] = None):
        self.pattern, self.vals, self.dtype = pattern, vals, vals.dtype
        self.base = pattern.base.to(vals.dtype) if base is None else base
        self._blocks, self._copies = {}, {}

    def _map(self, fn) -> "LaneRows":
        return LaneRows(self.pattern, fn(self.vals), fn(self.base))

    def split(self) -> "LaneRows":
        """Itself: it multiplies in its own dtype (float64 here)."""
        return self

    def jac_tv(self, y: torch.Tensor, jac) -> torch.Tensor:
        """A' y (linear rows only)."""
        return self.tv(y)

    def _coef(self, name: str, sums):
        blocks = self._blocks.get(name)
        if blocks is None:
            blocks = self._blocks[name] = sums.coef_blocks(self.vals)
        return blocks

    def mv(self, x: torch.Tensor) -> torch.Tensor:
        """A x per lane: x (B, n) -> (B, m)."""
        p = self.pattern
        env = p.mv_sums(self._coef("mv", p.mv_sums), x)
        if not p.m_base:
            return env
        return torch.cat([x @ self.base.T, env], dim=1)

    def tv(self, y: torch.Tensor) -> torch.Tensor:
        """A' y per lane: y (B, m) -> (B, n)."""
        p = self.pattern
        out = p.tv_sums(self._coef("tv", p.tv_sums), y[:, p.m_base:])
        if not p.m_base:
            return out
        return y[:, :p.m_base] @ self.base + out

    def gram(self, w: torch.Tensor) -> torch.Tensor:
        """A' diag(w) A per lane (B, n, n): the base rows' dense product
        plus the block rows' pairs."""
        p = self.pattern
        g = p.gram_sums()
        out = SharedDense(self.base).gram(w[:, :p.m_base]) if p.m_base \
            else None
        return g(self._coef("gram", g), w[:, p.m_base:], out)

    def row_gram(self, h: torch.Tensor) -> torch.Tensor:
        """A diag(h) A' per lane (B, m, m): pairs within each column."""
        p = self.pattern
        g, br, bc, order = p.row_gram_sums()
        blocks = self._blocks.get("row_gram")
        if blocks is None:
            B = self.vals.shape[0]
            v = torch.cat([self.base[br, bc].expand(B, -1), self.vals],
                          dim=1)[:, order]
            blocks = self._blocks["row_gram"] = g.coef_blocks(v)
        return g(blocks, h)

    def rows(self, idx: torch.Tensor) -> LaneDense:
        """Rows `idx` of every lane, dense (B, len(idx), n)."""
        p = self.pattern
        B, k, n = self.vals.shape[0], idx.shape[0], p.n
        # where each row lands (k for rows not asked for); the block
        # entries of rows not asked for go past the k rows, one place
        # each, and are cut off
        land = torch.full((p.m,), k, dtype=torch.long, device=idx.device)
        land[idx] = torch.arange(k, device=idx.device)
        out = self.vals.new_zeros((B, k * n + p.nnz))
        dest = land[p.m_base + p.rows_t]
        place = torch.where(dest < k, dest * n + p.cols_t,
                            k * n + torch.arange(p.nnz, device=idx.device))
        out[:, place] = self.vals
        out = out[:, :k * n].reshape(B, k, n)
        if p.m_base:
            is_base = idx < p.m_base
            base = self.base[torch.clamp(idx, max=p.m_base - 1)]
            out = torch.where(is_base[None, :, None], base, out)
        return LaneDense(out)

    def dense(self) -> torch.Tensor:
        """The (B, m, n) operator."""
        return self.rows(torch.arange(self.pattern.m,
                                      device=self.vals.device)).data
