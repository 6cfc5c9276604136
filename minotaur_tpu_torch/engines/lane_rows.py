"""Per-lane constraint rows of one fixed sparsity pattern beside shared
dense rows: the global path's constraint operator (`glob/glob_step.py`).

A lane's rows are the model's base rows, dense and the same in every
lane, then the envelope rows of its box, whose nonzeros sit at (row,
col) places fixed when the step is built and whose values are the
lane's.  `RowPattern` holds the places and the index maps of every
product; `LaneRows` holds one batch's values (B, nnz) in one dtype.  The
IPM takes a `LaneRows` where it takes a dense (B, m, n) operator
(`engines/ipm.py`: `_mv`, `_tv`, `_spmv`, `_gram`, `_row_gram`,
`_rows`), so a lane of the 100-item QKP carries 14,868 values, not a
(4957, 1339) matrix.

Every sum runs in an order fixed by the pattern (`_SegSum`): the terms
of an output are gathered into a padded block and summed along it, never
scattered with atomics, so a repeated call gives the same bits.  The
weighted Gram A' diag(w) A is the base rows' dense rank-m_base product
plus, for every pair of entries within an envelope row, w_r v_a v_b at
(a, b); its pairs are listed once, when the pattern is built.
"""

from __future__ import annotations

from typing import List, Optional

import numpy as np
import torch
import torch.nn.functional as F

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


class LaneRows:
    """A batch's constraint operator on a `RowPattern`: the shared base
    rows (in this operator's dtype) and `vals` (B, nnz), lane b's value
    of each slot.  The products that the IPM takes of a dense (B, m, n)
    operator, in `vals`' dtype."""
    __slots__ = ("pattern", "vals", "base", "_blocks")

    def __init__(self, pattern: RowPattern, vals: torch.Tensor,
                 base: Optional[torch.Tensor] = None):
        self.pattern, self.vals = pattern, vals
        self.base = pattern.base.to(vals.dtype) if base is None else base
        self._blocks = {}

    @property
    def dtype(self) -> torch.dtype:
        return self.vals.dtype

    def to(self, dtype: torch.dtype) -> "LaneRows":
        return LaneRows(self.pattern, self.vals.to(dtype),
                        self.base.to(dtype))

    def abs(self) -> "LaneRows":
        return LaneRows(self.pattern, self.vals.abs(), self.base.abs())

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
        out = None
        if p.m_base:
            mb = p.m_base
            out = torch.matmul(self.base.T * w[:, None, :mb], self.base)
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

    def rows(self, idx: torch.Tensor) -> torch.Tensor:
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
        return out

    def dense(self) -> torch.Tensor:
        """The (B, m, n) operator."""
        p = self.pattern
        B = self.vals.shape[0]
        out = self.vals.new_zeros((B, p.m, p.n))
        out[:, :p.m_base] = self.base
        out[:, p.m_base + p.rows_t, p.cols_t] = self.vals
        return out
