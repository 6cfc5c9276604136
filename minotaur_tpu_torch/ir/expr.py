"""Flat expression DAG — the TPU-native replacement for the reference's
CGraph/CNode (reference: src/base/CGraph.h:33, CNode.h).

Instead of a pointer graph with virtual eval methods, an ``ExprGraph`` is a
struct-of-arrays table in topological order (children before parents):

    op[i]    : opcode (ops.opcodes.Op)
    arg1[i]  : index of first child  (-1 for leaves)
    arg2[i]  : index of second child (-1 if unary/leaf)
    const[i] : constant payload — value of NUM nodes, exponent of POWK,
               base of CPOW
    var[i]   : variable index for VAR nodes, else -1

The table stages into straight-line jnp code (ops/stage.py) that XLA fuses;
evaluation, gradients (jax.grad), Hessians and interval sweeps all vmap
across a batch of points / bound boxes.  Hash-consing at build time gives
the same subexpression sharing the reference gets from its DAG.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from ..ops.opcodes import BINARY_OPS, LEAF_OPS, UNARY_OPS, Op


class ExprGraph:
    __slots__ = ("_op", "_arg1", "_arg2", "_const", "_var", "_cache", "root",
                 "_frozen", "_vars_cache")

    def __init__(self) -> None:
        self._op: List[int] = []
        self._arg1: List[int] = []
        self._arg2: List[int] = []
        self._const: List[float] = []
        self._var: List[int] = []
        self._cache: Dict[Tuple, int] = {}
        self.root: int = -1
        self._frozen: Optional[Tuple[np.ndarray, ...]] = None
        self._vars_cache: Optional[np.ndarray] = None

    # ---------------------------------------------------------------- build
    def _push(self, op: Op, a1: int, a2: int, c: float, v: int) -> int:
        key = (int(op), a1, a2, c, v)
        hit = self._cache.get(key)
        if hit is not None:
            return hit
        idx = len(self._op)
        self._op.append(int(op))
        self._arg1.append(a1)
        self._arg2.append(a2)
        self._const.append(c)
        self._var.append(v)
        self._cache[key] = idx
        self._frozen = None
        self._vars_cache = None
        return idx

    def num(self, value: float) -> int:
        return self._push(Op.NUM, -1, -1, float(value), -1)

    def var(self, var_index: int) -> int:
        return self._push(Op.VAR, -1, -1, 0.0, int(var_index))

    def node(self, op: Op, a1: int, a2: int = -1, const: float = 0.0) -> int:
        """Create an interior node (reference: CGraph::newNode, CGraph.h:133).

        Light algebraic normalization mirrors what the reference does when
        converting ASL trees: x^2 -> SQR, x^k -> POWK, c^x -> CPOW."""
        op = Op(op)
        if op in UNARY_OPS and op not in (Op.POWK, Op.CPOW):
            assert a2 == -1
        if op is Op.POW:
            # specialize constant exponent / base
            if self._op[a2] == Op.NUM:
                k = self._const[a2]
                if k == 2.0:
                    return self._push(Op.SQR, a1, -1, 0.0, -1)
                if k == 1.0:
                    return a1
                return self._push(Op.POWK, a1, -1, k, -1)
            if self._op[a1] == Op.NUM:
                return self._push(Op.CPOW, a2, -1, self._const[a1], -1)
        return self._push(op, a1, a2, const, -1)

    def sum_list(self, children: Sequence[int]) -> int:
        """Binarize an n-ary sum (ASL OPSUMLIST / reference OpSumList)."""
        assert children
        acc = children[0]
        for c in children[1:]:
            acc = self.node(Op.PLUS, acc, c)
        return acc

    def nary(self, op: Op, children: Sequence[int]) -> int:
        assert children
        acc = children[0]
        for c in children[1:]:
            acc = self.node(op, acc, c)
        return acc

    def set_root(self, idx: int) -> None:
        self.root = idx

    # ------------------------------------------------------------- queries
    def __len__(self) -> int:
        return len(self._op)

    @property
    def tables(self) -> Tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
        """(op, arg1, arg2, const, var) as numpy arrays; cached."""
        if self._frozen is None:
            self._frozen = (
                np.asarray(self._op, dtype=np.int32),
                np.asarray(self._arg1, dtype=np.int32),
                np.asarray(self._arg2, dtype=np.int32),
                np.asarray(self._const, dtype=np.float64),
                np.asarray(self._var, dtype=np.int32),
            )
        return self._frozen

    def vars_used(self) -> np.ndarray:
        """Sorted unique variable indices appearing in the graph."""
        if self._vars_cache is None:
            v = self.tables[4]
            self._vars_cache = np.unique(v[v >= 0])
        return self._vars_cache

    def reachable_from_root(self) -> np.ndarray:
        """Boolean mask of nodes reachable from root (hash-consing can leave
        orphans when subtrees are replaced)."""
        n = len(self._op)
        mask = np.zeros(n, dtype=bool)
        if self.root < 0:
            return mask
        stack = [self.root]
        while stack:
            i = stack.pop()
            if mask[i]:
                continue
            mask[i] = True
            for a in (self._arg1[i], self._arg2[i]):
                if a >= 0:
                    stack.append(a)
        return mask

    # ----------------------------------------------------------- transforms
    def substitute_vars(self, mapping: Dict[int, int]) -> "ExprGraph":
        """New graph with variable indices remapped."""
        g = ExprGraph()
        remap: Dict[int, int] = {}
        for i in range(len(self._op)):
            op = Op(self._op[i])
            if op is Op.NUM:
                remap[i] = g.num(self._const[i])
            elif op is Op.VAR:
                remap[i] = g.var(mapping.get(self._var[i], self._var[i]))
            else:
                a1 = remap[self._arg1[i]] if self._arg1[i] >= 0 else -1
                a2 = remap[self._arg2[i]] if self._arg2[i] >= 0 else -1
                remap[i] = g._push(op, a1, a2, self._const[i], -1)
        g.set_root(remap[self.root] if self.root >= 0 else -1)
        return g

    def clone(self) -> "ExprGraph":
        return self.substitute_vars({})

    # ------------------------------------------------------------ eval (np)
    def eval_np(self, x: np.ndarray) -> float:
        """Reference-quality host evaluation in numpy (used by tests and the
        debug_sol oracle); device evaluation goes through ops/stage.py."""
        from ..ops.stage import NUMPY_RULES  # late import to avoid cycle
        vals = np.empty(len(self._op), dtype=np.float64)
        for i in range(len(self._op)):
            op = Op(self._op[i])
            if op is Op.NUM:
                vals[i] = self._const[i]
            elif op is Op.VAR:
                vals[i] = x[self._var[i]]
            else:
                a = vals[self._arg1[i]] if self._arg1[i] >= 0 else None
                b = vals[self._arg2[i]] if self._arg2[i] >= 0 else None
                vals[i] = NUMPY_RULES[op](a, b, self._const[i])
        return float(vals[self.root])

    def __repr__(self) -> str:  # pragma: no cover
        return f"ExprGraph(n={len(self._op)}, root={self.root})"
