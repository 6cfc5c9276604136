"""Stage an ExprGraph into straight-line torch code.

Port of minotaur_tpu/ops/stage.py.  The host (numpy) rule table is copied
verbatim (`ir/expr.py` evaluates graphs on the host through it); the jnp
rule table becomes a torch one.  The table is unrolled once per call into
plain torch ops on a trailing variable axis: `f(x)` takes x of shape
(..., n) and returns (...), so one call evaluates every lane of a batch,
and the same code evaluates one point (x of shape (n,)) inside
`torch.func.vmap`.  The staged code is purely functional (no in-place
writes, no `.item()`, no branching on tensor values), so
`torch.func.grad`, `jacfwd`, `hessian` and `vmap` transform it.

Constant subtrees are folded once at staging time with the same torch
rules on float64 scalars, so at run time every rule gets at least one
tensor operand.  Domain clamps use `torch.maximum`/`torch.minimum` with
tensor bounds (never `torch.clamp`): at a tie their gradient splits in
half, as `jnp.maximum`'s and `jnp.clip`'s do in the JAX package.
"""

from __future__ import annotations

import math
from typing import Callable, Dict, List, Sequence

import numpy as np
import torch

from .opcodes import Op

_TINY = 1e-300


def _np_powk(a, k):
    if float(k).is_integer():
        return a ** k
    return np.maximum(a, 0.0) ** k


# Host (numpy) evaluation rules — the correctness oracle used by tests and
# by Problem.is_debug_sol_feas.  Signature: (a, b, const) -> value.
NUMPY_RULES: Dict[Op, Callable] = {
    Op.PLUS: lambda a, b, c: a + b,
    Op.MINUS: lambda a, b, c: a - b,
    Op.MULT: lambda a, b, c: a * b,
    Op.DIV: lambda a, b, c: a / b,
    Op.UMINUS: lambda a, b, c: -a,
    Op.ABS: lambda a, b, c: abs(a),
    Op.SQR: lambda a, b, c: a * a,
    Op.SQRT: lambda a, b, c: math.sqrt(max(a, 0.0)),
    Op.POWK: lambda a, b, c: _np_powk(a, c),
    Op.CPOW: lambda a, b, c: c ** a,
    Op.POW: lambda a, b, c: a ** b,
    Op.EXP: lambda a, b, c: math.exp(min(a, 709.0)),
    Op.LOG: lambda a, b, c: math.log(max(a, _TINY)),
    Op.LOG10: lambda a, b, c: math.log10(max(a, _TINY)),
    Op.SIN: lambda a, b, c: math.sin(a),
    Op.COS: lambda a, b, c: math.cos(a),
    Op.TAN: lambda a, b, c: math.tan(a),
    Op.SINH: lambda a, b, c: math.sinh(a),
    Op.COSH: lambda a, b, c: math.cosh(a),
    Op.TANH: lambda a, b, c: math.tanh(a),
    Op.ASIN: lambda a, b, c: math.asin(min(1.0, max(-1.0, a))),
    Op.ACOS: lambda a, b, c: math.acos(min(1.0, max(-1.0, a))),
    Op.ATAN: lambda a, b, c: math.atan(a),
    Op.ASINH: lambda a, b, c: math.asinh(a),
    Op.ACOSH: lambda a, b, c: math.acosh(max(a, 1.0)),
    Op.ATANH: lambda a, b, c: math.atanh(min(1.0 - 1e-15, max(-1.0 + 1e-15, a))),
    Op.ATAN2: lambda a, b, c: math.atan2(a, b),
    Op.FLOOR: lambda a, b, c: math.floor(a),
    Op.CEIL: lambda a, b, c: math.ceil(a),
    Op.INTDIV: lambda a, b, c: math.trunc(a / b),
    Op.MAX2: lambda a, b, c: max(a, b),
    Op.MIN2: lambda a, b, c: min(a, b),
    Op.REM: lambda a, b, c: math.fmod(a, b),
    Op.LESS: lambda a, b, c: max(a - b, 0.0),
}


def _torch_rules():
    """The jnp rule table of the JAX package in torch.  `K(v, like)` is a
    0-dim tensor holding v with like's dtype and device (made once per
    device, dtype and value); binary rules lift a float operand the same
    way."""
    made = {}

    def K(v, like):
        key = (like.device, like.dtype, v)
        t = made.get(key)
        if t is None:
            t = made[key] = torch.full((), v, dtype=like.dtype,
                                       device=like.device)
        return t

    def T(a, b):
        """Both operands as tensors (at most one is a float)."""
        if not isinstance(a, torch.Tensor):
            return K(a, b), b
        if not isinstance(b, torch.Tensor):
            return a, K(b, a)
        return a, b

    def mx(a, v):
        return torch.maximum(a, K(v, a))

    def mn(a, v):
        return torch.minimum(a, K(v, a))

    def clip(a, lo, hi):
        return mn(mx(a, lo), hi)

    def powk(a, b, c):
        if float(c).is_integer():
            return a ** int(c)
        return torch.pow(mx(a, 0.0), c)

    def binop(fn):
        return lambda a, b, c: fn(*T(a, b))

    return {
        Op.PLUS: lambda a, b, c: a + b,
        Op.MINUS: lambda a, b, c: a - b,
        Op.MULT: lambda a, b, c: a * b,
        Op.DIV: lambda a, b, c: a / b,
        Op.UMINUS: lambda a, b, c: -a,
        Op.ABS: lambda a, b, c: torch.abs(a),
        Op.SQR: lambda a, b, c: a * a,
        Op.SQRT: lambda a, b, c: torch.sqrt(mx(a, 0.0)),
        Op.POWK: powk,
        Op.CPOW: lambda a, b, c: torch.pow(c, a),
        Op.POW: binop(torch.pow),
        Op.EXP: lambda a, b, c: torch.exp(mn(a, 709.0)),
        Op.LOG: lambda a, b, c: torch.log(mx(a, _TINY)),
        Op.LOG10: lambda a, b, c: torch.log10(mx(a, _TINY)),
        Op.SIN: lambda a, b, c: torch.sin(a),
        Op.COS: lambda a, b, c: torch.cos(a),
        Op.TAN: lambda a, b, c: torch.tan(a),
        Op.SINH: lambda a, b, c: torch.sinh(a),
        Op.COSH: lambda a, b, c: torch.cosh(a),
        Op.TANH: lambda a, b, c: torch.tanh(a),
        Op.ASIN: lambda a, b, c: torch.asin(clip(a, -1.0, 1.0)),
        Op.ACOS: lambda a, b, c: torch.acos(clip(a, -1.0, 1.0)),
        Op.ATAN: lambda a, b, c: torch.atan(a),
        Op.ASINH: lambda a, b, c: torch.asinh(a),
        Op.ACOSH: lambda a, b, c: torch.acosh(mx(a, 1.0)),
        Op.ATANH: lambda a, b, c: torch.atanh(clip(a, -1.0 + 1e-15,
                                                   1.0 - 1e-15)),
        Op.ATAN2: binop(torch.atan2),
        Op.FLOOR: lambda a, b, c: torch.floor(a),
        Op.CEIL: lambda a, b, c: torch.ceil(a),
        Op.INTDIV: lambda a, b, c: torch.trunc(a / b),
        Op.MAX2: binop(torch.maximum),
        Op.MIN2: binop(torch.minimum),
        Op.REM: binop(torch.fmod),
        Op.LESS: lambda a, b, c: mx(a - b, 0.0),
    }


TORCH_RULES: Dict[Op, Callable] = _torch_rules()


def _fold(o: Op, a, b, c) -> float:
    """Value of a node whose children are all constants, by the torch
    rule on float64 scalars (what the staged code would compute)."""
    t = lambda v: None if v is None else torch.tensor(v, dtype=torch.float64)  # noqa: E731
    return float(TORCH_RULES[o](t(a), t(b), c))


def stage_scalar(graph) -> Callable:
    """graph -> f(x) with x of shape (..., n), returning (...).  Only
    nodes reachable from the root are emitted."""
    op, arg1, arg2, const, var = graph.tables
    reach = graph.reachable_from_root()
    root = graph.root
    n = len(op)
    # constant folding (staging time): consts[i] is a float for every node
    # whose value does not depend on x
    consts: List = [None] * n
    prog = []                     # (i, Op, arg1, arg2, const) for x-nodes
    for i in range(n):
        if not reach[i]:
            continue
        o = Op(op[i])
        if o is Op.NUM:
            consts[i] = float(const[i])
        elif o is Op.VAR:
            prog.append((i, o, int(var[i]), -1, 0.0))
        else:
            a1, a2 = int(arg1[i]), int(arg2[i])
            if (a1 < 0 or consts[a1] is not None) and \
                    (a2 < 0 or consts[a2] is not None):
                consts[i] = _fold(o, None if a1 < 0 else consts[a1],
                                  None if a2 < 0 else consts[a2],
                                  float(const[i]))
            else:
                prog.append((i, o, a1, a2, float(const[i])))
    rules = TORCH_RULES

    def f(x):
        vals: List = list(consts)
        for i, o, a1, a2, c in prog:
            if o is Op.VAR:
                vals[i] = x[..., a1]
            else:
                vals[i] = rules[o](vals[a1] if a1 >= 0 else None,
                                   vals[a2] if a2 >= 0 else None, c)
        v = vals[root]
        if not isinstance(v, torch.Tensor):
            v = x.new_full(x.shape[:-1], v)
        return v

    return f


def stage_stack(graphs: Sequence) -> Callable:
    """Stage several graphs into one f(x) -> (..., len(graphs)) of values
    (all nonlinear constraint bodies of a problem in one call)."""
    fns = [stage_scalar(g) for g in graphs]

    def f(x):
        if not fns:
            return x.new_zeros(x.shape[:-1] + (0,))
        return torch.stack([fn(x) for fn in fns], dim=-1)

    return f
