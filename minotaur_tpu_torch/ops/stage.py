"""Host (numpy) evaluation rules for expression graphs.

Copied from minotaur_tpu/ops/stage.py (`NUMPY_RULES` and its helpers
only): `ir/expr.py` evaluates graphs on the host through this table.
The jnp staging of that module belongs to the NL path, which is not
ported yet (see ROADMAP.md).
"""

from __future__ import annotations

import math
from typing import Callable, Dict

import numpy as np

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
