"""Expression-DAG opcodes.

Mirrors the reference's opcode set (reference: src/base/OpCode.h:17-53)
minus list-ops: OpSumList / min-list / max-list are binarized into chains at
build time so every interior node has at most two children.  That keeps the
IR a flat (op, arg1, arg2, const, var) table that stages cleanly into
unrolled jnp code.
"""

from __future__ import annotations

import enum


class Op(enum.IntEnum):
    NUM = 0      # constant, value in `const`
    VAR = 1      # variable, index in `var`
    PLUS = 2
    MINUS = 3
    MULT = 4
    DIV = 5
    UMINUS = 6
    ABS = 7
    SQR = 8      # x^2            (reference OpSqr)
    SQRT = 9
    POWK = 10    # x^k, k const   (reference OpPowK; ASL OP1POW)
    CPOW = 11    # c^x, c const   (reference OpCPow; ASL OPCPOW)
    POW = 12     # x^y, both vary (reference OpPow; ASL OPPOW)
    EXP = 13
    LOG = 14
    LOG10 = 15
    SIN = 16
    COS = 17
    TAN = 18
    SINH = 19
    COSH = 20
    TANH = 21
    ASIN = 22
    ACOS = 23
    ATAN = 24
    ASINH = 25
    ACOSH = 26
    ATANH = 27
    ATAN2 = 28
    FLOOR = 29
    CEIL = 30
    INTDIV = 31  # trunc(x/y)     (reference OpIntDiv)
    MAX2 = 32    # binary max (min/max lists are binarized)
    MIN2 = 33
    REM = 34     # fmod
    LESS = 35    # max(l - r, 0)  (ASL OPLESS)
    NONE = 63


# ASL .nl opcode numbers -> our Op (for io/nl_reader.py). ASL numbers are
# from the public asl/opcode.hd; the reference consumes them in
# AMPLInterface.cpp:675 (copyInstanceFromASL2_).
ASL_UNARY = {
    13: Op.FLOOR, 14: Op.CEIL, 15: Op.ABS, 16: Op.UMINUS,
    37: Op.TANH, 38: Op.TAN, 39: Op.SQRT, 40: Op.SINH, 41: Op.SIN,
    42: Op.LOG10, 43: Op.LOG, 44: Op.EXP, 45: Op.COSH, 46: Op.COS,
    47: Op.ATANH, 49: Op.ATAN, 50: Op.ASINH, 51: Op.ASIN,
    52: Op.ACOSH, 53: Op.ACOS,
}
ASL_BINARY = {
    0: Op.PLUS, 1: Op.MINUS, 2: Op.MULT, 3: Op.DIV, 4: Op.REM,
    5: Op.POW, 6: Op.LESS, 48: Op.ATAN2, 55: Op.INTDIV,
}
ASL_NARY = {11: Op.MIN2, 12: Op.MAX2, 54: Op.PLUS}
ASL_OP1POW = 76   # x ^ const
ASL_OP2POW = 77   # x ^ 2
ASL_OPCPOW = 78   # const ^ x
ASL_SUMLIST = 54


UNARY_OPS = frozenset({
    Op.UMINUS, Op.ABS, Op.SQR, Op.SQRT, Op.POWK, Op.CPOW, Op.EXP, Op.LOG,
    Op.LOG10, Op.SIN, Op.COS, Op.TAN, Op.SINH, Op.COSH, Op.TANH, Op.ASIN,
    Op.ACOS, Op.ATAN, Op.ASINH, Op.ACOSH, Op.ATANH, Op.FLOOR, Op.CEIL,
})
BINARY_OPS = frozenset({
    Op.PLUS, Op.MINUS, Op.MULT, Op.DIV, Op.POW, Op.ATAN2, Op.INTDIV,
    Op.MAX2, Op.MIN2, Op.REM, Op.LESS,
})
LEAF_OPS = frozenset({Op.NUM, Op.VAR})
