"""MPS reader (free-format) -> Problem.

Reference: src/base/Reader.{h,cpp} (native MPS parser, Reader.cpp:42).
Supports ROWS/COLUMNS (with integer markers)/RHS/RANGES/BOUNDS/OBJSENSE
and the common bound codes.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import numpy as np

from ..ir.functions import Function, LinearFunction
from ..ir.problem import Problem
from ..utils.types import INF, ObjectiveType, VarType


class MpsReadError(Exception):
    pass


def read_mps(path: str) -> Problem:
    with open(path) as fh:
        lines = fh.readlines()

    section = None
    name = "mps"
    obj_sense = ObjectiveType.MINIMIZE
    rows: Dict[str, str] = {}
    row_order: List[str] = []
    obj_row: Optional[str] = None
    cols: Dict[str, Dict[str, float]] = {}
    col_order: List[str] = []
    integer_cols: set = set()
    rhs: Dict[str, float] = {}
    ranges: Dict[str, float] = {}
    bounds: Dict[str, Tuple[Optional[float], Optional[float], bool]] = {}
    in_int = False

    i = 0
    while i < len(lines):
        raw = lines[i]
        i += 1
        if not raw.strip() or raw.lstrip().startswith("*"):
            continue
        if not raw[0].isspace():
            parts = raw.split()
            section = parts[0].upper()
            if section == "NAME" and len(parts) > 1:
                name = parts[1]
            elif section == "OBJSENSE":
                # value may be inline or on the next line
                tok = parts[1] if len(parts) > 1 else lines[i].split()[0]
                if len(parts) == 1:
                    i += 1
                if tok.upper().startswith("MAX"):
                    obj_sense = ObjectiveType.MAXIMIZE
            elif section == "ENDATA":
                break
            continue

        parts = raw.split()
        if section == "ROWS":
            rtype, rname = parts[0].upper(), parts[1]
            if rtype == "N":
                if obj_row is None:
                    obj_row = rname
            else:
                rows[rname] = rtype
                row_order.append(rname)
        elif section == "COLUMNS":
            if len(parts) >= 3 and parts[1].upper().startswith("'MARKER'"):
                if parts[2].upper().startswith("'INTORG'"):
                    in_int = True
                elif parts[2].upper().startswith("'INTEND'"):
                    in_int = False
                continue
            # also handle  MARKER .. INTORG  without quotes spread out
            ups = [p.upper().strip("'") for p in parts]
            if "MARKER" in ups:
                if "INTORG" in ups:
                    in_int = True
                elif "INTEND" in ups:
                    in_int = False
                continue
            cname = parts[0]
            if cname not in cols:
                cols[cname] = {}
                col_order.append(cname)
                if in_int:
                    integer_cols.add(cname)
            for j in range(1, len(parts) - 1, 2):
                cols[cname][parts[j]] = float(parts[j + 1])
        elif section == "RHS":
            for j in range(1, len(parts) - 1, 2):
                rhs[parts[j]] = float(parts[j + 1])
        elif section == "RANGES":
            for j in range(1, len(parts) - 1, 2):
                ranges[parts[j]] = float(parts[j + 1])
        elif section == "BOUNDS":
            btype = parts[0].upper()
            cname = parts[2]
            val = float(parts[3]) if len(parts) > 3 else 0.0
            lo, hi, isint = bounds.get(cname, (None, None, False))
            if btype == "UP":
                hi = val
                if val < 0 and lo is None:
                    lo = -INF
            elif btype == "LO":
                lo = val
            elif btype == "FX":
                lo = hi = val
            elif btype == "FR":
                lo, hi = -INF, INF
            elif btype == "MI":
                lo = -INF
            elif btype == "PL":
                hi = INF
            elif btype == "BV":
                lo, hi, isint = 0.0, 1.0, True
            elif btype == "UI":
                hi = val
                isint = True
            elif btype == "LI":
                lo = val
                isint = True
            else:
                raise MpsReadError(f"unknown bound type {btype}")
            bounds[cname] = (lo, hi, isint)
        elif section in ("NAME", "OBJSENSE", None):
            continue
        else:
            raise MpsReadError(f"unsupported MPS section {section}")

    p = Problem(name)
    col_index: Dict[str, int] = {}
    for cname in col_order:
        lo, hi, isint = bounds.get(cname, (None, None, False))
        isint = isint or cname in integer_cols
        if lo is None:
            lo = 0.0
        if hi is None:
            hi = INF
        vt = VarType.INTEGER if isint else VarType.CONTINUOUS
        if isint and lo >= 0 and hi <= 1:
            vt = VarType.BINARY
        v = p.new_variable(lo, hi, vt, cname)
        col_index[cname] = v.index

    for rname in row_order:
        lf = LinearFunction()
        for cname, coefs in cols.items():
            if rname in coefs:
                lf.add_term(col_index[cname], coefs[rname])
        rtype = rows[rname]
        b = rhs.get(rname, 0.0)
        if rtype == "L":
            lo, hi = -INF, b
        elif rtype == "G":
            lo, hi = b, INF
        else:  # E
            lo = hi = b
        if rname in ranges:
            r = ranges[rname]
            if rtype == "L":
                lo = b - abs(r)
            elif rtype == "G":
                hi = b + abs(r)
            else:
                if r >= 0:
                    hi = b + r
                else:
                    lo = b + r
        p.new_constraint(Function(lf=lf), lo, hi, rname)

    olf = LinearFunction()
    if obj_row is not None:
        for cname, coefs in cols.items():
            if obj_row in coefs:
                olf.add_term(col_index[cname], coefs[obj_row])
    p.new_objective(Function(lf=olf), 0.0, obj_sense)
    return p
