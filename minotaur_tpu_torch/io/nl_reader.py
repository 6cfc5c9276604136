"""AMPL .nl reader — text ('g') and binary ('b') formats.

From-scratch replacement for the reference's ASL-based front end
(reference: src/interfaces/AMPLInterface.cpp:2018-2083 readInstance /
copyInstanceFromASL2_:675).  The reference links AMPL's ASL library; we
parse the documented .nl formats directly into our Problem IR, turning each
nonlinear body into an ExprGraph (the reference turns ASL expression trees
into CGraphs).

Quadratic bodies are detected and extracted into LinearFunction +
QuadraticFunction instead of a DAG — the analogue of the reference's
``cg2qf`` (Problem.h:155) — because on TPU a quadratic is a dense
x'Qx matmul on the MXU, which beats any DAG walk.

Format notes (D. Gay, "Writing .nl Files"):
  10 text header lines of counts; then segments C/O/J/G/r/b/k/x/d/V/S.
  Binary files ('b' first header char) share the text header; segment
  bodies use raw little-endian int32/float64, expression tokens are a tag
  byte + payload, and bound-type codes are ASCII digit bytes.
  Variable ordering: nonlinear-in-both (nlvb), nonlinear-in-cons
  (nlvc-nlvb), nonlinear-in-obj-extra (max(nlvo-nlvc,0)), linear arcs (nwv),
  other linear, binary (nbv), integer (niv); integer sub-blocks sit at the
  *end* of each nonlinear block (nlvbi/nlvci/nlvoi).
"""

from __future__ import annotations

import dataclasses
import struct
from typing import Dict, List, Optional, Tuple

import numpy as np

from ..ir.expr import ExprGraph
from ..ir.functions import Function, LinearFunction, QuadraticFunction
from ..ir.problem import Problem
from ..ops.opcodes import (
    ASL_BINARY, ASL_NARY, ASL_OP1POW, ASL_OP2POW, ASL_OPCPOW, ASL_UNARY, Op,
)
from ..utils.types import INF, ObjectiveType, VarType


class NlReadError(Exception):
    pass


@dataclasses.dataclass
class NlHeader:
    name: str = ""
    n_var: int = 0
    n_con: int = 0
    n_obj: int = 0
    n_ranges: int = 0
    n_eqns: int = 0
    n_lcons: int = 0
    nlc: int = 0          # nonlinear constraints
    nlo: int = 0          # nonlinear objectives
    nlvc: int = 0         # vars nonlinear in constraints
    nlvo: int = 0         # vars nonlinear in objectives
    nlvb: int = 0         # vars nonlinear in both
    nwv: int = 0          # linear arc variables
    nbv: int = 0          # binary variables (linear block)
    niv: int = 0          # integer variables (linear block)
    nlvbi: int = 0
    nlvci: int = 0
    nlvoi: int = 0
    nzc: int = 0
    nzo: int = 0
    com_b: int = 0
    com_c: int = 0
    com_o: int = 0
    com_c1: int = 0
    com_o1: int = 0


def _ints(line: str, n: int) -> List[int]:
    parts = line.split("#")[0].split()
    vals = [int(float(p)) for p in parts]
    while len(vals) < n:
        vals.append(0)
    return vals


# AST node forms: ("n", value) | ("v", index) | ("o", Op, [children], const)
_AST = tuple

_BOUND_NDOUBLES = {"0": 2, "1": 1, "2": 1, "3": 0, "4": 1}


# --------------------------------------------------------------------------
# token sources: text and binary
# --------------------------------------------------------------------------
class _TextSrc:
    def __init__(self, lines: List[str]):
        self.lines = lines
        self.pos = 0

    def eof(self) -> bool:
        return self.pos >= len(self.lines)

    def segment(self) -> Tuple[str, List[str]]:
        """Next segment letter + same-line fields."""
        line = self.lines[self.pos].strip()
        self.pos += 1
        return line[0], line[1:].split()

    def read_int(self) -> int:
        v = int(self.lines[self.pos].split()[0])
        self.pos += 1
        return v

    def read_pair(self) -> Tuple[int, float]:
        a, b = self.lines[self.pos].split()[:2]
        self.pos += 1
        return int(a), float(b)

    def read_int_pair(self) -> Tuple[int, int]:
        a, b = self.lines[self.pos].split()[:2]
        self.pos += 1
        return int(a), int(float(b))

    def read_bound(self) -> Tuple[float, float]:
        parts = self.lines[self.pos].split()
        self.pos += 1
        code = parts[0]
        if code == "0":
            return float(parts[1]), float(parts[2])
        if code == "1":
            return -INF, float(parts[1])
        if code == "2":
            return float(parts[1]), INF
        if code == "3":
            return -INF, INF
        if code == "4":
            v = float(parts[1])
            return v, v
        raise NlReadError(f"complementarity bounds not supported: {parts!r}")

    def expr_tok(self):
        """-> ('n', val) | ('v', idx) | ('o', opnum)"""
        line = self.lines[self.pos].strip()
        self.pos += 1
        tag = line[0]
        if tag in ("n", "s", "l"):
            return ("n", float(line[1:]))
        if tag == "v":
            return ("v", int(line[1:]))
        if tag == "o":
            return ("o", int(line[1:].split()[0]))
        raise NlReadError(f"unsupported expression token {line!r}")

    def read_name(self) -> str:
        s = self.lines[self.pos].strip()
        self.pos += 1
        return s


class _BinSrc:
    def __init__(self, data: bytes, pos: int):
        self.data = data
        self.pos = pos

    def eof(self) -> bool:
        return self.pos >= len(self.data)

    def segment(self) -> Tuple[str, List[int]]:
        """Next segment letter; trailing same-record ints are read by the
        caller via read_int (counts differ per segment)."""
        ch = chr(self.data[self.pos])
        self.pos += 1
        return ch, []

    def read_int(self) -> int:
        v, = struct.unpack_from("<i", self.data, self.pos)
        self.pos += 4
        return v

    def read_double(self) -> float:
        v, = struct.unpack_from("<d", self.data, self.pos)
        self.pos += 8
        return v

    def read_pair(self) -> Tuple[int, float]:
        a, b = struct.unpack_from("<id", self.data, self.pos)
        self.pos += 12
        return a, b

    def read_int_pair(self) -> Tuple[int, int]:
        a, b = struct.unpack_from("<ii", self.data, self.pos)
        self.pos += 8
        return a, b

    def read_bound(self) -> Tuple[float, float]:
        code = chr(self.data[self.pos])
        self.pos += 1
        nd = _BOUND_NDOUBLES.get(code)
        if nd is None:
            raise NlReadError(f"complementarity bounds not supported: {code!r}")
        vals = struct.unpack_from("<" + "d" * nd, self.data, self.pos)
        self.pos += 8 * nd
        if code == "0":
            return vals[0], vals[1]
        if code == "1":
            return -INF, vals[0]
        if code == "2":
            return vals[0], INF
        if code == "3":
            return -INF, INF
        return vals[0], vals[0]

    def expr_tok(self):
        tag = chr(self.data[self.pos])
        self.pos += 1
        if tag == "n":
            return ("n", self.read_double())
        if tag in ("s", "l"):
            # short (2-byte) / long int constants
            if tag == "s":
                v, = struct.unpack_from("<h", self.data, self.pos)
                self.pos += 2
            else:
                v = self.read_int()
            return ("n", float(v))
        if tag == "v":
            return ("v", self.read_int())
        if tag == "o":
            return ("o", self.read_int())
        raise NlReadError(f"unsupported expression token {tag!r}")

    def read_name(self) -> str:
        end = self.data.index(b"\n", self.pos)
        s = self.data[self.pos:end].decode()
        self.pos = end + 1
        return s


# --------------------------------------------------------------------------
# quadratic extraction (cg2qf analogue, reference Problem.h:155)
# --------------------------------------------------------------------------
class _NotQuad(Exception):
    pass


def _ast_to_poly(ast: _AST, max_terms: int = 2_000_000) -> Dict[tuple, float]:
    """AST -> {multiset-of-var-indices (len<=2): coef}; raises _NotQuad."""
    kind = ast[0]
    if kind == "n":
        return {(): ast[1]} if ast[1] != 0.0 else {}
    if kind == "v":
        return {(ast[1],): 1.0}
    _, op, ch, const = ast
    if op is Op.PLUS or (op is Op.MINUS) or (op is Op.UMINUS):
        out: Dict[tuple, float] = {}
        signs = [1.0] * len(ch)
        if op is Op.MINUS:
            signs = [1.0, -1.0]
        elif op is Op.UMINUS:
            signs = [-1.0]
        for s, c in zip(signs, ch):
            for k, v in _ast_to_poly(c).items():
                out[k] = out.get(k, 0.0) + s * v
                if len(out) > max_terms:
                    raise _NotQuad
        return out
    if op is Op.MULT:
        pa = _ast_to_poly(ch[0])
        pb = _ast_to_poly(ch[1])
        out = {}
        for ka, va in pa.items():
            for kb, vb in pb.items():
                k = tuple(sorted(ka + kb))
                if len(k) > 2:
                    raise _NotQuad
                out[k] = out.get(k, 0.0) + va * vb
                if len(out) > max_terms:
                    raise _NotQuad
        return out
    if op is Op.SQR or (op is Op.POWK and const == 2.0):
        pa = _ast_to_poly(ch[0])
        out = {}
        for ka, va in pa.items():
            for kb, vb in pa.items():
                k = tuple(sorted(ka + kb))
                if len(k) > 2:
                    raise _NotQuad
                out[k] = out.get(k, 0.0) + va * vb
        return out
    if op is Op.POWK and const == 1.0:
        return _ast_to_poly(ch[0])
    if op is Op.POWK and const == 0.0:
        return {(): 1.0}
    if op is Op.POW:
        # ASL text files write x^2 as o5 (general pow) with constant exponent
        k = _ast_to_poly(ch[1])
        if list(k.keys()) not in ([()], []):
            raise _NotQuad
        kk = k.get((), 0.0)
        if kk == 2.0:
            return _ast_to_poly(("o", Op.SQR, [ch[0]], 0.0))
        if kk == 1.0:
            return _ast_to_poly(ch[0])
        if kk == 0.0:
            return {(): 1.0}
        raise _NotQuad
    if op is Op.DIV:
        pb = _ast_to_poly(ch[1])
        if list(pb.keys()) not in ([()], []):
            raise _NotQuad
        d = pb.get((), 0.0)
        if d == 0.0:
            raise _NotQuad
        return {k: v / d for k, v in _ast_to_poly(ch[0]).items()}
    raise _NotQuad


# --------------------------------------------------------------------------
# reader
# --------------------------------------------------------------------------
class NlReader:
    """Parse a .nl file (text or binary) into a Problem."""

    def __init__(self, extract_quadratics: bool = True) -> None:
        self.header = NlHeader()
        self.extract_quadratics = extract_quadratics
        self._defined: Dict[int, Tuple[List[Tuple[int, float]], Optional[_AST]]] = {}
        self.suffixes: Dict[Tuple[str, int], Dict[int, float]] = {}

    # ------------------------------------------------------------------ API
    def read(self, path: str) -> Problem:
        with open(path, "rb") as fh:
            data = fh.read()
        return self.read_bytes(
            data, name=path.rsplit("/", 1)[-1].rsplit(".", 1)[0])

    def read_string(self, text: str, name: str = "nl") -> Problem:
        return self.read_bytes(text.encode(), name)

    def read_bytes(self, data: bytes, name: str = "nl") -> Problem:
        # 10 header lines are text in both formats
        pos = 0
        header_lines = []
        for _ in range(10):
            end = data.index(b"\n", pos)
            header_lines.append(data[pos:end].decode())
            pos = end + 1
        first = header_lines[0].lstrip()
        if not first or first[0] not in "gb":
            raise NlReadError("not a .nl file (missing g/b header)")
        self._parse_header(header_lines, name)
        if first[0] == "g":
            src = _TextSrc(data[pos:].decode().splitlines())
        else:
            src = _BinSrc(data, pos)
        return self._parse_segments(src)

    def _parse_header(self, lines: List[str], name: str) -> None:
        h = self.header
        h.name = name
        if "# problem" in lines[0]:
            h.name = lines[0].split("# problem", 1)[1].strip()
        (h.n_var, h.n_con, h.n_obj, h.n_ranges, h.n_eqns, h.n_lcons) = \
            _ints(lines[1], 6)
        h.nlc, h.nlo = _ints(lines[2], 2)[:2]
        nlnc, lnc = _ints(lines[3], 2)[:2]
        if nlnc or lnc:
            raise NlReadError("network constraints not supported")
        h.nlvc, h.nlvo, h.nlvb = _ints(lines[4], 3)[:3]
        h.nwv = _ints(lines[5], 4)[0]
        h.nbv, h.niv, h.nlvbi, h.nlvci, h.nlvoi = _ints(lines[6], 5)[:5]
        h.nzc, h.nzo = _ints(lines[7], 2)[:2]
        (h.com_b, h.com_c, h.com_o, h.com_c1, h.com_o1) = _ints(lines[9], 5)
        if h.n_obj > 1:
            raise NlReadError(f"{h.n_obj} objectives; only 1 supported")
        if h.n_lcons:
            raise NlReadError("logical constraints not supported")

    # ------------------------------------------------------------- segments
    def _parse_segments(self, src) -> Problem:
        h = self.header
        con_ast: Dict[int, _AST] = {}
        obj_ast: Optional[_AST] = None
        obj_sense = 0
        jac: Dict[int, List[Tuple[int, float]]] = {}
        grad: List[Tuple[int, float]] = []
        var_lb = np.full(h.n_var, -INF)
        var_ub = np.full(h.n_var, INF)
        con_lb = np.full(h.n_con, -INF)
        con_ub = np.full(h.n_con, INF)
        x0: Optional[np.ndarray] = None

        while not src.eof():
            tag, fields = src.segment()
            if tag == "C":
                i = int(fields[0]) if fields else src.read_int()
                con_ast[i] = self._read_expr(src)
            elif tag == "O":
                if fields:
                    obj_sense = int(fields[1]) if len(fields) > 1 else 0
                else:
                    src.read_int()
                    obj_sense = src.read_int()
                obj_ast = self._read_expr(src)
            elif tag == "V":
                if fields:
                    idx, nlin = int(fields[0]), int(fields[1])
                else:
                    idx = src.read_int()
                    nlin = src.read_int()
                    src.read_int()  # k (defining-constraint scope marker)
                lin = [src.read_pair() for _ in range(nlin)]
                self._defined[idx] = (lin, self._read_expr(src))
            elif tag in ("J", "G"):
                if fields:
                    i, k = int(fields[0]), int(fields[1])
                else:
                    i = src.read_int()
                    k = src.read_int()
                entries = [src.read_pair() for _ in range(k)]
                if tag == "J":
                    jac[i] = entries
                else:
                    grad.extend(entries)
            elif tag == "r":
                for i in range(h.n_con):
                    con_lb[i], con_ub[i] = src.read_bound()
            elif tag == "b":
                for i in range(h.n_var):
                    var_lb[i], var_ub[i] = src.read_bound()
            elif tag == "k":
                n = int(fields[0]) if fields else src.read_int()
                for _ in range(n):
                    src.read_int()
            elif tag in ("x", "d"):
                k = int(fields[0]) if fields else src.read_int()
                pairs = [src.read_pair() for _ in range(k)]
                if tag == "x":
                    x0 = np.zeros(h.n_var)
                    for a, b in pairs:
                        x0[a] = b
            elif tag == "S":
                if fields:
                    kind, n, sname = int(fields[0]), int(fields[1]), fields[2]
                else:
                    kind = src.read_int()
                    n = src.read_int()
                    sname = src.read_name()
                is_real = bool(kind & 4)
                table: Dict[int, float] = {}
                for _ in range(n):
                    a, b = src.read_pair() if is_real else src.read_int_pair()
                    table[a] = b
                self.suffixes[(sname, kind & 3)] = table
            elif tag == "F":
                raise NlReadError("imported functions (F segment) not supported")
            elif tag.strip() == "":
                continue
            else:
                raise NlReadError(f"unknown segment: {tag!r}")

        return self._build_problem(h, con_ast, obj_ast, obj_sense, jac, grad,
                                   var_lb, var_ub, con_lb, con_ub, x0)

    # ---------------------------------------------------------- expression
    def _read_expr(self, src) -> _AST:
        tok = src.expr_tok()
        if tok[0] in ("n", "v"):
            return tok
        opnum = tok[1]
        if opnum in ASL_NARY:
            count = src.read_int() if isinstance(src, _BinSrc) else src.read_int()
            children = [self._read_expr(src) for _ in range(count)]
            return ("o", ASL_NARY[opnum], children, 0.0)
        if opnum == ASL_OP2POW:
            return ("o", Op.SQR, [self._read_expr(src)], 0.0)
        if opnum == ASL_OP1POW:
            a = self._read_expr(src)
            k = self._read_expr(src)
            if k[0] != "n":
                raise NlReadError("OP1POW with non-constant exponent")
            return ("o", Op.POWK, [a], float(k[1]))
        if opnum == ASL_OPCPOW:
            c = self._read_expr(src)
            a = self._read_expr(src)
            if c[0] != "n":
                raise NlReadError("OPCPOW with non-constant base")
            return ("o", Op.CPOW, [a], float(c[1]))
        if opnum in ASL_UNARY:
            return ("o", ASL_UNARY[opnum], [self._read_expr(src)], 0.0)
        if opnum in ASL_BINARY:
            a = self._read_expr(src)
            b = self._read_expr(src)
            return ("o", ASL_BINARY[opnum], [a, b], 0.0)
        raise NlReadError(f"unsupported opcode o{opnum}")

    # --------------------------------------------------------------- build
    def _emit(self, ast: _AST, g: ExprGraph, memo: Dict[int, int]) -> int:
        kind = ast[0]
        if kind == "n":
            return g.num(ast[1])
        if kind == "v":
            idx = ast[1]
            if idx < self.header.n_var:
                return g.var(idx)
            # defined (common) variable: inline linear part + expression
            if idx in memo:
                return memo[idx]
            if idx not in self._defined:
                raise NlReadError(f"undefined common expression v{idx}")
            lin, sub = self._defined[idx]
            parts = []
            for v, c in lin:
                if c != 0.0:
                    parts.append(g.node(Op.MULT, g.num(c),
                                        self._emit(("v", v), g, memo)))
            if sub is not None:
                parts.append(self._emit(sub, g, memo))
            node = g.sum_list(parts) if parts else g.num(0.0)
            memo[idx] = node
            return node
        _, op, children, const = ast
        emitted = [self._emit(c, g, memo) for c in children]
        if op is Op.POWK:
            return g.node(Op.POWK, emitted[0], -1, const)
        if op is Op.CPOW:
            return g.node(Op.CPOW, emitted[0], -1, const)
        if len(emitted) == 1:
            return g.node(op, emitted[0])
        if op in (Op.PLUS, Op.MAX2, Op.MIN2):
            return g.nary(op, emitted)
        assert len(emitted) == 2, (op, len(emitted))
        return g.node(op, emitted[0], emitted[1])

    def _resolve_defined(self, ast: _AST) -> _AST:
        """Inline defined variables into an AST (needed before quadratic
        extraction)."""
        kind = ast[0]
        if kind == "n":
            return ast
        if kind == "v":
            idx = ast[1]
            if idx < self.header.n_var:
                return ast
            lin, sub = self._defined[idx]
            children: List[_AST] = []
            for v, c in lin:
                if c != 0.0:
                    children.append(("o", Op.MULT, [("n", c),
                                     self._resolve_defined(("v", v))], 0.0))
            if sub is not None:
                children.append(self._resolve_defined(sub))
            if not children:
                return ("n", 0.0)
            if len(children) == 1:
                return children[0]
            return ("o", Op.PLUS, children, 0.0)
        _, op, ch, const = ast
        return ("o", op, [self._resolve_defined(c) for c in ch], const)

    def _body_from_ast(self, ast: Optional[_AST]):
        """-> (const, LinearFunction-or-None, QuadraticFunction-or-None,
        ExprGraph-or-None)"""
        if ast is None:
            return 0.0, None, None, None
        if ast[0] == "n":
            return float(ast[1]), None, None, None
        ast = self._resolve_defined(ast)
        if self.extract_quadratics:
            try:
                poly = _ast_to_poly(ast)
            except _NotQuad:
                poly = None
            if poly is not None:
                const = poly.pop((), 0.0)
                lf = LinearFunction()
                qf = QuadraticFunction()
                for k, v in poly.items():
                    if len(k) == 1:
                        lf.add_term(k[0], v)
                    else:
                        qf.add_term(k[0], k[1], v)
                return const, (lf if len(lf) else None), \
                    (qf if len(qf) else None), None
        g = ExprGraph()
        g.set_root(self._emit(ast, g, {}))
        return 0.0, None, None, g

    def _var_types(self, h: NlHeader) -> List[VarType]:
        types = [VarType.CONTINUOUS] * h.n_var

        def mark(lo: int, hi: int) -> None:
            for i in range(lo, hi):
                types[i] = VarType.INTEGER

        # integer sub-blocks sit at the end of each nonlinear block
        mark(h.nlvb - h.nlvbi, h.nlvb)
        mark(h.nlvc - h.nlvci, h.nlvc)
        if h.nlvo > h.nlvc:
            mark(h.nlvo - h.nlvoi, h.nlvo)
        elif h.nlvoi:
            n_nl = max(h.nlvc, h.nlvo)
            mark(n_nl - h.nlvoi, n_nl)
        # linear blocks: [n - nbv - niv, n - niv) binary, [n - niv, n) integer
        for i in range(h.n_var - h.nbv - h.niv, h.n_var - h.niv):
            types[i] = VarType.BINARY
        mark(h.n_var - h.niv, h.n_var)
        return types

    def _build_problem(self, h, con_ast, obj_ast, obj_sense, jac, grad,
                       var_lb, var_ub, con_lb, con_ub, x0) -> Problem:
        p = Problem(h.name)
        types = self._var_types(h)
        for i in range(h.n_var):
            vt = types[i]
            lb, ub = var_lb[i], var_ub[i]
            if vt == VarType.INTEGER and lb >= 0.0 and ub <= 1.0:
                vt = VarType.BINARY
            p.new_variable(lb, ub, vt, f"x{i}")

        for i in range(h.n_con):
            lf = LinearFunction()
            for v, c in jac.get(i, []):
                if c != 0.0:
                    lf.add_term(v, c)
            const, qlf, qf, nlf = self._body_from_ast(con_ast.get(i))
            if qlf is not None:
                for v, c in qlf:
                    lf.add_term(v, c)
            lo, up = con_lb[i], con_ub[i]
            if const != 0.0:
                lo = lo - const if lo > -INF else lo
                up = up - const if up < INF else up
            p.new_constraint(Function(lf=lf, qf=qf, nlf=nlf), lo, up, f"c{i}")

        olf = LinearFunction()
        for v, c in grad:
            if c != 0.0:
                olf.add_term(v, c)
        oconst, oqlf, oqf, onlf = self._body_from_ast(obj_ast)
        if oqlf is not None:
            for v, c in oqlf:
                olf.add_term(v, c)
        sense = ObjectiveType.MAXIMIZE if obj_sense else ObjectiveType.MINIMIZE
        p.new_objective(Function(lf=olf, qf=oqf, nlf=onlf), oconst, sense)

        if x0 is not None:
            p.initial_point = x0
        self._attach_sos(p)
        return p

    def _attach_sos(self, p: Problem) -> None:
        """SOS sets arrive as 'sosno'/'ref' suffixes on variables."""
        sosno = self.suffixes.get(("sosno", 0))
        ref = self.suffixes.get(("ref", 0))
        if not sosno:
            return
        groups: Dict[int, List[int]] = {}
        for v, s in sosno.items():
            groups.setdefault(int(s), []).append(v)
        for s, vs in sorted(groups.items()):
            weights = [float(ref.get(v, i)) if ref else float(i)
                       for i, v in enumerate(vs)]
            order = np.argsort(weights)
            entry = ([weights[i] for i in order], [vs[i] for i in order])
            if s > 0:
                p._sos1.append(entry)
            else:
                p._sos2.append(entry)


def read_nl(path: str, extract_quadratics: bool = True) -> Problem:
    return NlReader(extract_quadratics=extract_quadratics).read(path)
