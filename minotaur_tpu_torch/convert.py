"""Carry staged state across from the JAX package.

`staged_from_numpy` builds the port's `StagedProblem` from the numpy
fields of a JAX `StagedProblem` (or of any dict with the same names), so
that both packages can be fed the same staged problem.  Only the LP/QP
slice is accepted: nonlinear rows or a nonlinear objective raise.
"""

from __future__ import annotations

from typing import Mapping

import numpy as np

from .engines.staging import StagedProblem

FIELDS = ("n", "m", "c", "obj_const", "Qobj", "A", "clb", "cub", "vlb",
          "vub", "int_mask", "nl_rows")


def staged_fields(sp) -> dict:
    """The numpy fields of a staged problem (either package) as a dict."""
    return {f: getattr(sp, f) for f in FIELDS}


def staged_from_numpy(fields: Mapping, name: str = "staged") -> StagedProblem:
    """Port StagedProblem from numpy fields (copies every array)."""
    nl_rows = np.asarray(fields.get("nl_rows", ()), dtype=np.int32)
    if len(nl_rows) or fields.get("obj_nl") is not None:
        raise NotImplementedError(
            "nonlinear rows / nonlinear objective: not yet ported, see "
            "ROADMAP.md")
    n, m = int(fields["n"]), int(fields["m"])
    f64 = lambda a: np.array(a, dtype=np.float64)  # noqa: E731
    Q = fields.get("Qobj")
    sp = StagedProblem(
        name=str(fields.get("name", name)), n=n, m=m, c=f64(fields["c"]),
        obj_const=float(fields["obj_const"]),
        Qobj=None if Q is None else f64(Q), obj_nl=None,
        A=f64(fields["A"]).reshape(m, n), clb=f64(fields["clb"]),
        cub=f64(fields["cub"]), vlb=f64(fields["vlb"]),
        vub=f64(fields["vub"]),
        int_mask=np.array(fields["int_mask"], dtype=bool),
        nl_rows=nl_rows, con_nl=None, nl_graphs=[])
    for nm, v, shape in (("c", sp.c, (n,)), ("clb", sp.clb, (m,)),
                         ("cub", sp.cub, (m,)), ("vlb", sp.vlb, (n,)),
                         ("vub", sp.vub, (n,)), ("int_mask", sp.int_mask, (n,))):
        if v.shape != shape:
            raise ValueError(f"staged_from_numpy: {nm} has shape {v.shape}, "
                             f"expected {shape}")
    if sp.Qobj is not None and sp.Qobj.shape != (n, n):
        raise ValueError("staged_from_numpy: Qobj must be (n, n)")
    return sp
