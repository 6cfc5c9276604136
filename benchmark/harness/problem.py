"""The one adapter from a generated instance to the port's Problem."""

from __future__ import annotations

import numpy as np


def to_problem(inst: dict):
    from minotaur_tpu_torch.ir.functions import (Function, LinearFunction,
                                                 QuadraticFunction)
    from minotaur_tpu_torch.ir.problem import Problem
    from minotaur_tpu_torch.utils.types import VarType
    kinds = {"C": VarType.CONTINUOUS, "I": VarType.INTEGER,
             "B": VarType.BINARY}
    p = Problem(inst["name"])
    for j, (lo, hi, vt) in enumerate(zip(inst["lb"], inst["ub"],
                                         inst["vtype"])):
        p.new_variable(float(lo), float(hi), kinds[vt], f"x{j}")
    for r, (row, lo, hi) in enumerate(zip(inst["A"], inst["rlo"],
                                          inst["rhi"])):
        nzr = np.nonzero(row)[0]
        p.new_constraint(Function(lf=LinearFunction(
            {int(j): float(row[j]) for j in nzr})), float(lo), float(hi),
            f"r{r}")
    qf = QuadraticFunction()
    for i, j, v in zip(inst["qi"], inst["qj"], inst["qv"]):
        qf.add_term(int(i), int(j), float(v))
    lf = LinearFunction({j: float(v) for j, v in enumerate(inst["c"])
                         if v != 0.0})
    p.new_objective(Function(lf=lf, qf=qf), const=float(inst["const"]))
    return p
