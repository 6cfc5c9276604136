"""Engine factory (reference: src/base/EngineFactory.{h,cpp}:74-140).

The reference picks among Osi/Cbc/Cplex/Ipopt/FilterSQP/Bqpd/qpOASES via
the lp_engine/qp_engine/nlp_engine/milp_engine options and compile-time
flags.  Here every class maps to the one batched IPM with a per-problem
static configuration, so the factory's job reduces to validating the
option and building the right solver over the staged problem.

Port of minotaur_tpu/engines/factory.py: the solvers are built on the
factory's device (`device=`, default "cuda").
"""

from __future__ import annotations

from typing import Callable, Optional

from ..ir.problem import Problem
from ..utils.environment import Environment
from ..utils.types import FunctionType, ProblemType
from .ipm import IPMOptions, build_batch_solver
from .staging import StagedProblem, stage_problem


class EngineFactory:
    def __init__(self, env: Optional[Environment] = None, device="cuda"):
        self.env = env or Environment()
        self.device = device

    def _ipm_options(self) -> IPMOptions:
        o = self.env.options
        return IPMOptions(max_iters=int(o.get("ipm_max_iters")),
                          tol=float(o.get("ipm_tol")))

    def _check(self, name: str) -> None:
        val = self.env.options.get(name)
        if val not in ("ipm", "", "auto"):
            raise ValueError(
                f"{name}={val!r}: only the batched IPM engine exists in "
                "this framework (the reference's external engines have no "
                "TPU equivalent)")

    def get_lp_engine(self, sp: StagedProblem) -> Callable:
        self._check("lp_engine")
        return build_batch_solver(sp, self._ipm_options(), self.device)

    def get_qp_engine(self, sp: StagedProblem) -> Callable:
        self._check("qp_engine")
        return build_batch_solver(sp, self._ipm_options(), self.device)

    def get_nlp_engine(self, sp: StagedProblem) -> Callable:
        self._check("nlp_engine")
        return build_batch_solver(sp, self._ipm_options(), self.device)

    def get_engine(self, problem: Problem,
                   staged: Optional[StagedProblem] = None) -> Callable:
        """Auto-select like Bnb::getEngine_ (reference Bnb.cpp:218-255:
        LP -> QP -> NLP fallthrough)."""
        sp = staged or stage_problem(problem)
        ptype = problem.find_type()
        if ptype in (ProblemType.LP, ProblemType.MILP):
            return self.get_lp_engine(sp)
        if ptype in (ProblemType.QP, ProblemType.MIQP):
            return self.get_qp_engine(sp)
        return self.get_nlp_engine(sp)
