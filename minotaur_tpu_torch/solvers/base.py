"""Solver application base.

Port of minotaur_tpu/solvers/base.py (reference: src/solvers/Solver.{h,cpp}
— readProblem dispatch by file extension (.nl / .mps, Solver.h:37-40),
option handling, solution writeback).  The device the solve runs on is
named by the caller: `Solver(device=...)`, default "cuda".
"""

from __future__ import annotations

import os
import sys
from typing import List, Optional

import torch

import numpy as np

from ..ir.problem import Problem
from ..io.mps_reader import read_mps
from ..io.nl_reader import read_nl
from ..io.sol_writer import write_sol
from ..utils.environment import Environment
from ..utils.types import LogLevel, SolveStatus


class Solver:
    """Common plumbing for the CLI solver apps (mbnb/mqg/mglob/...)."""

    name = "solver"
    usage = "instance.nl [--option value ...]"

    def __init__(self, env: Optional[Environment] = None, device="cuda"):
        self.env = env or Environment()
        self.device = torch.device(device)
        self.problem: Optional[Problem] = None
        self.instance_path: Optional[str] = None

    def read_problem(self, path: str) -> Problem:
        """(reference: Solver::readProblem)"""
        if path.endswith(".mps"):
            p = read_mps(path)
        elif path.endswith(".gms") or path.endswith(".gdx"):
            from ..io.gams_reader import read_gams
            p = read_gams(path)    # stub, like the reference's
        else:
            p = read_nl(path)
        self.problem = p
        self.instance_path = path
        dbg = self.env.options.get("debug_sol")
        if dbg:
            p.debug_sol = np.loadtxt(dbg).reshape(-1)
            if not p.is_debug_sol_feas():
                self.env.logger.error(
                    "debug_sol is infeasible for the parsed problem!")
        return p

    def parse_args(self, argv: List[str]) -> str:
        if any(a in ("-h", "--help", "-?") for a in argv):
            self.write_help()
            sys.exit(0)
        positional = self.env.read_options(argv)
        if self.env.options.get("problem_file"):
            return self.env.options.get("problem_file")
        if not positional:
            self.write_help()
            sys.exit(1)
        return positional[0]

    def write_help(self) -> None:
        out = sys.stdout
        out.write(f"usage: {self.name} {self.usage}\n\noptions:\n")
        self.env.options.write_help(out.write)

    def write_solution(self, status: SolveStatus, obj: float,
                       x: Optional[np.ndarray], duals=None) -> None:
        log = self.env.logger
        log.info(f"status: {status.name}")
        if x is not None:
            log.info(f"best objective: {obj:.10g}")
        if self.env.options.get("write_sol_file") and self.instance_path:
            # write into the current directory, NOT next to the instance
            # (instance trees are often read-only)
            base = os.path.basename(self.instance_path).rsplit(".", 1)[0]
            sol_path = os.path.join(os.getcwd(), base + ".sol")
            msg = f"{self.name}: {status.name}, objective {obj:.10g}"
            write_sol(sol_path, msg, x, duals,
                      solve_result_num=0 if "OPTIMAL" in status.name else 200)
            log.info(f"solution written to {sol_path}")

    # subclasses implement solve()
    def main(self, argv: Optional[List[str]] = None) -> int:
        argv = sys.argv[1:] if argv is None else argv
        path = self.parse_args(argv)
        self.env.logger.info(self.env.version_string() + f" ({self.name})")
        self.read_problem(path)
        if self.env.options.get("display_size"):
            self.problem.write_size(self.env.logger.msg_stream(
                LogLevel.INFO).write)
        if not self.env.options.get("solve"):
            return 0
        return self.solve()

    def solve(self) -> int:  # pragma: no cover - abstract
        raise NotImplementedError
