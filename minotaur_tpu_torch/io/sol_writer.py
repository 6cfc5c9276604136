"""AMPL .sol file writer.

Reference: the ASL-side writer used via AMPLInterface (writeSolution);
format per ASL conventions: message text, Options block, dual values,
primal values, objno line.
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np


def write_sol(path: str, message: str, x: Optional[np.ndarray],
              duals: Optional[np.ndarray] = None,
              solve_result_num: int = 0) -> None:
    with open(path, "w") as fh:
        fh.write(message.rstrip("\n") + "\n\n")
        fh.write("Options\n3\n1\n1\n0\n")
        nd = 0 if duals is None else len(duals)
        nx = 0 if x is None else len(x)
        fh.write(f"{nd} {nd}\n{nx} {nx}\n")
        if duals is not None:
            for v in duals:
                fh.write(f"{v:.17g}\n")
        if x is not None:
            for v in x:
                fh.write(f"{v:.17g}\n")
        fh.write(f"objno 0 {solve_result_num}\n")
