"""Example: read a .nl instance, write it back, re-read, compare.

Reference analogue: examples/nlwriter (NlWriter demo).

    python -m minotaur_tpu_torch.examples.nl_roundtrip instance.nl
"""

import os
import sys
import tempfile

import numpy as np

from minotaur_tpu_torch.io.nl_reader import read_nl
from minotaur_tpu_torch.io.nl_writer import write_nl


def main(path):
    p = read_nl(path)
    print("read:", p)
    with tempfile.NamedTemporaryFile(suffix=".nl", delete=False) as f:
        out = f.name
    try:
        write_nl(p, out)
        p2 = read_nl(out)
    finally:
        os.unlink(out)
    print("round-tripped:", p2)
    x = np.where(np.isfinite(p.var_bounds()[0]),
                 np.nan_to_num(p.var_bounds()[0]), 0.0) + 0.25
    f1 = p.eval_objective(x)
    f2 = p2.eval_objective(x)
    print(f"objective at a probe point: {f1:.8g} vs {f2:.8g}")
    if abs(f1 - f2) >= 1e-8:
        raise ValueError(f"round trip changed the objective: {f1} vs {f2}")
    return p2


if __name__ == "__main__":
    main(sys.argv[1])
