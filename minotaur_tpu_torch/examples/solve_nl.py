"""Example: read a .nl instance and solve it with batched B&B.

    python -m minotaur_tpu_torch.examples.solve_nl instance.nl
"""

import sys

from minotaur_tpu_torch.bnb.bnb import BranchAndBound
from minotaur_tpu_torch.io.nl_reader import read_nl
from minotaur_tpu_torch.utils.environment import Environment


def main(path, device="cuda"):
    p = read_nl(path)
    print(p)
    env = Environment()
    env.set_option("node_batch", 32)
    env.set_option("bnb_time_limit", 300)
    bab = BranchAndBound(p, env, device=device)
    status = bab.solve()
    print(f"{status.name}: ub={bab.ub:.8g} lb={bab.lb:.8g} "
          f"nodes={bab.stats.nodes_processed} in {bab.stats.time:.1f}s")
    if bab.best_x is not None:
        print("x* =", bab.best_x)
    return bab


if __name__ == "__main__":
    main(sys.argv[1])
