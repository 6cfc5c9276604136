"""Example: swapping branching rules (simbranch analogue).

Reference analogue: examples/simbranch — a demo app that plugs a custom
brancher into B&B.  Here branchers are selected by option (the same way
Bnb.cpp:174-215 dispatches on `brancher`); the demo runs one model under
three rules and compares tree sizes.

    python -m minotaur_tpu_torch.examples.custom_brancher
"""

from minotaur_tpu_torch.bnb.bnb import BranchAndBound
from minotaur_tpu_torch.models.generators import quadratic_knapsack
from minotaur_tpu_torch.utils.environment import Environment


def main(node_batch=8, log=True, device="cuda"):
    results = {}
    for rule in ("maxvio", "lexico", "random"):
        p = quadratic_knapsack(n=10, seed=3)
        env = Environment()
        env.set_option("brancher", rule)
        env.set_option("node_batch", node_batch)
        env.set_option("log_level", 1)
        env.set_option("bnb_node_limit", 4000)
        bab = BranchAndBound(p, env, device=device)
        bab.solve()
        results[rule] = (bab.ub, bab.stats.nodes_processed)
        if log:
            print(f"{rule:8s}: ub {bab.ub:.8g}  nodes "
                  f"{bab.stats.nodes_processed}")
    return results


if __name__ == "__main__":
    main()
