"""Example: bilinear program via McCormick relaxations (bilinear analogue).

Reference analogue: examples/bilinear — relax bilinear terms y = x1*x2
with their convex envelopes and branch on the spatial variables.  Here
the transformer registers each term once (LinBil-style dedup), the
envelopes are computed from each node box inside the superstep, and
spatial branching happens inside the fused superstep.

    python -m minotaur_tpu_torch.examples.bilinear_demo
"""

from minotaur_tpu_torch.glob.glob_bnb import GlobBranchAndBound
from minotaur_tpu_torch.models.generators import bilinear_pooling
from minotaur_tpu_torch.utils.environment import Environment


def main(node_batch=8, log=True, device="cuda"):
    p = bilinear_pooling(n_pairs=3, seed=0)
    env = Environment()
    env.set_option("node_batch", node_batch)
    env.set_option("log_level", 1)
    env.set_option("bnb_node_limit", 3000)
    bab = GlobBranchAndBound(p, env, device=device)
    status = bab.solve()
    if log:
        print(f"{status.name}: ub={bab.ub:.8g} lb={bab.lb:.8g} "
              f"nodes={bab.nodes_processed}")
    return bab


if __name__ == "__main__":
    main()
