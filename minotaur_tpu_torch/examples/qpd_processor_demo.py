"""Example: QPD node PROCESSOR (reference QPDProcessor.cpp as a node
processor, not just a heuristic).

`--nodeproc qpd` processes every B&B node on a PSD-projected QP model of
the MINLP — one batched QP superstep per batch of nodes — and re-solves
any lane whose QP result would PRUNE the node or ACCEPT an incumbent on
the TRUE model first, so every decision stays sound while most node
work runs on the cheap quadratic approximation.

    python -m minotaur_tpu_torch.examples.qpd_processor_demo instance.nl
"""

import sys

from minotaur_tpu_torch.bnb.bnb import BranchAndBound
from minotaur_tpu_torch.io.nl_reader import read_nl
from minotaur_tpu_torch.utils.environment import Environment


def main(path, log=True, device="cuda"):
    p = read_nl(path)
    env = Environment()
    env.set_option("nodeproc", "qpd")
    env.set_option("node_batch", 16)
    env.set_option("bnb_node_limit", 800)
    env.set_option("bnb_time_limit", 240)
    env.set_option("log_level", 2 if log else 1)
    bab = BranchAndBound(p, env, device=device)
    st = bab.solve()
    if log:
        print(f"status {st.name}  ub {bab.ub:.8g}  "
              f"true-model verifications {bab._qpd_verified}")
    return st, bab.ub, bab._qpd_verified


if __name__ == "__main__":
    main(sys.argv[1])
