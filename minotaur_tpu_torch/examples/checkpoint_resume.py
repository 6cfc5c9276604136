"""Example: checkpoint a B&B run and resume it.

The reference has no checkpointing (SURVEY.md section 5 flags it as a
gap to fill); the dense node representation makes it cheap here: the
open pool is a pair of bound matrices.

    python -m minotaur_tpu_torch.examples.checkpoint_resume instance.nl
"""

import os
import sys
import tempfile

from minotaur_tpu_torch.bnb.bnb import BranchAndBound
from minotaur_tpu_torch.bnb.checkpoint import save_checkpoint
from minotaur_tpu_torch.io.nl_reader import read_nl
from minotaur_tpu_torch.utils.environment import Environment


def main(path, log_level=3, device="cuda"):
    with tempfile.TemporaryDirectory() as tmp:
        ckpt = os.path.join(tmp, "bnb.ckpt")

        # phase 1: stop early on a node budget, checkpointing as we go
        env = Environment()
        env.set_option("node_batch", 4)
        env.set_option("bnb_node_limit", 3)
        env.set_option("checkpoint_file", ckpt)
        env.set_option("checkpoint_interval", 0.0)   # every superstep
        env.set_option("log_level", log_level)
        bab = BranchAndBound(read_nl(path), env, device=device)
        st1 = bab.solve()
        print(f"phase 1: {st1.name} nodes={bab.stats.nodes_processed} "
              f"open={len(bab.tm)} -> {ckpt}")
        save_checkpoint(ckpt, bab)

        # phase 2: resume and finish
        env2 = Environment()
        env2.set_option("node_batch", 4)
        env2.set_option("checkpoint_file", ckpt)
        env2.set_option("resume", True)
        env2.set_option("log_level", log_level)
        bab2 = BranchAndBound(read_nl(path), env2, device=device)
        st2 = bab2.solve()
        print(f"phase 2: {st2.name} ub={bab2.ub:.8g} "
              f"nodes={bab2.stats.nodes_processed}")
    return bab2


if __name__ == "__main__":
    main(sys.argv[1])
