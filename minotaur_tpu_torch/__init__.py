"""minotaur_tpu_torch: the PyTorch/CUDA port of minotaur_tpu.

The JAX package `minotaur_tpu` is the reference; this package keeps its
module paths and public names (`engines.ipm.build_batch_solver`,
`bnb.step.build_node_step`, `bnb.bnb.BranchAndBound`, ...) so each
counterpart is easy to find.  It imports torch and numpy and never jax.

Ported so far: the LP/QP branch-and-bound main path (staging, linear
FBBT, the batched Mehrotra IPM, the node superstep and the
reliability-branching host loop), with the two TPU kernels of that path
rewritten as CUDA kernels for Hopper (`ops/spd_inverse.py`,
`ops/spd_solve.py`, sources in `csrc/`); the NL relaxation path; and
the QG/OA path (`bnb/qg.py`, `bnb/oa.py`, root linearizations, the
pump, the dives and multistart) with its solver entry points; and every
other option of `mbnb` (the C++ node store in `native/`, checkpoints,
SOS, the weak brancher, OBBT, the f32 light phase, Gondzio correctors,
the QPD node processor, the root heuristics) with the sweep harness
`tools/sweep.py`.  What is left (global, multi-device, the
device-resident node pool behind `device_tree`) is listed in ROADMAP.md;
`device_tree` raises NotImplementedError.
"""

from . import utils  # noqa: F401

__version__ = "0.1.0"
