"""Example: building and using the expression DAG directly.

Reference analogue: examples/cguseqflf (hand-built CGraph, eval +
derivatives) — here the DAG stages to torch code for eval/grad and to
the interval engine for FBBT, the two roles CGraph plays in the
reference (CGraph.h:54-71,198).

    python -m minotaur_tpu_torch.examples.expr_dag_demo
"""

import numpy as np
import torch

from minotaur_tpu_torch.device import F64, resolve_device
from minotaur_tpu_torch.ir.expr import ExprGraph
from minotaur_tpu_torch.ops.interval import stage_fbbt
from minotaur_tpu_torch.ops.opcodes import Op
from minotaur_tpu_torch.ops.stage import stage_scalar


def main(log=True, device="cuda"):
    dev = resolve_device(device)
    t = lambda v: torch.tensor(v, dtype=F64, device=dev)  # noqa: E731

    # f(x) = exp(0.5 x0) + x1 * sqrt(x2) - x0 * x1
    g = ExprGraph()
    t_exp = g.node(Op.EXP, g.node(Op.MULT, g.num(0.5), g.var(0)))
    t_mix = g.node(Op.MULT, g.var(1), g.node(Op.SQRT, g.var(2)))
    t_bil = g.node(Op.MULT, g.var(0), g.var(1))
    g.set_root(g.node(Op.MINUS, g.node(Op.PLUS, t_exp, t_mix), t_bil))

    f = stage_scalar(g)
    x = t([1.0, 2.0, 4.0])
    val = float(f(x))
    grad = torch.func.grad(f)(x).cpu().numpy()
    expected = np.exp(0.5) + 2 * 2.0 - 2.0
    if abs(val - expected) >= 1e-12:
        raise ValueError(f"f(1,2,4) = {val}, expected {expected}")

    # batched evaluation over lanes (how node batches use the DAG)
    xs = torch.stack([x, 2 * x, 3 * x])
    vals = torch.func.vmap(f)(xs).cpu().numpy()

    # interval FBBT: impose f(x) <= 3 on the box [0,2]x[0,2]x[1,4]
    fb = stage_fbbt(g, 3)
    nlo, nhi, infeas = fb(t([0.0, 0.0, 1.0]), t([2.0, 2.0, 4.0]),
                          t(-np.inf), t(3.0))
    nlo, nhi = nlo.cpu().numpy(), nhi.cpu().numpy()
    if log:
        print(f"f(1,2,4) = {val:.12g}   grad = {grad}")
        print(f"batch vals = {vals}")
        print(f"FBBT under f<=3:  lo {nlo}  hi {nhi}  "
              f"infeasible={bool(infeas)}")
    return val, grad, (nlo, nhi)


if __name__ == "__main__":
    main()
