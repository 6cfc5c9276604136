"""A/B of the node processors: `nodeproc pcb` against `nodeproc qpd`.

Port of scripts/ab_qpd.py.  The QPD node processor (reference
QPDProcessor.{h,cpp}) solves each node batch on a PSD-projected QP model
and re-solves on the true model every lane whose QP result would prune
the node or accept an incumbent.  This harness solves each case under
both processors (node_batch 8, node limit 4000) and prints status,
nodes, wall seconds, ub, lb and the count of lanes verified on the true
model:

- nvs08: read from `--nvs08 PATH` when that file exists; otherwise the
  in-repo stand-in batchdes_a (`models/convex_suite.py::batchdes_like`:
  integer unit counts, exp rows, an exact oracle).  QPD is active only
  on a model with nonlinear rows: a quadratic objective alone is
  already a QP (scripts/AB_QPD.md, "Reading"), so the stand-in has them;
- qknap12 and qknap16: quadratic knapsacks (quadratic objective only,
  so QPD stays inactive and the two processors run the same search).

    python -m minotaur_tpu_torch.tools.ab_qpd [--device cuda|cpu] \\
        [--nvs08 PATH]
"""

from __future__ import annotations

import argparse
import os
import time
from typing import Callable, Dict, List, Optional

PROCS = ("pcb", "qpd")
STAND_IN = "batchdes_a"


def run(problem_factory: Callable, nodeproc: str, node_limit: int = 4000,
        batch: int = 8, device="cuda") -> dict:
    """Solve problem_factory() under `nodeproc`; the JAX script's dict."""
    from ..bnb.bnb import BranchAndBound
    from ..utils.environment import Environment
    env = Environment()
    env.set_option("log_level", 0)
    env.set_option("nodeproc", nodeproc)
    env.set_option("node_batch", batch)
    env.set_option("bnb_node_limit", node_limit)
    bab = BranchAndBound(problem_factory(), env, device=device)
    t0 = time.monotonic()
    st = bab.solve()
    dt = time.monotonic() - t0
    return dict(status=st.name, nodes=bab.stats.nodes_processed,
                wall=round(dt, 2), ub=round(bab.ub, 6), lb=round(bab.lb, 6),
                qpd_verified=bab._qpd_verified)


def cases(nvs08: Optional[str] = None) -> Dict[str, Callable]:
    """name -> problem factory; nvs08 falls back to the stand-in, named
    `batchdes_a (stand-in for nvs08)`."""
    from ..io.nl_reader import read_nl
    from ..models.convex_suite import SUITE
    from ..models.generators import quadratic_knapsack
    if nvs08 and os.path.isfile(nvs08):
        first = {"nvs08": lambda: read_nl(nvs08)}
    else:
        first = {f"{STAND_IN} (stand-in for nvs08)": SUITE[STAND_IN][0]}
    return {**first,
            "qknap12": lambda: quadratic_knapsack(12, density=0.4, seed=3),
            "qknap16": lambda: quadratic_knapsack(16, density=0.3, seed=1)}


def main(argv=None) -> List[dict]:
    ap = argparse.ArgumentParser(
        prog="python -m minotaur_tpu_torch.tools.ab_qpd",
        description=__doc__.split("\n")[0])
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    ap.add_argument("--nvs08", default=None,
                    help="path of nvs08.nl (default: the stand-in)")
    args = ap.parse_args(argv)
    from ..bench import card_name
    from ..device import resolve_device
    dev = resolve_device(args.device)
    print(f"card: {card_name(dev)}", flush=True)
    print(f"{'instance':36s} {'proc':4s} {'status':22s} {'nodes':>7s} "
          f"{'wall':>8s} {'ub':>12s} {'lb':>12s} {'verified':>8s}")
    rows = []
    for name, mk in cases(args.nvs08).items():
        for proc in PROCS:
            r = dict(instance=name, proc=proc, **run(mk, proc, device=dev))
            rows.append(r)
            print(f"{name:36s} {proc:4s} {r['status']:22s} "
                  f"{r['nodes']:7d} {r['wall']:8.2f} {r['ub']:12.6g} "
                  f"{r['lb']:12.6g} {r['qpd_verified']:8d}", flush=True)
    return rows


if __name__ == "__main__":
    main()
