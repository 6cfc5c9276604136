"""Solve-to-gap sweep over a directory or glob of .nl files.

Port of scripts/run_sweep.py (reference: scripts/minlp-test.py, a solver
binary over an instance directory against a solutions CSV under a time
limit).  Each instance is read with the port's `io/nl_reader.py` and
solved by `BranchAndBound` (`mbnb`), `QGBranchAndBound` (`mqg`) or
`OABranchAndBound` (`moa`) on the chosen device:

    python -m minotaur_tpu_torch.tools.run_sweep INSTANCE_DIR_OR_GLOB \\
        [--solver mbnb|mqg|moa] [--time 60] [--nodes N] \\
        [--out results.csv] [--solutions known.csv] [--options "k=v,..."] \\
        [--device cuda|cpu]

Writes one CSV row per instance (the JAX script's columns): instance,
status, ub, lb, gap, nodes, wall_s and, where the solutions file (rows
of `name,objective`) knows the instance, dev_from_known = ub - known.  A
solve that raises is written as status `ERROR:<type>` with its traceback
on stderr, and the process then exits 1 (the JAX script exits 0).
"""

from __future__ import annotations

import argparse
import csv
import glob
import importlib
import os
import sys
import time
import traceback
from typing import Dict, List, Sequence

SOLVERS = {
    "mbnb": ("minotaur_tpu_torch.bnb.bnb", "BranchAndBound"),
    "mqg": ("minotaur_tpu_torch.bnb.qg", "QGBranchAndBound"),
    "moa": ("minotaur_tpu_torch.bnb.oa", "OABranchAndBound"),
}
COLUMNS = ("instance", "status", "ub", "lb", "gap", "nodes", "wall_s",
           "dev_from_known")


def read_solutions(path: str) -> Dict[str, float]:
    """name -> known objective from a CSV of `name,objective` rows; rows
    whose second field is not a number (a header) are skipped."""
    known = {}
    with open(path) as fh:
        for row in csv.reader(fh):
            if len(row) >= 2:
                try:
                    known[row[0].strip()] = float(row[1])
                except ValueError:
                    pass
    return known


def instance_paths(spec: str) -> List[str]:
    """The .nl files of a directory, or the matches of a glob, sorted."""
    if os.path.isdir(spec):
        return sorted(glob.glob(os.path.join(spec, "*.nl")))
    return sorted(glob.glob(spec))


def parse_options(text: str) -> List[tuple]:
    """"k=v,k2=v2" -> [(k, v), (k2, v2)]."""
    out = []
    for kv in filter(None, text.split(",")):
        k, v = kv.split("=", 1)
        out.append((k.strip(), v.strip()))
    return out


def sweep(paths: Sequence[str], solver: str = "mbnb", time_limit=60.0,
          node_limit: int = 10 ** 7, options: Sequence = (),
          known: Dict[str, float] = None, device="cuda") -> List[list]:
    """Solve each path; returns one row per instance in COLUMNS order
    (ub, lb, gap and wall formatted as the JAX script writes them)."""
    from ..device import resolve_device
    from ..io.nl_reader import read_nl
    from ..utils.environment import Environment

    dev = resolve_device(device)
    mod_name, cls_name = SOLVERS[solver]
    cls = getattr(importlib.import_module(mod_name), cls_name)
    known = known or {}
    rows = []
    for path in paths:
        name = os.path.basename(path).rsplit(".", 1)[0]
        env = Environment()
        env.set_option("bnb_time_limit", time_limit)
        env.set_option("bnb_node_limit", node_limit)
        env.set_option("log_level", 1)
        for k, v in options:
            env.set_option(k, v)
        t0 = time.monotonic()
        try:
            bab = cls(read_nl(path), env=env, device=dev)
            status = bab.solve().name
            ub, lb = bab.ub, bab.lb
            nodes = bab.stats.nodes_processed
        except Exception as e:
            traceback.print_exc()
            status, ub, lb, nodes = f"ERROR:{type(e).__name__}", \
                float("inf"), float("-inf"), 0
        wall = time.monotonic() - t0
        gap = (ub - lb) / max(abs(ub), 1e-10) if ub < 1e19 and lb > -1e19 \
            else float("inf")
        dev_known = ub - known[name] if name in known else ""
        rows.append([name, status, f"{ub:.10g}", f"{lb:.10g}",
                     f"{gap:.3e}", nodes, f"{wall:.1f}", dev_known])
        print(f"{name:24s} {status:22s} ub={ub:<14.8g} gap={gap:.2e} "
              f"nodes={nodes:<7d} {wall:.1f}s", flush=True)
    return rows


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m minotaur_tpu_torch.tools.run_sweep",
        description=__doc__.split("\n")[0])
    ap.add_argument("instances")
    ap.add_argument("--solver", default="mbnb", choices=sorted(SOLVERS))
    ap.add_argument("--time", type=float, default=60.0)
    ap.add_argument("--nodes", type=int, default=10 ** 7)
    ap.add_argument("--out", default="sweep_results.csv")
    ap.add_argument("--solutions", default="")
    ap.add_argument("--options", default="",
                    help="extra options, comma-separated name=value")
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    args = ap.parse_args(argv)

    from ..bench import card_name
    from ..device import resolve_device
    dev = resolve_device(args.device)
    known = read_solutions(args.solutions) if args.solutions else {}
    paths = instance_paths(args.instances)
    if not paths:
        print(f"no instances match {args.instances}", file=sys.stderr)
        return 1
    print(f"card: {card_name(dev)}", flush=True)
    rows = sweep(paths, args.solver, args.time, args.nodes,
                 parse_options(args.options), known, dev)
    with open(args.out, "w", newline="") as fh:
        w = csv.writer(fh)
        w.writerow(COLUMNS)
        w.writerows(rows)
    print(f"wrote {args.out}")
    errors = [r[0] for r in rows if r[1].startswith("ERROR:")]
    if errors:
        print(f"run_sweep: {len(errors)} instance(s) raised: {errors}",
              file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
