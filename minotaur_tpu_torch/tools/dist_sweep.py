"""Distributed-QG scaling sweep over partition counts.

Port of scripts/dist_sweep.py, which mirrors the reference's MPI
scaling protocol (scripts/mpi_test.sh:5-25: mpirun -np {2,4,...,P} per
instance with -tree_search=bfs).  For each partition count P in
{1, 2, 4, ..., --max-parts}, each instance is solved by
`DistQGBranchAndBound` (parallel/dist_bnb.py) with partition i on
device i % len(devices), and one CSV row reports nodes/s, wall time,
rebalances, migrated nodes and the per-partition node counts (the
per-rank accounting of MpiBranchAndBound.cpp:408-436).

The devices are every card (cuda:0 .. cuda:N-1) under `--device cuda`,
the CPU under `--device cpu`, or the comma-separated list `--devices`.
Where P exceeds the distinct devices, partitions share a device (on a
one-card machine all of them share the card; partitions run one after
another, parallel/pool.py).  `--max-parts` defaults to the larger of 4
and the device count.  Instances are .nl paths (the JAX script also
searched the reference's instance directories by name).

    python -m minotaur_tpu_torch.tools.dist_sweep a.nl [b.nl ...] \\
        [--max-parts 4] [--time 120] [--node-batch 32] [--out sweep.csv] \\
        [--device cuda|cpu] [--devices cuda:0,cuda:1]
"""

from __future__ import annotations

import argparse
import csv
import os
import sys
import time
from typing import List, Sequence

HEADER = ("instance", "parts", "status", "nodes", "wall_s", "nodes_per_s",
          "ub", "lb", "rebalances", "migrated", "per_part_nodes")


def log(msg):
    print(msg, file=sys.stderr, flush=True)


def default_devices(device="cuda") -> List[str]:
    """Every card under "cuda", ["cpu"] under "cpu"."""
    import torch
    from ..device import resolve_device
    dev = resolve_device(device)
    if dev.type == "cpu":
        return ["cpu"]
    return [f"cuda:{i}" for i in range(torch.cuda.device_count())]


def part_counts(max_parts: int) -> List[int]:
    """1, 2, 4, ... up to max_parts."""
    out = [1]
    while out[-1] * 2 <= max_parts:
        out.append(out[-1] * 2)
    return out


def solve_one(path: str, parts: int, devices: Sequence[str],
              node_batch: int = 32, tree_search: str = "bfs",
              time_limit: float = 120.0, options: Sequence = ()) -> dict:
    """DistQG on `path` with `parts` partitions (partition i on
    devices[i % len(devices)]), `options` (name, value) pairs set last;
    the row's columns plus `supersteps` and the partitions' devices."""
    from ..io.nl_reader import read_nl
    from ..parallel.dist_bnb import DistQGBranchAndBound
    from ..utils.environment import Environment
    env = Environment()
    env.set_option("node_batch", node_batch)
    env.set_option("tree_search", tree_search)
    env.set_option("bnb_time_limit", time_limit)
    env.set_option("log_level", 1)
    for k, v in options:
        env.set_option(k, v)
    part_devs = [devices[i % len(devices)] for i in range(parts)]
    bab = DistQGBranchAndBound(read_nl(path), part_devs, env=env)
    t0 = time.monotonic()
    st = bab.solve()
    dt = time.monotonic() - t0
    nodes = bab.stats.nodes_processed
    row = dict(zip(HEADER, (
        os.path.basename(path), parts, st.name, nodes, round(dt, 2),
        round(nodes / max(dt, 1e-9), 2), round(bab.ub, 8), round(bab.lb, 8),
        bab.stats.rebalances, bab.stats.nodes_migrated,
        "|".join(str(pool.nodes_processed) for pool in bab.pools))))
    row["supersteps"] = bab.stats.batches
    row["devices"] = [str(d) for d in bab.devices]
    return row


def sweep(paths: Sequence[str], devices: Sequence[str], max_parts: int,
          **kw) -> List[dict]:
    """Every instance at every partition count; prints each row as CSV
    and its supersteps and devices on stderr."""
    rows = []
    print(",".join(HEADER), flush=True)
    for path in paths:
        for parts in part_counts(max_parts):
            r = solve_one(path, parts, devices, **kw)
            rows.append(r)
            print(",".join(str(r[h]) for h in HEADER), flush=True)
            log(f"dist_sweep: {r['instance']} P={parts}: {r['supersteps']} "
                f"supersteps, {r['wall_s'] / max(1, r['supersteps']):.3f} s "
                f"a superstep; partitions on {r['devices']}")
    return rows


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m minotaur_tpu_torch.tools.dist_sweep",
        description=__doc__.split("\n")[0])
    ap.add_argument("instances", nargs="+", help=".nl paths")
    ap.add_argument("--max-parts", type=int, default=0,
                    help="largest partition count (0 = the larger of 4 "
                    "and the device count)")
    ap.add_argument("--time", type=float, default=120.0)
    ap.add_argument("--node-batch", type=int, default=32)
    ap.add_argument("--tree-search", default="bfs",
                    help="matches the reference protocol's -tree_search=bfs")
    ap.add_argument("--out", default="")
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    ap.add_argument("--devices", default="",
                    help="comma-separated partition devices (default: "
                    "every card, or the CPU)")
    args = ap.parse_args(argv)
    from ..bench import card_name
    from ..device import resolve_device
    devices = (args.devices.split(",") if args.devices
               else default_devices(args.device))
    for d in devices:
        resolve_device(d)
    missing = [p for p in args.instances if not os.path.isfile(p)]
    if missing:
        ap.error(f"no such file: {missing}")
    max_parts = args.max_parts or max(4, len(devices))
    first = resolve_device(devices[0])
    log(f"dist_sweep: card {card_name(first)}; devices {devices}; up to "
        f"{max_parts} partitions"
        + ("" if max_parts <= len(set(devices)) else
           f" ({len(set(devices))} distinct device(s): partitions share "
           f"them)"))
    rows = sweep(args.instances, devices, max_parts,
                 node_batch=args.node_batch, tree_search=args.tree_search,
                 time_limit=args.time)
    if args.out:
        with open(args.out, "w", newline="") as fh:
            w = csv.writer(fh)
            w.writerow(HEADER)
            w.writerows([[r[h] for h in HEADER] for r in rows])
    return 0


if __name__ == "__main__":
    sys.exit(main())
