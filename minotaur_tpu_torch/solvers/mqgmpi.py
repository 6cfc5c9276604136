"""mqgmpi: multi-controller (multi-process) distributed QG.

Reference: src/solvers/QGMpiMain.cpp + MpiBranchAndBound (the fork's
headline addition).  Every controller process runs the batched QG node
loop on its own device; host-side TCP collectives carry incumbent
gossip, bounded load balancing and termination
(parallel/multihost.py).

Single-machine launcher (the mpirun analogue; also the test path):

    python -m minotaur_tpu_torch.solvers.mqgmpi instance.nl --spawn 4 \\
        [--device cuda|cpu] [--options]

Rank r computes on cuda:{r % card count}, so ranks beyond the card
count share cards (two ranks on one card work); `--device cpu` runs
every rank on the CPU.

One-process-per-host deployment (run on EVERY host):

    python -m minotaur_tpu_torch.solvers.mqgmpi instance.nl \\
        --rank R --world P --coordinator host:port [--options]

Port of minotaur_tpu/solvers/mqgmpi.py: the same flags but
`--jax_coordinator` (the device binding needs no coordinator here), plus
`--device` (default cuda); `main(argv, device=...)` sets the default.
"""

from __future__ import annotations

import sys


def main(argv=None, device="cuda") -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    if not argv or argv[0] in ("-h", "--help"):
        print(__doc__)
        return 0
    path = argv[0]
    rest = argv[1:]

    def take(flag, default=None):
        if flag in rest:
            i = rest.index(flag)
            val = rest[i + 1]
            del rest[i:i + 2]
            return val
        return default

    spawn = take("--spawn")
    rank = take("--rank")
    world = take("--world", "1")
    coordinator = take("--coordinator", "127.0.0.1:29400")
    device = take("--device", device)
    # remaining flags --> option dict ("--name value" pairs)
    options = {}
    it = iter(rest)
    for tok in it:
        if tok.startswith("--"):
            options[tok[2:]] = next(it, "1")

    from ..parallel.multihost import run_rank, spawn_local
    if spawn is not None:
        results = spawn_local(path, int(spawn), options, device=device)
        best = min(results, key=lambda r: r["ub"])
        print(f"status: {best['status']}")
        print(f"best objective: {best['ub']:.10g}  lb: {best['lb']:.10g}")
        print(f"nodes per rank: {[r['processed'] for r in results]}")
        print(f"migrated in per rank: "
              f"{[r['migrated_in'] for r in results]}")
        print(f"devices: {[r['device'] for r in results]}")
        print(f"per-rank counts seen by each rank: "
              f"{[r['per_rank'] for r in results]}")
        return 0
    res = run_rank(path, int(rank or 0), int(world), coordinator, options,
                   device)
    print(res)
    return 0


if __name__ == "__main__":
    sys.exit(main())
