"""Readings that set the limits of `correct`: the program's numbers over
many seeds (the lower readings) and its control's (the upper ones).

    python3 benchmark/control.py --workload <cell> --seeds 11,12,13 \
        [--seconds 46] [--control 1] [--out FILE]

For each seed, one run of the cell as the benchmark makes it, and with
--control 1 its control: where the configuration names a lower-precision
path of the program (`control.solver`), a second run with that path
switched on; where it names the reference (`control: "reference"`), the
reference in float32 put in the program's place on the same run's lanes.
One JSON line a seed, on standard output and appended to FILE.  The
benchmark's own runs never run the control.
"""

import argparse
import json
import os
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="benchmark/control.py")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=float, default=None)
    ap.add_argument("--control", type=int, choices=(0, 1), default=1)
    ap.add_argument("--solver", default="{}",
                    help="JSON of solver options that replace the "
                         "configuration's in the program's runs (to read "
                         "another path of the program)")
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    sys.path.insert(0, ROOT)
    import torch
    from benchmark.harness import registry, runner
    if not torch.cuda.is_available():
        print("control: needs a CUDA device", file=sys.stderr)
        return 2
    bench = registry.benchmark()
    seconds = args.seconds or float(bench["run_seconds"])
    cell = registry.workload(args.workload)
    cfg = registry.config(cell["config"])
    ctl = cfg["control"]
    dev = torch.device("cuda", 0)
    prog = dict(solver={**cfg["solver"], **json.loads(args.solver)})
    for seed in (int(s) for s in args.seeds.split(",")):
        ns = argparse.Namespace(workload=args.workload, seed=seed,
                                seconds=seconds, trace=0)
        by_ref = args.control and ctl == "reference"
        line = runner.execute(ns, time.monotonic(), dev, 1, bench,
                              overrides=prog, control=by_ref)
        rec = dict(workload=args.workload, seed=seed,
                   solver=json.loads(args.solver),
                   correct=line["correct"],
                   program={k: c["value"] for k, c in line["checks"].items()},
                   metrics={k: m["value"] for k, m in line["metrics"].items()
                            if k != "setup_s"})
        if by_ref:
            rec["control"] = line["control"]
        elif args.control:
            over = dict(solver={**cfg["solver"], **ctl["solver"]})
            cl = runner.execute(ns, time.monotonic(), dev, 1, bench,
                                overrides=over)
            rec["control"] = {k: c["value"] for k, c in cl["checks"].items()}
        text = json.dumps(rec)
        print(text, flush=True)
        if args.out:
            with open(args.out, "a") as f:
                f.write(text + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
