"""Solve-to-gap sweep of the port over the suite's rows.

Port of scripts/tpu_sweep.py (the reference's benchmark protocol,
scripts/minlp-test.py:36-60: an instance list, time caps, answers checked
against a solutions table).  Every row is a `SUITE` instance
(models/convex_suite*.py) with an exact optimum computed independently
of the solver; the three rows of the JAX harness that read reference
`.nl` files are left out.  Each row is solved by `BranchAndBound`
(`mbnb`) or `QGBranchAndBound` (`mqg`) on the chosen device and checked
against its oracle:

- sound: lb <= optimum <= ub within 1e-6 * (1 + |optimum|) (ub only
  where an incumbent exists);
- verified: the incumbent equals the optimum within 1e-5 relative (the
  JAX harness's test).

A row whose solve raises is written with status `ERROR:<type>`.  The
process exits 1 if any row is unsound or errored.  Rows are keyed on
(name, solver), also by `--resume`.  The n >= 1000 rows keep the JAX
harness's reductions: node_batch at most 4 (2 above n = 1500) and a QG
cut pool of 256 rows.

    python -m minotaur_tpu_torch.tools.sweep --device cuda --cap 60
    python -m minotaur_tpu_torch.tools.sweep --device cpu --only gbd_a

Writes one JSON line per row to --out as it finishes and a markdown
table to --md; prints a JSON summary as the last line.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

# (name, solver, node_limit, time_cap_s, reference family)
PLAN = [
    ("ball_mk_10a", "mbnb", 4000, 420.0, "ball_mk2_10"),
    ("ball_mk_16a", "mbnb", 8000, 420.0, "ball_mk3_20"),
    ("normcon_20a", "mbnb", 8000, 420.0, "cvxnonsep_normcon20"),
    ("expbudget_8a", "mbnb", 4000, 420.0, "cvxnonsep_psig20"),
    ("duopt_8a", "mbnb", 4000, 420.0, "du-opt5"),
    ("meanvar_8a", "mbnb", 4000, 420.0, "meanvarx"),
    ("facloc_4x8a", "mbnb", 4000, 420.0, "fac3"),
    ("gbd_a", "mbnb", 4000, 420.0, "gbd"),
    ("ex1223_a", "mbnb", 4000, 420.0, "ex1223a"),
    ("batchdes_a", "mbnb", 4000, 420.0, "batchdes"),
    ("cknap_30a", "mbnb", 4000, 420.0, "correlated knap"),
    ("layout1d_4a", "mbnb", 8000, 420.0, "flay03/slay"),
    ("uflquad_3x6a", "mbnb", 8000, 420.0, "uflquad"),
    ("synthes_5a", "mbnb", 4000, 420.0, "synthes2/rsyn"),
    ("stockcycle_24a", "mbnb", 12000, 420.0, "stockcycle"),
    ("stockcycle_60a", "mbnb", 120000, 420.0, "stockcycle n=60"),
    ("sssd_7x3a", "mbnb", 4000, 420.0, "sssd08-04"),
    ("sssd_8x3b", "mbnb", 4000, 420.0, "sssd seed5"),
    ("portcard_8_3a", "mbnb", 4000, 420.0, "portfol_card/alan"),
    ("portcard_10_3b", "mbnb", 4000, 420.0, "portfol n=10"),
    ("clay2_3a", "mbnb", 8000, 420.0, "clay0203m/slay 2-D"),
    ("clay2_3b", "mbnb", 8000, 420.0, "clay seed6"),
    ("rsyn_8a", "mbnb", 8000, 420.0, "rsyn0805"),
    ("rsyn_10b", "mbnb", 8000, 420.0, "rsyn k=10"),
    ("st_e14a", "mqg", 2000, 420.0, "st_e14"),
    ("st_e14b", "mqg", 2000, 420.0, "st_e14 seed2"),
    ("cknap_1200a", "mbnb", 3000, 900.0, "n=1200 MILP knapsack"),
    ("normcon_1024a", "mqg", 600, 900.0, "n=1024 int norm-cone"),
    ("intquad_2048a", "mbnb", 600, 900.0, "n=2048 separable MIQP"),
]

SOUND_RTOL = 1e-6
VERIFY_RTOL = 1e-5
# the JAX harness's defaults: 16 lanes, padded to one bucket
BATCH = 16
PAD_FULL = True


def log(msg):
    print(msg, file=sys.stderr, flush=True)


def check_row(lb: float, ub: float, truth: float) -> dict:
    """The oracle checks of one row."""
    tol = SOUND_RTOL * (1.0 + abs(truth))
    has_ub = ub < 1e19
    sound = lb <= truth + tol and (not has_ub or ub >= truth - tol)
    verified = has_ub and abs(ub - truth) / max(1.0, abs(truth)) <= VERIFY_RTOL
    return dict(sound=bool(sound), verified=bool(verified))


def run_one(name: str, solver: str, node_limit: int, time_cap: float,
            device: str) -> dict:
    """Solve one suite row; returns its numbers and oracle checks."""
    from minotaur_tpu_torch.models.convex_suite import SUITE
    from minotaur_tpu_torch.utils.environment import Environment

    gen, opt, _ = SUITE[name]
    p = gen()
    truth = float(opt())
    env = Environment()
    env.set_option("log_level", 0)
    batch = BATCH
    if p.n_vars >= 1000:
        # (B, n, n) KKT workspaces cap the batch, and a smaller QG cut
        # pool keeps the master's (m + pool, n) arrays small
        batch = min(batch, 4 if p.n_vars <= 1500 else 2)
        env.set_option("qg_max_cuts", 256)
    env.set_option("node_batch", batch)
    env.set_option("pad_full", int(PAD_FULL))
    env.set_option("bnb_node_limit", node_limit)
    env.set_option("bnb_time_limit", time_cap)
    if solver == "mqg":
        from minotaur_tpu_torch.bnb.qg import QGBranchAndBound as K
    else:
        from minotaur_tpu_torch.bnb.bnb import BranchAndBound as K
    t0 = time.monotonic()
    bab = None
    try:
        bab = K(p, env, device=device)
        status = bab.solve().name
    except Exception as e:
        status = f"ERROR:{type(e).__name__}"
        log(f"sweep: {name}: {type(e).__name__}: {e}")
    wall = time.monotonic() - t0
    lb = float(bab.lb) if bab is not None else float("-inf")
    ub = float(bab.ub) if bab is not None else float("inf")
    nodes = bab.stats.nodes_processed if bab is not None else 0
    gap = (ub - lb) / max(1.0, abs(ub)) if ub < 1e19 and lb > -1e19 \
        else float("inf")
    row = dict(name=name, solver=solver, n=p.n_vars, status=status,
               wall=wall, nodes=nodes, lb=lb, ub=ub, gap=gap, truth=truth,
               **check_row(lb, ub, truth))
    if status.startswith("ERROR"):
        row["sound"] = False
    return row


def _fmt(v: float) -> str:
    return format(v, ".10g") if abs(v) < 1e19 else ("inf" if v > 0
                                                   else "-inf")


def write_md(path: str, rows, header: str) -> None:
    with open(path, "w") as f:
        f.write(header + "\n\n")
        f.write("| instance | solver | n | status | wall s | nodes | lb | "
                "ub | optimum | rel gap | sound | ub = optimum |\n"
                "|---|---|---|---|---|---|---|---|---|---|---|---|\n")
        for r in rows:
            f.write(f"| {r['name']} | {r['solver']} | {r['n']} | "
                    f"{r['status']} | {r['wall']:.2f} | {r['nodes']} | "
                    f"{_fmt(r['lb'])} | {_fmt(r['ub'])} | "
                    f"{_fmt(r['truth'])} | {r['gap']:.3g} | "
                    f"{'yes' if r['sound'] else 'NO'} | "
                    f"{'yes' if r['verified'] else 'no'} |\n")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--only", default="",
                    help="comma-separated row names (default: all)")
    ap.add_argument("--cap", type=float, default=None,
                    help="per-row time cap in seconds (caps the plan's)")
    ap.add_argument("--out", default="sweep_rows.jsonl",
                    help="one JSON line per row, appended as rows finish")
    ap.add_argument("--md", default="sweep.md")
    ap.add_argument("--resume", action="store_true",
                    help="skip (name, solver) rows already in --out")
    args = ap.parse_args(argv)

    import torch
    only = set(filter(None, args.only.split(",")))
    unknown = only - {name for name, *_ in PLAN}
    if unknown:
        ap.error(f"unknown rows: {sorted(unknown)}")
    done = {}
    if args.resume and os.path.exists(args.out):
        with open(args.out) as f:
            for line in f:
                r = json.loads(line)
                done[(r["name"], r["solver"])] = r
        log(f"sweep: resume: {len(done)} rows from {args.out}")
    elif os.path.exists(args.out):
        os.remove(args.out)
    kind = torch.cuda.get_device_name(0) if args.device.startswith(
        "cuda") else "cpu"
    rows = []
    t_sweep = time.monotonic()
    for name, solver, nlim, tcap, note in PLAN:
        if only and name not in only:
            continue
        if (name, solver) in done:
            rows.append(done[(name, solver)])
            continue
        cap = tcap if args.cap is None else min(tcap, args.cap)
        log(f"sweep: {name} ({solver}, cap {cap:g} s) ...")
        r = run_one(name, solver, nlim, cap, args.device)
        r["note"] = note
        rows.append(r)
        with open(args.out, "a") as f:
            f.write(json.dumps(r) + "\n")
        log(f"sweep: {name}: {r['status']} wall {r['wall']:.2f} s nodes "
            f"{r['nodes']} lb {_fmt(r['lb'])} ub {_fmt(r['ub'])} optimum "
            f"{_fmt(r['truth'])} sound {r['sound']} verified "
            f"{r['verified']}")
    total = time.monotonic() - t_sweep
    bad = [r["name"] for r in rows if not r["sound"]]
    n_opt = sum(r["status"] == "SOLVED_OPTIMAL" for r in rows)
    n_ver = sum(bool(r["verified"]) for r in rows)
    write_md(args.md, rows,
             f"Sweep of minotaur_tpu_torch on {kind} (`python -m "
             f"minotaur_tpu_torch.tools.sweep --device {args.device}"
             f"{'' if args.cap is None else f' --cap {args.cap:g}'}`): "
             f"{n_opt}/{len(rows)} SOLVED_OPTIMAL, {n_ver} incumbents equal "
             f"to the optimum, {len(rows) - len(bad)} sound, total wall "
             f"{total:.1f} s.")
    print(json.dumps({"rows": len(rows), "solved_optimal": n_opt,
                      "verified": n_ver, "unsound_or_error": bad,
                      "total_wall_s": total, "device": kind}))
    return 1 if bad else 0


if __name__ == "__main__":
    sys.exit(main())
