"""Environment: options + logger + global timers + RNG seed.

Reference: src/base/Environment.h:28, Environment.cpp:48 (default options)
and Environment.cpp:913 (CLI parsing).  The option *names* follow the
reference so users of minotaur can keep their command lines; TPU-specific
options (node_batch, device mesh, dtype) are additions.
"""

from __future__ import annotations

import sys
from typing import Any, List, Optional, Sequence

from .logger import Logger
from .options import OptionDB
from .timer import Timer, TimerFactory
from .types import LogLevel

VERSION = "0.1.0"


def _create_default_options(db: OptionDB) -> None:
    """Default options. Mirrors Environment::createDefaultOptions_
    (reference: Environment.cpp:48) for the options our solver stack
    consumes, plus TPU-native additions."""
    ins = db.insert
    # --- general / driver ---------------------------------------------
    ins("config_file", str, "read more options from this file", "")
    ins("log_level", int, "verbosity 0..6 (none..debug2)", int(LogLevel.INFO))
    ins("problem_file", str, "path to the instance (.nl or .mps)", "")
    ins("display_problem", bool, "write the problem before solving", False)
    ins("display_size", bool, "write problem size statistics", False)
    ins("display_presolved_problem", bool, "write problem after presolve", False)
    ins("solve", bool, "solve the problem (off = read/presolve only)", True)
    ins("write_sol_file", bool, "write an AMPL .sol file next to the input", False)
    ins("debug_sol", str, "file with a known-feasible solution; assert it stays "
        "feasible through presolve and the tree (reference Problem::isDebugSolFeas)", "")
    ins("rand_seed", int, "seed for random number generators", 0)
    # --- tolerances / limits ------------------------------------------
    ins("obj_gap_percent", float, "stop when rel gap (percent) below this", 1e-4)
    ins("solAbs_tol", float, "absolute optimality/prune tolerance", 1e-6)
    ins("solRel_tol", float, "relative optimality/prune tolerance", 1e-6)
    ins("int_tol", float, "integrality tolerance", 1e-6)
    ins("feasAbs_tol", float, "absolute constraint feasibility tolerance", 1e-6)
    ins("feasRel_tol", float, "relative constraint feasibility tolerance", 1e-6)
    ins("bnb_time_limit", float, "wall time limit in seconds", 1e20)
    ins("bnb_node_limit", int, "maximum number of B&B nodes", 2**62)
    ins("bnb_sol_limit", int, "stop after this many improving solutions", 2**62)
    ins("bnb_log_interval", float, "seconds between progress rows", 5.0)
    # --- tree search ---------------------------------------------------
    ins("tree_search", str, "node selection: dfs/bfs/BthenD", "BthenD")
    ins("brancher", str, "branching rule: maxvio/rel/strong/lexico/random/"
        "maxfreq/weak/unambrel", "rel")
    ins("sol_pool_size", int, "capacity of the best-k solution pool", 10)
    ins("br_frac_weight", float, "weight for fractionality in branching score", 0.167)
    ins("strbr_lane_limit", int, "max strong-branch probe lanes drained from the queue per superstep", 20)
    ins("strbr_iter_limit", int, "deprecated alias of strbr_lane_limit (the reference's per-probe engine iteration cap has no analogue here: vmapped probe lanes share one engine iteration budget); consulted only when strbr_lane_limit is left at its default", 20)
    ins("rel_thresh", int, "reliability threshold for pseudo-costs", 8)
    ins("rel_cands", int, "max candidates scored by strong branching per node", 8)
    ins("vbc_file", str, "write VBC tree-trace events to this file", "")
    # --- presolve ------------------------------------------------------
    ins("presolve", bool, "run presolve before the tree", True)
    ins("bin2lin", bool, "exact linearization of binary products "
        "(MIQP -> MILP; reference NlPresHandler bin2Lin)", False)
    ins("nl_presolve", bool, "nonlinear presolve (FBBT through expression DAGs)", True)
    ins("lin_presolve", bool, "linear presolve passes", True)
    ins("max_presolve_iters", int, "max major presolve iterations", 5)
    ins("obbt", bool, "optimality-based bound tightening at root", False)
    ins("rlt_cuts", int, "max RLT bound-factor cut candidates in glob "
        "(reference SimplexQuadCutGen; 0 disables)", 16)
    ins("multilinear_group", int, "max arity per exact lambda-hull group; higher-arity monomials chain grouped intermediates (reference ml_* group size)", 4)
    ins("rlt_row_products", int, "max static row-x-row RLT product cuts appended to the glob master (basis-free analogue of the reference's simplex-tableau row products)", 4)
    ins("multilinear_hull", int, "max trilinear terms given exact "
        "lambda-hull formulations in glob (reference "
        "MultilinearTermsHandler; 0 disables)", 8)
    ins("fbbt_rounds", int, "FBBT sweeps per node presolve", 2)
    # --- engines -------------------------------------------------------
    ins("lp_engine", str, "LP engine (ipm)", "ipm")
    ins("qp_engine", str, "QP engine (ipm/none)", "ipm")
    ins("nlp_engine", str, "NLP engine (ipm)", "ipm")
    ins("ipm_max_iters", int, "max IPM iterations per solve", 90)
    ins("ipm_tol", float, "IPM convergence tolerance", 1e-8)
    ins("ipm_use_pallas", bool, "accepted for the JAX package's command lines and without effect: the port always factorizes through its own kernel (ops/spd_inverse.py; times in PERF.md)", False)
    ins("ipm_chol_retry", bool, "retry failed f32 Cholesky with a Gershgorin shift (off = single-chol fast path; failed lanes fall back to identity + certificates)", True)
    ins("ipm_tail_kkt_rounds", int, "defect-correction depth in the IPM's "
        "f32 tail (speed/accuracy knob; deeper = fewer iterations, more "
        "per-iteration f64 matvecs)", 8)
    ins("ipm_refine_steps", int, "inner refinement iterations per f32 SPD "
        "solve (0 = rely on block-level defect correction only)", 2)
    ins("ipm_affine_kkt_rounds", int, "defect-correction depth for the "
        "affine predictor solve (it only shapes sigma)", 1)
    ins("eval_within_bnds", bool, "clip x into variable bounds before evaluating "
        "nonlinear functions (guards sqrt/log domains)", True)
    # --- QG / cuts -----------------------------------------------------
    ins("qg_max_cuts", int, "capacity of the preallocated QG cut pool", 2048)
    ins("cut_pool_capacity", int, "capacity of the general cut pool", 4096)
    ins("max_vio_per", float, "QG ECP cut gating: add fractional-point "
        "cuts only when the node's nl-violation score is >= this multiple "
        "of its parent's (reference QGHandlerAdvance maxVioPer; typical "
        "0.5/1/2/5; 0 = cadence-based ECP instead)", 0.0)
    ins("root_linearizations", str, "extra root linearization scheme for QG: "
        "esh (supporting hyperplanes via analytic-center bisection), sample "
        "(gradient cuts at interior samples), both, rs1 (univariate "
        "tangent fans, rootLinScheme1_), rs2 (neighborhood cuts around "
        "the root NLP point, rootLinScheme2_), rs3 (LP-guided ESH "
        "rounds, rootLinScheme3_), or off", "esh")
    ins("root_linearization_samples", int, "sample count for the sampled "
        "root linearization scheme", 8)
    ins("persp_cuts", bool, "perspective cuts for indicator-controlled "
        "nonlinear rows (reference PerspCutHandler)", True)
    ins("persp_ref", bool, "presolve-time perspective REFORMULATION of "
        "indicator-controlled nonlinear rows (eps-smoothed w*g(x/w); "
        "reference NlPresHandler::perspRef_ :837)", False)
    # --- heuristics ----------------------------------------------------
    ins("divheur", bool, "MINLP diving heuristic before the tree", False)
    ins("trimloss_heur", bool, "constructive heuristic for square-encoded "
        "trimloss structures (pattern enumeration + exact DP; "
        "bnb/trimloss.py); no-op when the structure is absent", True)
    ins("divheur_scheme", str, "dive-lane scoring: frac/veclen/lex/rcost "
        "or auto (deal all four reference Scoretypes across lanes; "
        "reference MINLPDiving.h:47-53)", "frac")
    ins("fpump", bool, "feasibility pump heuristic", False)
    ins("msheur", bool, "multistart heuristic", False)
    ins("samplingheur", bool, "random-sampling primal heuristic at root "
        "(reference SamplingHeur)", False)
    ins("fixvarsheur", bool, "fix-integers-and-solve primal heuristic at "
        "root (reference FixVarsHeur), batched", False)
    ins("qpdheur", bool, "population QP-diving heuristic at root "
        "(reference QPDProcessor, as a primal heuristic)", False)
    ins("oa_master_time_frac", float, "fraction of the total time limit "
        "each OA master MILP may consume (reference: per-engine limits "
        "in OA.cpp)", 0.2)
    ins("oa_master_time_floor", float, "minimum seconds granted to each "
        "OA master MILP regardless of the fraction", 30.0)
    ins("oa_master_node_limit", int, "node cap per OA master MILP solve",
        4096)
    ins("nodeproc", str, "node processor: pcb (true-relaxation supersteps) "
        "or qpd (QP-approximation supersteps with true-model verification "
        "of every prune/incumbent decision; reference QPDProcessor)", "pcb")
    # --- TPU-native ----------------------------------------------------
    ins("node_batch", int, "nodes processed per device superstep", 256)
    ins("bnb_pipeline", bool, "overlap host bookkeeping of batch k with "
        "device compute of batch k+1 (disjoint nodes; one-batch-stale "
        "cutoffs only)", True)
    ins("native_tree", bool, "store open nodes in the C++ slab treestore "
        "(builds on first use; falls back to the python heap)", True)
    ins("msbnb_restarts", int, "multistart restart lanes per node in "
        "msbnb (reference MsProcessor msbnb_restarts; 1 disables)", 4)
    ins("pad_full", bool, "always pad batches to node_batch (one compiled "
        "bucket; padding is nearly free on latency-bound TPU supersteps)",
        False)
    ins("presolve_subst", bool, "root substitution presolve: eliminate "
        "fixed columns and singleton/doubleton-equality variables before "
        "staging, with a postsolve map back to the original space "
        "(reference LinearHandler::substVars_; see "
        "BranchAndBound.best_x_original)", False)
    ins("device_tree", bool, "device-resident multi-round supersteps: "
        "keep the open-node pool in device memory and run device_rounds "
        "complete B&B rounds (select/solve/prune/branch/insert) per "
        "dispatch; eligible for certified-bound LP/QP models with the "
        "plain node processor (bnb/device_pool.py).  OFF by default: "
        "each round still waits on the IPM's per-iteration host read; "
        "its times beside the host loop's are in PERF.md", False)
    ins("device_rounds", int, "B&B rounds executed per device dispatch "
        "in device_tree mode", 8)
    ins("device_pool_cap", int, "device node-pool capacity (slots); the "
        "host tree absorbs overflow", 4096)
    ins("device_warm_batches", int, "host-driven supersteps before "
        "entering device_tree mode (root processing, strong-branch "
        "pseudocost init, first incumbents)", 4)
    ins("dtype", str, "IPM dtype policy: mixed (f32 factorizations + f64 "
        "block corrections, the TPU-tuned default) / f32 (all-f32 "
        "iteration arithmetic) / f64 (full f64 factorizations)", "mixed")
    ins("mesh_hosts", int, "hosts in the device mesh (node-pool partitions)", 1)
    ins("lb_frequency", int, "supersteps between cross-host load balances "
        "(reference MpiBranchAndBound lb_frequency)", 8)
    ins("lb_pop_cap", int, "per-partition cap on nodes popped into a "
        "load-balance round, scaled by the partition count: each "
        "partition contributes <= cap*P best nodes (reference pops "
        "<= 50*world_size per rank, MpiBranchAndBound.cpp:93-107); "
        "0 drains whole pools", 50)
    ins("threads", int, "kept for reference CLI parity; maps to node_batch", 0)
    ins("checkpoint_file", str, "periodically checkpoint the search state here", "")
    ins("checkpoint_interval", float, "seconds between checkpoints", 300.0)
    ins("resume", bool, "resume from checkpoint_file if it exists", False)


class Environment:
    """Container for OptionDB + Logger + timers (reference: Environment.h:28)."""

    def __init__(self) -> None:
        self.options = OptionDB()
        _create_default_options(self.options)
        self.logger = Logger(LogLevel.INFO)
        self.timer_factory = TimerFactory()
        self._timer = Timer()
        self._timer.start()
        self._wall = Timer()
        self._wall.start()

    # -- timers ---------------------------------------------------------
    def get_time(self) -> float:
        return self._timer.query_cpu()

    def get_wtime(self) -> float:
        return self._wall.query_wall()

    def new_timer(self) -> Timer:
        t = self.timer_factory.get_timer()
        t.start()
        return t

    # -- options --------------------------------------------------------
    def get_option(self, name: str) -> Any:
        return self.options.get(name)

    def set_option(self, name: str, value: Any) -> None:
        self.options.set(name, value)
        if name == "log_level":
            self.logger.max_level = LogLevel(int(value))

    def read_options(self, argv: Sequence[str]) -> List[str]:
        """Parse CLI arguments (reference: Environment.cpp:913-1090).

        Accepts ``--name value``, ``--name=value``, ``-name value``,
        ``-name=value`` and strips an optional ``minotaur.`` prefix.
        Returns positional arguments (instance files)."""
        positional: List[str] = []
        i = 0
        argv = list(argv)
        while i < len(argv):
            tok = argv[i]
            if tok.startswith("-"):
                name = tok.lstrip("-")
                if name.startswith("minotaur."):
                    name = name[len("minotaur."):]
                if "=" in name:
                    name, value = name.split("=", 1)
                else:
                    if name in self.options and self.options.find(name).otype is bool \
                            and (i + 1 >= len(argv) or argv[i + 1].startswith("-")):
                        value = "1"
                    else:
                        i += 1
                        if i >= len(argv):
                            raise ValueError(f"option {name} needs a value")
                        value = argv[i]
                if name not in self.options:
                    raise ValueError(f"unknown option: {name}")
                self.set_option(name, value)
                if name == "config_file" and value:
                    self._read_config_file(value)
            else:
                positional.append(tok)
            i += 1
        return positional

    def _read_config_file(self, path: str) -> None:
        with open(path) as fh:
            for line in fh:
                line = line.split("#", 1)[0].strip()
                if not line:
                    continue
                parts = line.split(None, 1)
                if len(parts) == 2:
                    name = parts[0].lstrip("-")
                    if name.startswith("minotaur."):
                        name = name[len("minotaur."):]
                    self.set_option(name, parts[1].strip())

    def version_string(self) -> str:
        return f"minotaur-tpu {VERSION}"

    def write_full_version(self, out=None) -> None:
        (out or sys.stdout).write(self.version_string() + "\n")
