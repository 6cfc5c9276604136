"""Batched primal-dual interior-point engine (LP / QP / convex NLP).

Port of minotaur_tpu/engines/ipm.py.  The JAX engine is a one-lane solver
vmapped over lanes; here every function takes the lane axis explicitly:
bounds, starts and iterates are (B, .) tensors and the problem data (c,
Q) is shared.  The constraint data is shared too ((m, n) `A`, (m,)
`clb`/`cub`) or carries one matrix and one row range per lane ((B, m, n)
and (B, m), which the JAX package gets from `vmap` over this solver), or
comes as a `LaneRows` (the global path's envelope rows on a fixed
sparsity pattern).  `_solve` turns the operand into its operator
(`engines/lane_rows.py`: `as_operator`), and the solve asks only that
operator's methods for its products, Grams, selected rows, f64-class
products and dtype copies.  The row structure (equality rows, x-space or
m-space) is static either way.  The math, the two-phase drive, the certificates and the status
machine follow the JAX code line by line; its docstrings explain the
derivations.

`vmap` of a `while_loop` keeps a finished lane's carry frozen while the
other lanes iterate.  `_Eager.loop` does the same with a per-lane
`active` mask that gates every state update (iterate, k, best_*, stall,
nu).  The host reads the number of active lanes once per iteration, so
each iteration costs one device-to-host sync.

A shared-operator LP/QP solve on a CUDA device replays a tape of CUDA
graphs (`_Tape`) from its key's second solve on (the key: the inputs'
shapes and dtypes, with or without a dual start; the solver's options fix
the step variants).  The graphs hold the code between the islands, which
run eagerly: each K1 call with its failed-lane read and retry, each K2
call, and each loop's active-lane read.  So the same kernels run on the
same data in the same order, and the host dispatches each iteration's
elementwise ops as a few graph launches.  Whether a solve may take a
tape is the operator's answer (`replayable`: the shared kind only); the
per-lane kinds (each iteration device-bound) and the NL path stay
eager.

Spans (utils/trace.py): `ipm.solve` around each solve, with the counts
`lanes`, `iters` (batched iterations), `lane_iters` (active lanes summed
over them), `replayed` (iterations replayed from a tape's recorded
body) and the operator's own counts (`counts`: `structured` on a
`LaneRows`, iterations run on it); `ipm.iter` around each iteration (the step and the read that
follows it); `ipm.sync` around each blocking host read (the active-lane
count and the Cholesky retry's two reads); `step.fetch` around the one
copy of `build_batch_solver`'s packed result.

Nonlinear rows or objective (`has_nl`) take the JAX package's NL branch:
the gradient, the Jacobian of the nonlinear rows and the Hessian of the
Lagrangian come from `torch.func` (`grad`, `jacfwd`, `hessian`, each
vmapped over lanes) applied to the staged expression code; the factors
are float64; every iteration runs a merit line search over a fixed scale
ladder; stalled and NaN-stopped lanes restart; lanes plateauing at the
acceptable level stop; the dual bound is the reference's uncertified
trust margin around a converged objective.

The two TPU kernels of this path are `ops/spd_inverse.py` (factorize +
explicit inverse, once per iteration per condensed matrix) and
`ops/spd_solve.py` (every direction solve through that inverse).  On a
CUDA device they run as hand-written CUDA kernels; on the CPU as their
plain PyTorch versions.

`light_phase1` runs phase 1's iteration arithmetic (residuals, the
condensed matrix, the solve chain, the block corrections, the trial
step and its Farkas test) in float32, as the JAX code's env32 does; a
Farkas exit from that arithmetic is confirmed in float64 after the loop.
`tail_corr_f32` computes the tail's block-correction residuals in
float32.  `gondzio_correctors` adds the centrality corrections (LP/QP),
each one more solve through the iteration's factorization.  The JAX
package's `use_pallas` has no field here: the port always runs its own
kernel, and the environment option `ipm_use_pallas` is accepted and
read by nothing.
"""

from __future__ import annotations

import collections
import contextlib
import dataclasses
import gc
import weakref
from typing import Callable, NamedTuple, Optional

import numpy as np
import torch
from torch.func import grad, hessian, jacfwd, vmap

from ..device import F32, F64, check_fp32_matmul, resolve_device
from ..ops.spd_inverse import spd_inverse
from ..ops.spd_solve import spd_solve
from ..utils import trace
from ..utils.types import EngineStatus
from .lane_rows import as_operator
from .staging import StagedProblem

_BIG = 1e20


@dataclasses.dataclass(frozen=True)
class IPMOptions:
    """Same fields and defaults as minotaur_tpu.engines.ipm.IPMOptions
    (see its comments for what each knob trades; its measurements were
    taken on a TPU and are not the port's)."""
    max_iters: int = 90
    tol: float = 1e-8
    tau: float = 0.995          # fraction-to-boundary
    reg_primal: float = 1e-9
    reg_dual: float = 1e-9
    sigma_pow: int = 3          # Mehrotra sigma = (mu_aff/mu)^pow
    infeas_mu: float = 1e-10    # mu below this + primal infeasible => INFEAS
    # factorize in f32 with Jacobi pre-scaling, refine in f64
    factor_f32: bool = True
    # refinement rounds inside each f32 SPD solve (K2's refine_steps)
    refine_steps: int = 2
    kkt_rounds: int = 1         # block-level defect-correction rounds
    # retry a failed f32 factorization once with a Gershgorin shift
    chol_retry: bool = True
    # keep the f32 factorization in the tail (deeper defect correction)
    tail_factor_f32: bool = True
    tail_kkt_rounds: int = 8
    tail_tol: float = 1e-5
    # all-f32 phase-1 iteration arithmetic (Farkas exits re-confirmed
    # in f64 after the loop)
    light_phase1: bool = False
    # f32 block-correction residuals in the tail
    tail_corr_f32: bool = False
    # assemble the condensed matrix in the factor dtype
    light_assembly: bool = True
    affine_kkt_rounds: Optional[int] = 1
    # NL "solved to acceptable level" threshold (Ipopt acceptable_tol)
    acceptable_tol: float = 1e-6
    # Gondzio centrality correctors (LP/QP): one extra solve each
    gondzio_correctors: int = 0


class IPMResult(NamedTuple):
    x: torch.Tensor           # (B, n) primal point
    obj: torch.Tensor         # (B,) objective value (incl. const)
    dual_bound: torch.Tensor  # (B,) certified lower bound (LP) or obj-eps
    y: torch.Tensor           # (B, m) row duals
    status: torch.Tensor      # (B,) EngineStatus codes
    iters: torch.Tensor       # (B,)
    kkt_err: torch.Tensor     # (B,)


def _fin(b):
    return b.abs() < _BIG


def _amax0(v):
    """Row max of v with initial=0 (jnp.max(..., initial=0.0)): an empty
    row gives 0 instead of raising."""
    if v.shape[-1] == 0:
        return v.new_zeros(v.shape[:-1])
    return torch.clamp(v.amax(dim=-1), min=0.0)


def _max_step(v, dv, tau, mask):
    """Largest alpha in (0, 1] with v + alpha*dv >= (1-tau)*v on mask,
    per lane."""
    bad = (dv < 0) & mask
    ratio = torch.where(bad, -tau * v / torch.where(bad, dv, -1.0), 1.0)
    return torch.clamp(ratio.amin(dim=1), max=1.0)


def _sel(mask, a, b):
    """Lane-wise select between two tensors whose first axis is the lane."""
    m = mask.reshape(mask.shape + (1,) * (a.dim() - 1))
    return torch.where(m, a, b)


def _sel_state(mask, a, b):
    return tuple(_sel(mask, x, y) for x, y in zip(a, b))


def _read(count: torch.Tensor) -> int:
    """A loop's one host read: the number of lanes still iterating."""
    with trace.span("ipm.sync"):
        return int(count)


# ---------------------------------------------------------------------------
# Islands: the calls of a solve that run eagerly between its graph segments
# (see _Tape).  An island keeps the tensors it reads; its outputs keep the
# addresses of its first run, so that a segment captured after it reads each
# later run's values.
# ---------------------------------------------------------------------------

def _keep(isl, name: str, t: torch.Tensor) -> None:
    old = getattr(isl, name)
    if old is None:
        setattr(isl, name, t)
    else:
        old.copy_(t)


class _Factor:
    """K1 on the scaled matrix `Ms`.  With `shift` (B,), the lanes whose
    factorization failed are read on the host and factorized again with
    their Gershgorin shift on the diagonal; `bad2` flags those that failed
    twice.  `minv` is the inverse as K1 returned it, handed to K2 without
    a copy."""
    __slots__ = ("Ms", "shift", "minv", "bad", "bad2")

    def __init__(self, Ms, shift=None):
        self.Ms, self.shift = Ms, shift
        self.minv = self.bad = self.bad2 = None

    def run(self):
        Ms = self.Ms
        minv, flag = spd_inverse(Ms)
        bad = flag >= 2.0
        if self.shift is not None:
            bad2 = torch.zeros_like(bad)
            with trace.span("ipm.sync"):
                retry = bool(bad.any())
            if retry:
                with trace.span("ipm.sync"):
                    idx = torch.nonzero(bad).flatten()
                eye = torch.eye(Ms.shape[-1], dtype=Ms.dtype, device=Ms.device)
                Ms2 = Ms[idx] + self.shift[idx][:, None, None] * eye
                minv2, flag2 = spd_inverse(Ms2.contiguous())
                minv = minv.index_copy(0, idx, minv2)
                bad2 = bad2.index_copy(0, idx, flag2 >= 2.0)
            _keep(self, "bad2", bad2)
        self.minv = minv
        _keep(self, "bad", bad)


class _Solve:
    """K2 through a `_Factor`'s inverse: `out` = M^-1 r."""
    __slots__ = ("fac", "args", "out")

    def __init__(self, fac, *args):
        self.fac, self.args, self.out = fac, args, None

    def run(self):
        M_c, dinv_m, shift_m, r, steps, out_dtype = self.args
        _keep(self, "out", spd_solve(self.fac.minv, M_c, dinv_m, shift_m, r,
                                     steps, out_dtype))


class _Eager:
    """Runs a solve as its code stands: each island where it is called,
    each host loop as a `while_loop` over lanes.  Each iteration counts
    `iters` and the names in `counts` one each."""

    def __init__(self, *counts):
        self.counts = ("iters",) + counts

    @staticmethod
    def island(isl):
        isl.run()
        return isl

    def loop(self, cond, step, state):
        # batched while_loop: lanes whose condition is false keep their
        # whole state (vmap-of-while_loop semantics); the host reads the
        # number of active lanes once an iteration
        active = cond(state)
        n_active = _read(active.sum())
        while n_active:
            with trace.span("ipm.iter"):
                state = _sel_state(active, step(state), state)
                active = cond(state)
                n_next = _read(active.sum())
            for key in self.counts:
                trace.count(key, 1)
            trace.count("lane_iters", n_active)
            n_active = n_next
        return state


_EAGER = _Eager()


class _Loop:
    """A host loop of a tape: its state `S`, mask `active` and count `cnt`
    live at fixed addresses; each iteration replays the body (segments and
    islands) that steps `S` in place, then reads `cnt`.  The body is
    recorded at the first iteration that runs."""

    def __init__(self, tape, cond, step, S, active, cnt):
        self.tape = weakref.ref(tape)
        self.cond, self.step = cond, step
        self.S, self.active, self.cnt = S, active, cnt
        self.body = None

    def advance(self):
        """One iteration as code (run while recording)."""
        S, active = self.S, self.active
        # the step hands back fresh tensors or its own slot's input, so
        # writing a slot in place changes no other slot's new value
        new = self.step(S)
        for s, a in zip(S, new):
            m = active.reshape(active.shape + (1,) * (a.dim() - 1))
            torch.where(m, a, s, out=s)
        active.copy_(self.cond(S))
        self.cnt.copy_(active.sum())

    def run(self):
        n_active = _read(self.cnt)
        while n_active:
            with trace.span("ipm.iter"):
                body = self.body
                if body is None:
                    self.tape().record_body(self)
                else:
                    for op in body:
                        op()
                n_next = _read(self.cnt)
            trace.count("iters", 1)
            trace.count("lane_iters", n_active)
            if body is not None:
                trace.count("replayed", 1)
            n_active = n_next


class _Tape:
    """One key's solve as CUDA graphs.  The code between two islands or
    host loops (a segment) is captured once and replayed: the prologue
    from the inputs to the first loop's state, each loop's body, the
    stretches between loops, the polish and the epilogue.  The islands
    (each K1 call with its failed-lane read and retry, each K2 call) and
    each loop's active-lane read run eagerly between segments, so every
    kernel call and host read happens as in the eager solve.

    `record` runs the key's first graphed solve on static copies of its
    inputs, capturing each segment and replaying it at once, so that the
    solve it returns is computed; `replay` copies new inputs into those
    copies and runs the ops.  Only the recording solve captures into the
    tape's memory pool, so the addresses its segments read and write hold
    between solves; a loop whose body did not run while recording records
    it at its first iteration in a later solve, into a pool of its own."""

    def __init__(self, dev):
        self.stream = _capture_stream(dev)
        self.pool = torch.cuda.graph_pool_handle()
        self.ops = []
        self.inputs = self.out = None
        self._ops = self.ops          # where recorded ops go
        self._graph = None            # the segment being captured

    def _begin(self):
        self._graph = torch.cuda.CUDAGraph()
        self._graph.capture_begin(pool=self.pool,
                                  capture_error_mode="thread_local")

    def _cut(self):
        g, self._graph = self._graph, None
        g.capture_end()
        g.replay()
        self._ops.append(g.replay)

    def _abort(self):
        if self._graph is not None:
            g, self._graph = self._graph, None
            try:
                g.capture_end()
            except RuntimeError:
                pass

    @contextlib.contextmanager
    def _on_side(self):
        """Captures need a stream of their own: it waits for the caller's
        stream at the start, and the caller's for it at the end."""
        cur = torch.cuda.current_stream(self.stream.device)
        if cur == self.stream:
            yield
            return
        self.stream.wait_stream(cur)
        with torch.cuda.stream(self.stream):
            yield
        cur.wait_stream(self.stream)

    # ---- called from the solve's code while recording
    def island(self, isl):
        self._cut()
        isl.run()
        self._ops.append(isl.run)
        self._begin()
        return isl

    def loop(self, cond, step, state):
        # the loop's own state (slots that alias each other become
        # distinct), mask and count
        S = tuple(t.clone() for t in state)
        active = cond(S)
        lp = _Loop(self, cond, step, S, active, active.sum())
        self._cut()
        self._ops.append(lp.run)
        lp.run()
        self._begin()
        return S

    def record_body(self, lp):
        ops, pool = self._ops, self.pool
        self._ops = []
        if self.inputs is not None:
            # a later solve: the body's segments get a pool of their own,
            # so that they allocate over nothing the tape keeps
            self.pool = torch.cuda.graph_pool_handle()
        try:
            with self._on_side():
                self._capture(lp.advance)
            lp.body = self._ops
        finally:
            self._ops, self.pool = ops, pool

    def _capture(self, fn, *args):
        # no collection while recording: one could free another tape's
        # graphs, which a capture forbids (it would fail)
        paused = gc.isenabled()
        gc.disable()
        self._begin()
        try:
            out = fn(*args)
            self._cut()
        except BaseException:
            self._abort()
            raise
        finally:
            if paused:
                gc.enable()
        return out

    # ---- a solve
    def record(self, solve, args) -> IPMResult:
        with self._on_side():
            statics = tuple(None if a is None else a.clone() for a in args)
            # the solve's code holds the tape weakly, so that a tape
            # dropped with its solver goes at once, graphs and pools
            out = self._capture(solve, *statics, weakref.proxy(self))
        self.inputs, self.out = statics, out
        return self._result()

    def replay(self, args) -> IPMResult:
        for s, a in zip(self.inputs, args):
            if s is not None:
                s.copy_(a)
        for op in self.ops:
            op()
        return self._result()

    def _result(self) -> IPMResult:
        return IPMResult(*(t.clone() for t in self.out))

    def close(self):
        """Drops the graphs and every tensor kept (their pools go with
        them)."""
        self.ops.clear()
        self._ops = self.ops
        self.inputs = self.out = None


_CAPTURE_STREAMS = {}


def _capture_stream(dev) -> "torch.cuda.Stream":
    """The stream that tapes capture on, one a device for the process.  A
    new stream gets a cuBLAS workspace of its own at its first product,
    kept for the process; here it is made by a product outside any
    capture, so that no tape's memory pool holds it."""
    dev = torch.device(dev)
    index = torch.cuda.current_device() if dev.index is None else dev.index
    stream = _CAPTURE_STREAMS.get(index)
    if stream is None:
        stream = torch.cuda.Stream(index)
        with torch.cuda.stream(stream):
            for dt in (F32, F64):
                one = torch.ones(1, 1, 1, dtype=dt, device=index)
                torch.matmul(one[0], one[0])
                torch.matmul(one, one)
        _CAPTURE_STREAMS[index] = stream
    return stream


class _Tapes:
    """A solver's tapes by key, the least recently used dropped past
    `SIZE`.  A key is recorded at its second solve: the first runs
    eagerly, so that a key seen once costs no capture."""
    SIZE = 4
    SEEN = 64

    def __init__(self):
        self._tapes = collections.OrderedDict()
        self._seen = collections.OrderedDict()

    def __len__(self):
        return len(self._tapes)

    def clear(self):
        for tape in self._tapes.values():
            tape.close()
        self._tapes.clear()
        self._seen.clear()

    def solve(self, key, solve, args) -> Optional[IPMResult]:
        """The solve from the key's tape (recorded now at the key's second
        solve), or None: the caller solves eagerly."""
        tape = self._tapes.get(key)
        if tape is not None:
            self._tapes.move_to_end(key)
            return tape.replay(args)
        if key not in self._seen:
            self._seen[key] = None
            if len(self._seen) > self.SEEN:
                self._seen.popitem(last=False)
            return None
        del self._seen[key]
        if len(self._tapes) >= self.SIZE:
            self._tapes.popitem(last=False)[1].close()
        tape = _Tape(args[0].device)
        res = tape.record(solve, args)
        self._tapes[key] = tape
        return res


def _graphs_on(dev: torch.device) -> bool:
    """Whether solves on `dev` may replay tapes: CUDA devices."""
    return dev.type == "cuda"


def _make_spd_solver(M: torch.Tensor, opts: IPMOptions, use_f32=None,
                     out_dtype=None, run=_EAGER):
    """Batched SPD solve M x = r (M: (B, k, k)) through an explicit
    inverse of the Jacobi-scaled matrix (K1) and the refined solve (K2).
    Returns (solve, bad) with bad (B,) bool: both factorizations failed
    and the lane got the identity.  `run` places the K1 and K2 calls
    (`_Eager`, or a `_Tape` recording)."""
    k = M.shape[-1]
    if k == 0:
        # an LP without rows on the m-space path: nothing to factorize
        # (the JAX code's reductions take initial values here)
        od = out_dtype or M.dtype
        return (lambda r: r.to(od)), \
            torch.zeros(M.shape[0], dtype=torch.bool, device=M.device)
    diag = torch.diagonal(M, dim1=1, dim2=2)
    dmax = torch.clamp(_amax0(diag.abs()), min=1e-30)
    d = torch.sqrt(torch.maximum(diag, 1e-12 * dmax[:, None]))
    dinv = 1.0 / d

    if use_f32 is None:
        use_f32 = opts.factor_f32
    if use_f32:
        dinv_f = dinv.to(F32)
        Ms = M.to(F32) * dinv_f[:, :, None] * dinv_f[:, None, :]
    else:
        Ms = M * dinv[:, :, None] * dinv[:, None, :]
    Ms = Ms.contiguous()

    if use_f32 and not opts.chol_retry:
        # single-factorization path: failed lanes keep the identity
        fac = run.island(_Factor(Ms))
        bad = fac.bad
        shift_vec = torch.zeros_like(d)
    else:
        # Gershgorin-shifted retry, run only on the failed lanes (the
        # JAX code factorizes every lane twice and selects; the result
        # is the same); every lane's shift is reckoned before K1, so
        # that K1's island holds only the call, its read and the retry
        dms = torch.diagonal(Ms, dim1=1, dim2=2)
        gersh = torch.clamp(
            (dms - (Ms.abs().sum(dim=2) - dms.abs())).amin(dim=1), max=0.0)
        shift = torch.clamp(-gersh, min=1e-6) + 1e-6 + 1e-7
        fac = run.island(_Factor(Ms, shift))
        bad = fac.bad & fac.bad2
        # the operator actually factorized (for refinement): the shift
        # lives in scaled space, adding shift * d^2 on the diagonal
        shift_vec = torch.where(fac.bad, shift, 0.0)[:, None] * d * d

    if out_dtype is None:
        out_dtype = M.dtype
    dinv_m = dinv.to(M.dtype)
    shift_m = shift_vec.to(M.dtype)
    steps = opts.refine_steps if use_f32 else max(opts.refine_steps, 3)
    M_c = M.contiguous()

    def solve(r):
        return run.island(_Solve(fac, M_c, dinv_m, shift_m, r, steps,
                                 out_dtype)).out

    return solve, bad


def build_single_solver(sp: StagedProblem, opts: IPMOptions = IPMOptions(),
                        device="cuda") -> Callable:
    """Returns solve(A, clb, cub, vlb, vub, x0, y0=None) -> IPMResult on
    lane-batched tensors (vlb, vub, x0: (B, n); y0: (B, m)); A (m, n),
    clb, cub (m,) are shared, or A (B, m, n) or a `LaneRows`, clb, cub
    (B, m) give each lane its own rows (`as_operator` reads A's kind) (the equality-row mask still comes
    from sp.clb and sp.cub).  `solve.with_objective(A, clb, cub, vlb, vub,
    x0, c_in, y0=None)` swaps the linear objective (c_in: (n,) or
    (B, n))."""
    dev = resolve_device(device)
    check_fp32_matmul(dev)

    n, m = sp.n, sp.m
    has_nl = bool(len(sp.nl_rows)) or sp.obj_nl is not None
    has_q = sp.Qobj is not None
    is_lp = not has_nl and not has_q
    condense_x = (not is_lp) or (m >= n)
    # f32 factorization is restricted to LP/QP paths: nonconvex NLP
    # Lagrangian Hessians change every iteration and the f32 phase can
    # poison the multipliers faster than refinement recovers
    if has_nl and opts.factor_f32:
        opts = dataclasses.replace(opts, factor_f32=False)
    eq_rows_np = np.where(np.isfinite(sp.clb) & np.isfinite(sp.cub) &
                          (np.abs(sp.cub - sp.clb) <= 1e-12))[0]
    m_eq = len(eq_rows_np)
    eq_rows = torch.as_tensor(eq_rows_np, dtype=torch.long, device=dev)
    eq_mask = torch.zeros(m, dtype=torch.bool, device=dev)
    eq_mask[eq_rows] = True

    t64 = lambda a: torch.as_tensor(a, dtype=F64, device=dev)  # noqa: E731
    c_const = t64(sp.c)
    Q_const = t64(sp.Qobj) if has_q else None
    Qsym = (Q_const + Q_const.T) if has_q else None
    Qsym32 = Qsym.to(F32) if has_q else None

    q_psd = False
    if has_q and not has_nl:
        _w, _V = np.linalg.eigh(0.5 * (sp.Qobj + sp.Qobj.T))
        if _w.min() >= -1e-9:
            q_psd = True
            _w = np.clip(_w, 0.0, None)
            q_eigw = t64(_w)
            q_eigV = t64(_V)
            q_wpos = torch.as_tensor(_w > 1e-10, device=dev)
            qV_sp = as_operator(q_eigV).split()
    PIN = 1e10 if condense_x else 1e16
    # phase 1 in float32 arithmetic (LP/QP with f32 factors only)
    light_on = (not has_nl) and opts.factor_f32 and opts.light_phase1

    obj_nl = sp.obj_nl
    con_nl = sp.con_nl
    nl_rows = torch.as_tensor(sp.nl_rows, dtype=torch.long, device=dev)

    # ---------------- problem callables (lane-batched) -----------------
    def f_obj(x, c):
        v = (x * c).sum(dim=1)
        if has_q:
            v = v + ((x @ Q_const.T) * x).sum(dim=1)
        if obj_nl is not None:
            v = v + obj_nl(x)
        return v

    grad_obj_nl = vmap(grad(obj_nl)) if obj_nl is not None else None

    def grad_f(x, c):
        g = c + x @ Qsym if has_q else c + torch.zeros_like(x)
        if grad_obj_nl is not None:
            g = g + grad_obj_nl(x)
        return g

    def g_con(A, x):
        v = A.mv(x)
        if con_nl is not None:
            v = v.index_add(1, nl_rows, con_nl(x))
        return v

    if con_nl is not None:
        jac_nl = vmap(jacfwd(con_nl))

        def jac(A, x):
            return A.expand(x.shape[0]).index_add(1, nl_rows, jac_nl(x))
    else:
        def jac(A, x):
            return A.expand(x.shape[0])

    if has_nl:
        def lag_nl(x, y):
            v = obj_nl(x) if obj_nl is not None else 0.0
            if con_nl is not None:
                v = v + y.index_select(-1, nl_rows) @ con_nl(x)
            return v
        hess_lag_nl = vmap(hessian(lag_nl, argnums=0))

    def hess_W(x, y):
        W = hess_lag_nl(x, y)
        if has_q:
            W = W + 2.0 * Q_const
        return W

    # an LP/QP solve on a CUDA device replays its tape (see _Tape) where
    # its operator allows it (the shared kind); per-lane operators (each
    # iteration is device-bound) and the NL path (torch.func) stay eager
    tapes = _Tapes()
    graphed = _graphs_on(dev) and not has_nl

    def solve_impl(A, clb, cub, vlb, vub, x0, c_in, y0=None):
        op = as_operator(A)
        with trace.span("ipm.solve", lanes=vlb.shape[0], replayed=0,
                        **dict.fromkeys(op.counts, 0)):
            # the tape keeps and keys the raw tensors; `_solve` wraps them
            args = (A, clb, cub, vlb, vub, x0, c_in, y0)
            if graphed and op.replayable:
                key = tuple(None if a is None else (tuple(a.shape), a.dtype)
                            for a in args)
                res = tapes.solve(key, _solve, args)
                if res is not None:
                    return res
            return _solve(*args, _Eager(*op.counts))

    def _solve(A, clb, cub, vlb, vub, x0, c_in, y0, run):
        A = as_operator(A)
        B = vlb.shape[0]
        c_in = c_in.expand(B, n) if c_in.dim() == 1 else c_in
        lz = torch.cat([vlb, clb.expand(B, m)], dim=1)
        uz = torch.cat([vub, cub.expand(B, m)], dim=1)
        fixed = _fin(lz) & _fin(uz) & ((uz - lz) <= 1e-12)
        fin_l = _fin(lz) & ~fixed
        fin_u = _fin(uz) & ~fixed
        nb = torch.clamp(fin_l.sum(dim=1) + fin_u.sum(dim=1), min=1).to(F64)
        fixed_x = fixed[:, :n]
        fixed_s = fixed[:, n:]
        zeros_bn = torch.zeros((B, n), dtype=F64, device=dev)
        zeros_bm = torch.zeros((B, m), dtype=F64, device=dev)

        def clampz(z):
            mid_frac = 0.01
            width = torch.where(fin_l & fin_u, uz - lz, 2.0)
            lo = torch.where(fin_l, lz + mid_frac * torch.clamp(width, max=100.0),
                             -_BIG)
            hi = torch.where(fin_u, uz - mid_frac * torch.clamp(width, max=100.0),
                             _BIG)
            z = torch.minimum(torch.maximum(z, lo), hi)
            return torch.where(fixed, lz, z)

        x_init = clampz(torch.cat([x0, zeros_bm], dim=1))[:, :n]
        s_init = clampz(torch.cat([zeros_bn, g_con(A, x_init)], dim=1))[:, n:]
        z0 = torch.cat([x_init, s_init], dim=1)
        if y0 is None:
            zl0 = fin_l.to(F64)
            zu0 = fin_u.to(F64)
            y0 = zeros_bm.clone()
        else:
            # dual warm start (see the JAX code)
            y0 = torch.where(torch.isfinite(y0), y0, 0.0)
            yJ0 = A.jac_tv(y0, lambda op: jac(op, x_init))
            rz = torch.cat([grad_f(x_init, c_in) + yJ0, -y0], dim=1)
            zl0 = torch.where(fin_l, torch.clamp(rz, 1e-2, 1e8), 0.0)
            zu0 = torch.where(fin_u, torch.clamp(zl0 - rz, 1e-2, 1e8), 0.0)

        def distances(z):
            dl = torch.where(fin_l, z - lz, 1.0)
            du = torch.where(fin_u, uz - z, 1.0)
            return torch.clamp(dl, min=1e-14), torch.clamp(du, min=1e-14)

        # the operator's f32 copy (kept: `A.to(F32)` gives it again), its
        # f64-class form and |A| in f32
        A32 = A.to(F32)
        A_sp = A.split()
        absA32 = A32.abs()
        mx64 = torch.where(fixed_x, 0.0, 1.0).to(F64)
        mx32 = mx64.to(F32)

        def cert_env(dt):
            """The row and box data of the certificates in one dtype (the
            JAX code's env64 / env32): float64 for every sound decision,
            float32 for the light phase's in-loop Farkas test."""
            e_clb, e_cub = clb.to(dt), cub.to(dt)
            e_vlb, e_vub = vlb.to(dt), vub.to(dt)
            fc, fu = _fin(e_clb), _fin(e_cub)
            fvl, fvu = _fin(e_vlb), _fin(e_vub)
            return dict(
                dt=dt, clb=e_clb, cub=e_cub, vlb=e_vlb, vub=e_vub,
                fin_clb=fc, fin_cub=fu, fin_vlb=fvl, fin_vub=fvu,
                box=torch.where(fvu & fvl,
                                torch.maximum(e_vub.abs(), e_vlb.abs()), 1e6),
                abs_clb=torch.where(fc, e_clb.abs(), 0.0),
                abs_cub=torch.where(fu, e_cub.abs(), 0.0))

        e64 = cert_env(F64)
        e32 = cert_env(F32) if light_on else None
        c32 = c_in.to(F32) if light_on else None

        def residuals(z, y, zl, zu):
            if has_nl:
                return residuals_nl(z, y, zl, zu)[:3]
            x, s = z[:, :n], z[:, n:]
            rd_x = grad_f(x, c_in) + A.tv(y) - zl[:, :n] + zu[:, :n]
            rd_s = -y - zl[:, n:] + zu[:, n:]
            rd_x = torch.where(fixed_x, 0.0, rd_x)
            rd_s = torch.where(fixed_s, 0.0, rd_s)
            rp = A.mv(x) - s
            return rd_x, rd_s, rp

        def residuals32(z, y, zl, zu):
            """LP/QP residuals in float32 (the light phase's env32)."""
            x, s = z[:, :n].to(F32), z[:, n:].to(F32)
            yk = y.to(F32)
            gf = c32 + x @ Qsym32 if has_q else c32
            rd_x = gf + A32.tv(yk) - zl[:, :n].to(F32) + zu[:, :n].to(F32)
            rd_s = -yk - zl[:, n:].to(F32) + zu[:, n:].to(F32)
            rd_x = torch.where(fixed_x, 0.0, rd_x)
            rd_s = torch.where(fixed_s, 0.0, rd_s)
            rp = A32.mv(x) - s
            return rd_x, rd_s, rp

        def residuals_nl(z, y, zl, zu):
            """NL residuals at the fresh Jacobian J, a per-lane operator
            (also returned: the step assembles its matrix from it)."""
            x, s = z[:, :n], z[:, n:]
            J = as_operator(jac(A, x))
            rd_x = grad_f(x, c_in) + J.tv(y) - zl[:, :n] + zu[:, :n]
            rd_s = -y - zl[:, n:] + zu[:, n:]
            # fixed coordinates carry an implicit free multiplier that
            # absorbs their dual residual exactly
            rd_x = torch.where(fixed_x, 0.0, rd_x)
            rd_s = torch.where(fixed_s, 0.0, rd_s)
            rp = g_con(A, x) - s
            return rd_x, rd_s, rp, J

        def kkt_error(z, y, zl, zu, rd_x, rd_s, rp):
            dl, du = distances(z)
            comp = torch.where(fin_l, dl * zl, 0.0).sum(dim=1) + \
                torch.where(fin_u, du * zu, 0.0).sum(dim=1)
            mu = comp / nb
            sd = torch.clamp((y.abs().sum(dim=1) + zl.sum(dim=1) +
                              zu.sum(dim=1)) / (n + m), min=1.0)
            err = torch.maximum(
                _amax0(rp.abs()),
                torch.maximum(
                    torch.cat([rd_x, rd_s], dim=1).abs().amax(dim=1) / sd,
                    mu / sd))
            return err.to(F64), mu

        def _cert_clamp_t(y, e=e64):
            t = -y.to(e["dt"])
            tc = torch.where((t > 0) & ~e["fin_clb"], 0.0, t)
            return torch.where((tc < 0) & ~e["fin_cub"], 0.0, tc)

        def _rc_clamp(r, e=e64):
            rc = torch.where((r > 0) & ~e["fin_vlb"], 0.0, r)
            return torch.where((rc < 0) & ~e["fin_vub"], 0.0, rc)

        def _row_term(tc, e=e64):
            return torch.where(tc > 0, tc * e["clb"],
                               torch.where(tc < 0, tc * e["cub"],
                                           0.0)).sum(dim=1)

        def _col_term(rc, e=e64):
            return torch.where(rc > 0, rc * e["vlb"],
                               torch.where(rc < 0, rc * e["vub"],
                                           0.0)).sum(dim=1)

        def _cert_lp_terms(tc, r, const, e=e64):
            rc = _rc_clamp(r, e)
            slack_pen = ((r - rc).abs() * e["box"]).sum(dim=1)
            b = _row_term(tc, e) + _col_term(rc, e) - slack_pen + const
            return torch.where(torch.isnan(b), -_BIG, b)

        def _cert_qp_terms(tc, quad_min, r0):
            rc = _rc_clamp(r0)
            pen = ((r0 - rc).abs() * e64["box"]).sum(dim=1)
            b = _row_term(tc) + quad_min + _col_term(rc) - pen + sp.obj_const
            return torch.where(torch.isnan(b), -_BIG, b)

        def _cert_scale(tc, r, mat_mag, e=e64):
            rc = _rc_clamp(r, e)
            slack_pen = ((r - rc).abs() * e["box"]).sum(dim=1)
            return ((tc.abs() * e["abs_clb"]).sum(dim=1) +
                    (tc.abs() * e["abs_cub"]).sum(dim=1) +
                    (rc.abs() * e["box"]).sum(dim=1) + slack_pen + mat_mag)

        def farkas_infeasible(y, margin, e=e64):
            """Certified infeasibility: min over the box of y.(Ax - s) > 0
            (cert_bound_generic with cvec = 0), evaluated in e's dtype:
            f64 for the final statuses, f32 (margin 1e-4) for the light
            phase's in-loop exits, which are re-confirmed in f64."""
            tc = _cert_clamp_t(y, e)
            Ae, absAe = (A, A.abs()) if e["dt"] == F64 else (A32, absA32)
            r = -Ae.tv(tc)
            g0 = _cert_lp_terms(tc, r, 0.0, e)
            mat_mag = absAe.tv(tc.abs()).sum(dim=1)
            return g0 > margin * (1.0 + _cert_scale(tc, r, mat_mag, e))

        def farkas_sp(y):
            """In-loop Farkas test via split-f32 products; every exit is
            re-confirmed in f64 after the loop."""
            tc = _cert_clamp_t(y)
            r = -A_sp.tv(tc)
            rc = _rc_clamp(r)
            slack_pen = ((r - rc).abs() * e64["box"]).sum(dim=1)
            g0 = _row_term(tc) + _col_term(rc) - slack_pen
            g0 = torch.where(torch.isnan(g0), -_BIG, g0)
            mat_mag = absA32.tv(tc.abs().to(F32)).sum(dim=1).to(F64)
            return g0 > 1e-5 * (1.0 + _cert_scale(tc, r, mat_mag))

        def qp_cert_bound(y):
            tc = _cert_clamp_t(y)
            r = c_in - A.tv(tc)
            alpha = r @ q_eigV
            quad_min = -0.25 * torch.where(
                q_wpos, alpha * alpha / torch.clamp(q_eigw, min=1e-30),
                0.0).sum(dim=1)
            r0 = torch.where(q_wpos, 0.0, alpha) @ q_eigV.T
            return _cert_qp_terms(tc, quad_min, r0)

        def dual_cert_bound(y):
            tc = _cert_clamp_t(y)
            return _cert_lp_terms(tc, c_in - A.tv(tc), sp.obj_const)

        if is_lp:
            cert_f64 = dual_cert_bound

            def cert_proxy(y):
                tc = _cert_clamp_t(y)
                r = c_in - A_sp.tv(tc)
                return _cert_lp_terms(tc, r, sp.obj_const)
        elif q_psd:
            cert_f64 = qp_cert_bound

            def cert_proxy(y):
                tc = _cert_clamp_t(y)
                r = c_in - A_sp.tv(tc)
                alpha = qV_sp.tv(r)
                quad_min = -0.25 * torch.where(
                    q_wpos, alpha * alpha / torch.clamp(q_eigw, min=1e-30),
                    0.0).sum(dim=1)
                r0 = qV_sp.mv(torch.where(q_wpos, 0.0, alpha))
                return _cert_qp_terms(tc, quad_min, r0)
        else:
            cert_f64 = None
            cert_proxy = None

        def make_step(use_f32, sopts=opts, light=False, ratchet=True):
            """One IPM iteration on every lane (see the JAX make_step).
            `use_f32` picks the factor dtype; `light` runs the iteration
            arithmetic (residuals, assembly, solve chain, corrections,
            trial, Farkas test) in f32, else it is f64.  NL steps always
            factor in f64 (build_single_solver turns factor_f32 off)."""
            fdt = F32 if use_f32 else F64
            dt = F32 if light else F64
            adt = fdt if (light or sopts.light_assembly) else dt
            Qsym_a = (Qsym32 if adt == F32 else Qsym) if has_q else None
            # the solve chain's operator and fixed-variable mask
            A_d, mx_d = A.to(dt), (mx32 if dt == F32 else mx64)
            # block-correction residual dtype (LP/QP with f32 factors)
            cdt = F32 if (light or sopts.tail_corr_f32) else F64
            A_c = A.to(cdt)

            def step(state):
                (z, y, zl, zu, k, err, mu_prev, best_db, best_y, rvec, nu,
                 stall, bz, by, bzl, bzu, berr, bmu) = state
                dl, du = distances(z)
                if has_nl:
                    # NL residuals need the fresh Jacobian/gradient anyway,
                    # so nothing is saved by carrying them
                    rd_x, rd_s, rp, J = residuals_nl(z, y, zl, zu)
                else:
                    # LP/QP residuals at the current point are the previous
                    # iteration's trial residuals, carried
                    rd_x, rd_s, rp = rvec[:, :n], rvec[:, n:n + m], \
                        rvec[:, n + m:]
                comp = torch.where(fin_l, dl * zl, 0.0).sum(dim=1) + \
                    torch.where(fin_u, du * zu, 0.0).sum(dim=1)
                mu = comp / nb

                Dz = torch.where(fin_l, zl / dl, 0.0) + \
                    torch.where(fin_u, zu / du, 0.0)
                Dz = torch.where(fixed, PIN, Dz)
                Dx_diag = torch.where(fixed_x, 1.0, Dz[:, :n] + sopts.reg_primal)
                Ds = Dz[:, n:] + sopts.reg_dual

                if condense_x and has_nl:
                    # x-space normal equations Mx = W + Dx + J_in' Ds J_in
                    # per lane, with the equality rows' Schur block; fixed
                    # variables exactly eliminated (column-masked J, masked
                    # W, unit diagonal, zero rhs)
                    ineq_w = torch.where(eq_mask, 0.0, Ds) if m_eq else Ds
                    Jm = as_operator(torch.where(fixed_x[:, None, :], 0.0,
                                                 J.data))
                    W = hess_W(z[:, :n], y)
                    wmask = (~fixed_x)[:, :, None] & (~fixed_x)[:, None, :]
                    W = torch.where(wmask, W, 0.0)
                    Mx = torch.diag_embed(Dx_diag) + Jm.gram(ineq_w) + W
                    solve_mx, _ = _make_spd_solver(Mx, sopts, use_f32,
                                                   out_dtype=F64, run=run)
                    if m_eq:
                        Je = Jm.rows(eq_rows)
                        MeJ = solve_mx(Je.data.mT)
                        S = torch.matmul(Je.data, MeJ) + \
                            1e-10 * torch.eye(m_eq, dtype=F64, device=dev)
                        solve_s, _ = _make_spd_solver(S, sopts, use_f32,
                                                      out_dtype=F64, run=run)

                    def raw_xyz(rhs1, rhs2, rhs3):
                        rx = rhs1 + Jm.tv(ineq_w * rhs3 + rhs2)
                        rx = torch.where(fixed_x, 0.0, rx)
                        if m_eq:
                            t = solve_mx(rx)
                            dy_eq = solve_s(Je.mv(t) - rhs3[:, eq_rows])
                            dx = t - torch.matmul(MeJ, dy_eq[:, :, None])[:, :, 0]
                        else:
                            dx = solve_mx(rx)
                        dx = torch.where(fixed_x, 0.0, dx)
                        ds = J.mv(dx) - rhs3
                        dy = Ds * ds - rhs2
                        if m_eq:
                            ds = torch.where(eq_mask, 0.0, ds)
                            dy = dy.index_copy(1, eq_rows, dy_eq)
                        return dx, ds, dy

                    def solve_xyz(rhs1, rhs2, rhs3, rounds):
                        # f64 factors: no block-level defect correction
                        return raw_xyz(rhs1, rhs2, rhs3)
                elif condense_x:
                    # x-space normal equations over inequality rows plus
                    # an explicit Schur block for equality rows; fixed
                    # variables eliminated through the factored mask.
                    # Assembly in the factor dtype, the solve chain in
                    # the iteration dtype dt
                    Ds_d = Ds.to(dt)
                    ineq_w = torch.where(eq_mask, 0.0, Ds_d) if m_eq else Ds_d
                    mxa = mx64.to(adt)
                    w_a = ineq_w.to(adt)
                    gram = A.to(adt).gram(w_a)
                    core = gram if is_lp else gram + Qsym_a
                    Mx = core * (mxa[:, :, None] * mxa[:, None, :]) + \
                        torch.diag_embed(Dx_diag.to(dt).to(adt))
                    solve_mx, _ = _make_spd_solver(Mx, sopts, use_f32,
                                                   out_dtype=dt, run=run)
                    if m_eq:
                        Ae = A_d.rows(eq_rows)
                        MeJ = solve_mx(mx_d[:, :, None] * Ae.data.mT)
                        S = torch.matmul(Ae.data, mx_d[:, :, None] * MeJ) + \
                            1e-10 * torch.eye(m_eq, dtype=dt, device=dev)
                        solve_s, _ = _make_spd_solver(S, sopts, use_f32,
                                                      out_dtype=dt, run=run)

                    def raw_xyz(rhs1, rhs2, rhs3):
                        r2, r3 = rhs2.to(dt), rhs3.to(dt)
                        rx = rhs1 + mx_d * A_d.tv(ineq_w * r3 + r2)
                        rx = torch.where(fixed_x, 0.0, rx)
                        if m_eq:
                            t = solve_mx(rx)
                            dy_eq = solve_s(Ae.mv(mx_d * t) - r3[:, eq_rows])
                            dx = t - torch.matmul(MeJ, dy_eq[:, :, None])[:, :, 0]
                        else:
                            dx = solve_mx(rx)
                        dx = torch.where(fixed_x, 0.0, dx)
                        ds = A_d.mv(dx) - r3
                        dy = Ds_d * ds - r2
                        if m_eq:
                            # equality slacks do not move; their
                            # multipliers come from the Schur block
                            ds = torch.where(eq_mask, 0.0, ds)
                            dy = dy.index_copy(1, eq_rows, dy_eq)
                        return dx, ds, dy

                    def corr_resid(dxc, dsc, dyc):
                        # residuals against the structured operator in cdt
                        # (f32 products against the f32 copies, or f64
                        # ones)
                        wdx = Dx_diag.to(cdt) * dxc
                        if cdt == F32:
                            if not is_lp:
                                wdx = wdx + mx32 * ((mx32 * dxc) @ Qsym32)
                            jt = A_c.tv(dyc)
                        else:
                            if not is_lp:
                                wdx = wdx + mx64 * ((mx64 * dxc) @ Qsym)
                            jt = mx64 * A_c.tv(dyc)
                        jdx = A_c.mv(dxc)
                        return wdx + jt, Ds.to(cdt) * dsc - dyc, jdx - dsc

                    def solve_xyz(rhs1, rhs2, rhs3, rounds):
                        dx, ds, dy = raw_xyz(rhs1, rhs2, rhs3)
                        if use_f32:
                            for _ in range(rounds):
                                r1, r2, r3 = corr_resid(
                                    dx.to(cdt), ds.to(cdt), dy.to(cdt))
                                e1 = torch.where(fixed_x, 0.0,
                                                 rhs1.to(cdt) - r1)
                                e2 = rhs2.to(cdt) - r2
                                e3 = rhs3.to(cdt) - r3
                                if m_eq:
                                    e2 = torch.where(eq_mask, 0.0, e2)
                                cx, cs, cy = raw_xyz(e1, e2, e3)
                                dx, ds, dy = dx + cx, ds + cs, dy + cy
                        return dx, ds, dy
                else:
                    # m-space normal equations for skinny LPs:
                    # M = A H^-1 A' + Ds^-1 (m x m)
                    Ds_d = Ds.to(dt)
                    Hinv = torch.where(fixed_x, 0.0, 1.0 / Dx_diag).to(dt)
                    Ha = Hinv.to(adt)
                    Mf = A.to(adt).row_gram(Ha) + \
                        torch.diag_embed((1.0 / Ds_d).to(adt))
                    solve_m, _ = _make_spd_solver(Mf, sopts, use_f32,
                                                  out_dtype=dt, run=run)

                    def raw_m(rhs1, rhs2, rhs3):
                        r1, r2 = rhs1.to(dt), rhs2.to(dt)
                        rhs_y = A_d.mv(Hinv * r1) - rhs3.to(dt) - r2 / Ds_d
                        dy = solve_m(rhs_y)
                        dx = Hinv * (r1 - A_d.tv(dy))
                        ds = (dy + r2) / Ds_d
                        return dx, ds, dy

                    def solve_xyz(rhs1, rhs2, rhs3, rounds):
                        dx, ds, dy = raw_m(rhs1, rhs2, rhs3)
                        if use_f32:
                            cDx, cDs = Dx_diag.to(cdt), Ds.to(cdt)
                            for _ in range(rounds):
                                dxc, dsc, dyc = dx.to(cdt), ds.to(cdt), \
                                    dy.to(cdt)
                                jt = A_c.tv(dyc)
                                jdx = A_c.mv(dxc)
                                e1 = torch.where(
                                    fixed_x, 0.0,
                                    rhs1.to(cdt) - (cDx * dxc + jt))
                                e2 = rhs2.to(cdt) - (cDs * dsc - dyc)
                                e3 = rhs3.to(cdt) - (jdx - dsc)
                                cx, cs, cy = raw_m(e1, e2, e3)
                                dx, ds, dy = dx + cx, ds + cs, dy + cy
                        return dx, ds, dy

                def solve_dirs(sig_mu, dcl, dcu, rounds, rc=None,
                               resid=True):
                    """dcl/dcu: extra complementarity terms.  rc=(rc_l,
                    rc_u) gives the complementarity rhs directly (Gondzio
                    corrections); resid=False drops the KKT residual
                    terms (a pure direction correction)."""
                    if rc is None:
                        rc_l = torch.where(fin_l, sig_mu - dl * zl - dcl, 0.0)
                        rc_u = torch.where(fin_u, sig_mu - du * zu - dcu, 0.0)
                    else:
                        rc_l, rc_u = rc
                    t_l = torch.where(fin_l, rc_l / dl, 0.0)
                    t_u = torch.where(fin_u, rc_u / du, 0.0)
                    rhs1 = t_l[:, :n] - t_u[:, :n]
                    rhs2 = t_l[:, n:] - t_u[:, n:]
                    if resid:
                        rhs1, rhs2, rhs3 = rhs1 - rd_x, rhs2 - rd_s, -rp
                    else:
                        rhs3 = torch.zeros_like(rp)
                    dx, ds, dy = solve_xyz(rhs1, rhs2, rhs3, rounds)
                    dz = torch.cat([dx, ds], dim=1)
                    dzl = torch.where(fin_l, (rc_l - zl * dz) / dl, 0.0)
                    dzu = torch.where(fin_u, (rc_u + zu * dz) / du, 0.0)
                    return dz, dy, dzl, dzu

                # predictor (affine)
                aff_rounds = sopts.kkt_rounds \
                    if sopts.affine_kkt_rounds is None \
                    else min(sopts.affine_kkt_rounds, sopts.kkt_rounds)
                dz_a, dy_a, dzl_a, dzu_a = solve_dirs(0.0, 0.0, 0.0,
                                                      aff_rounds)
                ap = torch.minimum(_max_step(dl, dz_a, 1.0, fin_l),
                                   _max_step(du, -dz_a, 1.0, fin_u))
                ad = torch.minimum(_max_step(zl, dzl_a, 1.0, fin_l),
                                   _max_step(zu, dzu_a, 1.0, fin_u))
                dl_a = dl + ap[:, None] * dz_a
                du_a = du - ap[:, None] * dz_a
                mu_aff = (torch.where(fin_l, dl_a * (zl + ad[:, None] * dzl_a),
                                      0.0).sum(dim=1) +
                          torch.where(fin_u, du_a * (zu + ad[:, None] * dzu_a),
                                      0.0).sum(dim=1)) / nb
                sigma = torch.clamp(
                    (mu_aff / torch.clamp(mu, min=1e-300)) ** sopts.sigma_pow,
                    0.0, 1.0)

                # corrector
                dz_c, dy_c, dzl_c, dzu_c = solve_dirs(
                    (sigma * mu)[:, None], dz_a * dzl_a, -dz_a * dzu_a,
                    sopts.kkt_rounds)

                if (not has_nl) and sopts.gondzio_correctors > 0:
                    # Gondzio multiple centrality corrections: at an
                    # enlarged trial step, clip outlier complementarity
                    # products back into [0.1, 10] x target-mu, re-solve
                    # with that complementarity-only rhs (same
                    # factorization, one more solve), and keep the
                    # corrected direction per lane only where it
                    # lengthens the combined step
                    mu_g = torch.clamp(sigma * mu, min=1e-300)[:, None]
                    for _ in range(sopts.gondzio_correctors):
                        ap_c = torch.minimum(
                            _max_step(dl, dz_c, sopts.tau, fin_l),
                            _max_step(du, -dz_c, sopts.tau, fin_u))
                        ad_c = torch.minimum(
                            _max_step(zl, dzl_c, sopts.tau, fin_l),
                            _max_step(zu, dzu_c, sopts.tau, fin_u))
                        ape = torch.clamp(1.5 * ap_c, max=1.0)[:, None]
                        ade = torch.clamp(1.5 * ad_c, max=1.0)[:, None]
                        vl = torch.clamp(dl + ape * dz_c, min=0.0) * \
                            torch.clamp(zl + ade * dzl_c, min=0.0)
                        vu = torch.clamp(du - ape * dz_c, min=0.0) * \
                            torch.clamp(zu + ade * dzu_c, min=0.0)
                        rc_l = torch.where(fin_l, torch.clamp(
                            vl, 0.1 * mu_g, 10.0 * mu_g) - vl, 0.0)
                        rc_u = torch.where(fin_u, torch.clamp(
                            vu, 0.1 * mu_g, 10.0 * mu_g) - vu, 0.0)
                        gdz, gdy, gdzl, gdzu = solve_dirs(
                            0.0, 0.0, 0.0, 1, rc=(rc_l, rc_u), resid=False)
                        dz_g, dy_g = dz_c + gdz, dy_c + gdy
                        dzl_g, dzu_g = dzl_c + gdzl, dzu_c + gdzu
                        ap_g = torch.minimum(
                            _max_step(dl, dz_g, sopts.tau, fin_l),
                            _max_step(du, -dz_g, sopts.tau, fin_u))
                        ad_g = torch.minimum(
                            _max_step(zl, dzl_g, sopts.tau, fin_l),
                            _max_step(zu, dzu_g, sopts.tau, fin_u))
                        acc = (ap_g + ad_g) > (ap_c + ad_c + 0.02)
                        dz_c = _sel(acc, dz_g, dz_c)
                        dy_c = _sel(acc, dy_g, dy_c)
                        dzl_c = _sel(acc, dzl_g, dzl_c)
                        dzu_c = _sel(acc, dzu_g, dzu_c)

                ap = torch.minimum(_max_step(dl, dz_c, sopts.tau, fin_l),
                                   _max_step(du, -dz_c, sopts.tau, fin_u))
                ad = torch.minimum(_max_step(zl, dzl_c, sopts.tau, fin_l),
                                   _max_step(zu, dzu_c, sopts.tau, fin_u))
                if has_nl:
                    ap = ad = torch.minimum(ap, ad)
                mu_t = sigma * mu
                # exact-penalty weight: monotone non-decreasing across
                # iterations (carried in `nu`)
                nu_pen = torch.maximum(nu, 10.0 * (1.0 + _amax0(y.abs())))

                def trial(scale):
                    zt = z + (scale * ap)[:, None] * dz_c
                    yt = y + (scale * ad)[:, None] * dy_c
                    zlt = torch.where(fin_l, torch.clamp(
                        zl + (scale * ad)[:, None] * dzl_c, min=1e-300), 0.0)
                    zut = torch.where(fin_u, torch.clamp(
                        zu + (scale * ad)[:, None] * dzu_c, min=1e-300), 0.0)
                    rd_xt, rd_st, rpt = (residuals32 if light else
                                         residuals)(zt, yt, zlt, zut)
                    errt, mut = kkt_error(zt, yt, zlt, zut, rd_xt, rd_st, rpt)
                    merit = None
                    if has_nl:
                        # exact-penalty merit: barrier objective + nu *
                        # primal infeasibility (see the JAX trial)
                        dlt, dut = distances(zt)
                        bar = -mu_t * (
                            torch.where(fin_l, torch.log(dlt), 0.0).sum(dim=1) +
                            torch.where(fin_u, torch.log(dut), 0.0).sum(dim=1))
                        theta = rpt.abs().sum(dim=1)
                        merit = f_obj(zt[:, :n], c_in) + bar + nu_pen * theta
                    rvt = torch.cat([rd_xt, rd_st, rpt], dim=1)
                    return (zt, yt, zlt, zut, errt, mut, merit, rvt)

                if has_nl:
                    # merit line search over a fixed scale ladder: the
                    # largest scale that decreases the merit, the KKT
                    # error, or (while infeasible) the primal
                    # infeasibility by >= 10%; else the smallest step
                    theta0 = rp.abs().sum(dim=1)
                    m0 = trial(0.0)[-2]
                    cands = [trial(sc) for sc in (0.01, 0.05, 0.25, 1.0)]
                    sel = cands[0]
                    for cand in cands[1:]:
                        tht = cand[-1][:, n + m:].abs().sum(dim=1)
                        acc = ((cand[-2] < m0 - 1e-12) | (cand[4] < err) |
                               ((theta0 > 1e-6) & (tht < 0.9 * theta0))) & \
                            torch.isfinite(cand[-2])
                        sel = tuple(_sel(acc, a, b) for a, b in zip(cand, sel))
                    z_new, y_new, zl_new, zu_new, err2, mu2, _, rvec2 = sel
                else:
                    # full step (the LP/QP path has no line search)
                    (z_new, y_new, zl_new, zu_new, err2, mu2, _,
                     rvec2) = trial(1.0)

                # NaN guard: keep the previous iterate and stop (err -1)
                ok = torch.isfinite(err2) & torch.isfinite(z_new).all(dim=1)
                z_new = _sel(ok, z_new, z)
                y_new = _sel(ok, y_new, y)
                zl_new = _sel(ok, zl_new, zl)
                zu_new = _sel(ok, zu_new, zu)
                err2 = torch.where(ok, err2, -1.0)
                mu2 = torch.where(ok, mu2, mu_prev)
                rvec2 = _sel(ok, rvec2, rvec)

                if ratchet and cert_proxy is not None:
                    # split-f32 SELECTION of the best dual candidate; the
                    # sound bound is re-evaluated in f64 after the loop
                    db_new = cert_proxy(y_new)
                    db_bet = db_new > best_db
                    best_db = torch.where(db_bet, db_new, best_db)
                    best_y = _sel(db_bet, y_new, best_y)
                if not has_nl:
                    # certified Farkas exit (err = -2 sentinel), confirmed
                    # in f64 after the loop; the light phase tests in f32
                    # at a wider margin
                    fk = farkas_infeasible(y_new, 1e-4, e32) if light \
                        else farkas_sp(y_new)
                    err2 = torch.where(fk, -2.0, err2)
                # best-state ratchet
                better = (err2 >= 0.0) & (err2 < berr)
                bz2, by2 = _sel(better, z_new, bz), _sel(better, y_new, by)
                bzl2, bzu2 = _sel(better, zl_new, bzl), _sel(better, zu_new, bzu)
                berr2 = torch.where(better, err2, berr)
                bmu2 = torch.where(better, mu2, bmu)
                nu2 = torch.maximum(nu_pen, torch.clamp(
                    10.0 * (1.0 + _amax0(y_new.abs())), max=1e10))
                stall2 = torch.where(better, torch.zeros_like(stall), stall + 1)
                if has_nl:
                    # lane restart (Ipopt's restoration fallback, see the
                    # JAX step): a lane whose best KKT error has not
                    # improved for 25 iterations, or that stopped on a NaN,
                    # re-centers between its best iterate and the box
                    # midpoint with reset multipliers.  Only the iterate is
                    # reset; the best-state ratchet keeps everything sound
                    do_rst = ((stall2 >= 25) & (berr2 > 1e-3)) | \
                        (err2 == -1.0)
                    mid = torch.where(fin_l & fin_u, 0.5 * (lz + uz),
                                      torch.where(fin_l, lz + 1.0,
                                                  torch.where(fin_u, uz - 1.0,
                                                              0.0)))
                    z_rst = clampz(0.5 * bz2 + 0.5 * mid)
                    z_new = _sel(do_rst, z_rst, z_new)
                    y_new = _sel(do_rst, torch.zeros_like(y_new), y_new)
                    zl_new = _sel(do_rst, fin_l.to(F64), zl_new)
                    zu_new = _sel(do_rst, fin_u.to(F64), zu_new)
                    err2 = torch.where(do_rst, 1e6, err2)
                    mu2 = torch.where(do_rst, 1.0, mu2)
                    stall2 = torch.where(do_rst, torch.zeros_like(stall2),
                                         stall2)
                return (z_new, y_new, zl_new, zu_new, k + 1, err2, mu2,
                        best_db, best_y, rvec2, nu2, stall2,
                        bz2, by2, bzl2, bzu2, berr2, bmu2)
            return step

        def cond_to(tol_target, k_cap):
            def cond(state):
                k, err, berr = state[4], state[5], state[-2]
                go = (k < k_cap) & (berr > tol_target) & (err >= 0.0)
                if has_nl:
                    # NL lanes plateauing at the acceptable level stop
                    # (Ipopt's acceptable_tol / acceptable_iter)
                    go = go & ~((berr <= opts.acceptable_tol) &
                                (state[11] >= 10))
                return go
            return cond

        eff_tol = (max(opts.tol, opts.tail_tol)
                   if (opts.factor_f32 and opts.tail_factor_f32)
                   else opts.tol)

        rd_x0, rd_s0, rp0 = residuals(z0, y0, zl0, zu0)
        err0, mu0 = kkt_error(z0, y0, zl0, zu0, rd_x0, rd_s0, rp0)
        # carried residuals in the dtype of the first loop (the light
        # phase carries f32 residuals)
        rvec0 = torch.cat([rd_x0, rd_s0, rp0], dim=1).to(
            F32 if light_on else F64)
        ik = torch.zeros(B, dtype=torch.long, device=dev)
        full = lambda v: torch.full((B,), v, dtype=F64, device=dev)  # noqa: E731
        state0 = (z0, y0, zl0, zu0, ik, err0, mu0, full(-_BIG), y0, rvec0,
                  full(10.0), ik.clone(), z0, y0, zl0, zu0, err0, mu0)
        if opts.factor_f32:
            # two-phase: f32-factorized iterations until moderately
            # converged, then the tail with its own budget
            switch_tol = max(opts.tol, 1e-4)
            cap1 = max(1, opts.max_iters // 2)
            state1 = run.loop(cond_to(switch_tol, cap1),
                            make_step(True, light=light_on, ratchet=False),
                            state0)
            (z1, y1, zl1, zu1, k1, err1, mu1, bdb1, bY1, _rv1, nu1, st1,
             bz1, by1, bzl1, bzu1, berr1, bmu1) = state1
            # hand the tail the BEST phase-1 iterate
            use_b = (err1 == -1.0) | ((err1 >= 0.0) & (berr1 < err1))
            zm, ym = _sel(use_b, bz1, z1), _sel(use_b, by1, y1)
            zlm, zum = _sel(use_b, bzl1, zl1), _sel(use_b, bzu1, zu1)
            rxm, rsm, rpm = residuals(zm, ym, zlm, zum)
            rvm = torch.cat([rxm, rsm, rpm], dim=1)
            state1 = (zm, ym, zlm, zum, k1, torch.where(use_b, berr1, err1),
                      torch.where(use_b, bmu1, mu1), bdb1, bY1, rvm, nu1, st1,
                      bz1, by1, bzl1, bzu1, berr1, bmu1)
            if opts.tail_factor_f32:
                tail_step = make_step(True, dataclasses.replace(
                    opts, kkt_rounds=opts.tail_kkt_rounds))
            else:
                tail_step = make_step(False)
            state2 = run.loop(cond_to(opts.tol, cap1 + opts.max_iters),
                            tail_step, state1)
            polish_step = tail_step
        else:
            polish_step = make_step(False)
            state2 = run.loop(cond_to(opts.tol, opts.max_iters),
                            make_step(False), state0)
        if cert_f64 is not None:
            # one extra ratcheted step shrinks the dual residual (and the
            # certificate gap); sentinel lanes keep their exited state
            state3 = polish_step(state2)
            keep2 = state2[5] < 0.0
            state2 = _sel_state(keep2, state2, state3)
        (z, y, zl, zu, iters, err, mu, best_db, best_y, _rvf, _nuf, _stf,
         bz, by, bzl, bzu, berr, bmu) = state2
        # report the best iterate seen, not the last
        take_b = (err == -1.0) | ((err >= 0.0) & (berr < err))
        z, y = _sel(take_b, bz, z), _sel(take_b, by, y)
        zl, zu = _sel(take_b, bzl, zl), _sel(take_b, bzu, zu)
        err, mu = torch.where(take_b, berr, err), torch.where(take_b, bmu, mu)

        x = z[:, :n]
        obj = f_obj(x, c_in) + sp.obj_const

        # ---- final f64 recomputation --------------------------------------
        rd_xf, rd_sf, rpf = residuals(z, y, zl, zu)
        err_f, mu_f = kkt_error(z, y, zl, zu, rd_xf, rd_sf, rpf)
        sent = err < 0.0
        err = torch.where(sent, err, err_f)
        mu = torch.where(sent, mu, mu_f)

        # ---- certified dual bound (exact for LP/PSD-QP) -------------------
        trust = torch.where((err <= eff_tol * 100) & (err >= 0.0),
                            obj - torch.clamp(10.0 * err, min=1e-7) *
                            (1.0 + obj.abs()), -_BIG)
        if is_lp:
            cert_db = torch.maximum(dual_cert_bound(best_y), dual_cert_bound(y))
            dual_bound = cert_db
        elif q_psd:
            cert_db = torch.maximum(qp_cert_bound(best_y), qp_cert_bound(y))
            dual_bound = torch.maximum(cert_db, trust)
        else:
            # convex NLP: trust the converged KKT point with a tolerance
            # margin (the reference trusts Ipopt the same way)
            cert_db = full(-_BIG)
            dual_bound = trust

        prim_err = _amax0(rpf.abs())
        empty_box = (lz > uz + 1e-12).any(dim=1)
        farkas = err == -2.0
        if not has_nl:
            farkas = farkas & farkas_infeasible(y, 1e-5)
        converged = (err <= eff_tol) & (err >= 0.0) & ~empty_box
        if has_nl:
            # acceptable-level acceptance: scaled KKT error at the
            # acceptable threshold AND primal feasible
            converged = converged | (
                (err <= opts.acceptable_tol) & (err >= 0.0) &
                (prim_err <= 1e-6) & ~empty_box)
            # no certificate exists for nonlinear rows: the mu-collapse
            # heuristic (the reference trusts Ipopt's infeasibility)
            heur_infeas = (~converged) & (prim_err > 1e-6) & \
                (mu < opts.infeas_mu)
        else:
            gap_closed = cert_db >= obj - eff_tol * (1.0 + obj.abs())
            cert_opt = gap_closed & (prim_err <= 1e-6) & (err >= 0.0) & \
                ~empty_box
            converged = converged | cert_opt
            # LP/QP: infeasibility claims REQUIRE the Farkas certificate
            heur_infeas = dual_bound > 1e15
        infeasible = empty_box | farkas | heur_infeas
        dual_bound = torch.where(empty_box | farkas, _BIG, dual_bound)
        status = torch.where(
            converged, int(EngineStatus.SOLVED_OPTIMAL),
            torch.where(infeasible, int(EngineStatus.SOLVED_INFEASIBLE),
                        int(EngineStatus.ITERATION_LIMIT))).to(torch.int32)
        return IPMResult(x=x, obj=obj, dual_bound=dual_bound, y=y,
                         status=status, iters=iters, kkt_err=err)

    def with_objective(A, clb, cub, vlb, vub, x0, c_in, y0=None):
        return solve_impl(A, clb, cub, vlb, vub, x0, c_in, y0)

    def solve_one(A, clb, cub, vlb, vub, x0, y0=None):
        return solve_impl(A, clb, cub, vlb, vub, x0, c_const, y0)

    solve_one.with_objective = with_objective
    solve_one.device = dev
    solve_one.tapes = tapes
    return solve_one


def to_device(a, device) -> torch.Tensor:
    """float64 tensor on `device` from numpy or torch input."""
    return torch.as_tensor(a, dtype=F64, device=device)


def build_batch_solver(sp: StagedProblem, opts: IPMOptions = IPMOptions(),
                       device="cuda") -> Callable:
    """Returns solve(A, clb, cub, vlb_b, vub_b, x0_b=None) -> IPMResult
    with numpy fields, plus `solve.dispatch` (returns the packed
    (B, n+m+5) float64 device tensor) and `solve.unpack` (one
    device-to-host copy), in the JAX package's packed layout."""
    n, m = sp.n, sp.m
    solve_one = build_single_solver(sp, opts, device)
    dev = solve_one.device

    has_nl = bool(len(sp.nl_rows)) or sp.obj_nl is not None

    def dispatch(A, clb, cub, vlb_b, vub_b, x0_b=None):
        vlb_b = to_device(vlb_b, dev)
        vub_b = to_device(vub_b, dev)
        if x0_b is None:
            if has_nl:
                # cold NL starts use the box midpoint: zero starts land
                # nonconvex models in infeasible merit attractors
                lo = torch.where(torch.isfinite(vlb_b), vlb_b, -1.0)
                hi = torch.where(torch.isfinite(vub_b), vub_b, 1.0)
                x0_b = 0.5 * (lo + hi)
            else:
                x0_b = torch.zeros((vlb_b.shape[0], n), dtype=F64,
                                   device=dev)
        r = solve_one(to_device(A, dev).reshape(m, n), to_device(clb, dev),
                      to_device(cub, dev), vlb_b, vub_b, to_device(x0_b, dev))
        # certified bounds are never downcast: the packed layout is f64
        if r.x.dtype != F64 or r.dual_bound.dtype != F64:
            raise TypeError("build_batch_solver: packed result must be "
                            "float64 (certified bounds are never downcast)")
        return torch.cat(
            [r.x, r.y, r.obj[:, None], r.dual_bound[:, None],
             r.status[:, None].to(F64), r.iters[:, None].to(F64),
             r.kkt_err[:, None]], dim=1)

    def _unpack(arr) -> IPMResult:
        if isinstance(arr, torch.Tensor):
            with trace.span("step.fetch"):
                arr = arr.cpu().numpy()
        arr = np.asarray(arr)
        return IPMResult(
            x=arr[:, :n], y=arr[:, n:n + m],
            obj=arr[:, n + m], dual_bound=arr[:, n + m + 1],
            status=arr[:, n + m + 2].astype(np.int32),
            iters=arr[:, n + m + 3].astype(np.int32),
            kkt_err=arr[:, n + m + 4])

    def solve(A, clb, cub, vlb_b, vub_b, x0_b=None):
        return _unpack(dispatch(A, clb, cub, vlb_b, vub_b, x0_b))

    solve.dispatch = dispatch
    solve.unpack = _unpack
    return solve
