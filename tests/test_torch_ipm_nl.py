"""The batched IPM's NL branch: `build_batch_solver` of both packages on
the same nonlinear problems and the same 8 lanes of bound boxes.

Problems: normcon(20) (a quadratic row), expbudget(8) (an exp-sum row),
ex1223_like (exp row, quadratic objective), batchdes_like (exp
objective) and ball_mk(10) (a quadratic row with a linear part).  Lanes:
the root box and 7 seeded boxes with one to three integer variables
fixed.  Both packages run the NL branch (f64 factors, merit line search,
restarts, acceptable-level exits, cold starts at the box midpoint) in
float64 with sums in other orders, so every lane follows the same path.
Held to: statuses and iteration counts equal lane by lane; objectives
of SOLVED_OPTIMAL lanes within 1e-6 * (1 + |obj|); the dual bound (the
reference's uncertified trust margin) within 1e-6 * (1 + |obj|) of the
JAX one.

`convert` carries the NL state across: a port problem staged from a JAX
staged problem (and the Problem its bodies were read from) solves
exactly as the port's own staging does.
"""

import numpy as np
import pytest

from minotaur_tpu.engines.ipm import IPMOptions as JOpts
from minotaur_tpu.engines.ipm import build_batch_solver as jax_solver
from minotaur_tpu.engines.staging import stage_problem as jax_stage
from minotaur_tpu.models import convex_suite as JS
from minotaur_tpu_torch.convert import staged_fields, staged_from_numpy
from minotaur_tpu_torch.engines.ipm import IPMOptions, build_batch_solver
from minotaur_tpu_torch.engines.staging import stage_problem
from minotaur_tpu_torch.models import convex_suite as PS

B = 8
# 40 iterations (default 90) keep the lanes that end at the iteration
# limit cheap; the restart after 25 stalled iterations still fires
OPTS = dict(max_iters=40)
CASES = {"normcon": (20, 0), "expbudget": (8, 0), "ex1223_like": (),
         "batchdes_like": (), "ball_mk": (10, 0)}


def _lanes(sp, seed=0):
    rng = np.random.default_rng(seed)
    lo = np.tile(sp.vlb, (B, 1))
    hi = np.tile(sp.vub, (B, 1))
    ints = np.where(sp.int_mask)[0]
    for b in range(1, B):
        pick = rng.choice(ints, size=min(len(ints), 1 + b % 3), replace=False)
        v = np.floor(rng.uniform(sp.vlb[pick], sp.vub[pick] + 1))
        v = np.clip(v, sp.vlb[pick], sp.vub[pick])
        lo[b, pick] = v
        hi[b, pick] = v
    return lo, hi


@pytest.mark.parametrize("name", sorted(CASES))
def test_batch_solver_nl_matches_jax(name):
    jsp = jax_stage(getattr(JS, name)(*CASES[name]))
    sp = stage_problem(getattr(PS, name)(*CASES[name]))
    assert len(sp.nl_rows) or sp.obj_nl is not None
    lo, hi = _lanes(sp)
    jr = jax_solver(jsp, JOpts(**OPTS))(jsp.A, jsp.clb, jsp.cub, lo, hi)
    pr = build_batch_solver(sp, IPMOptions(**OPTS), device="cpu")(
        sp.A, sp.clb, sp.cub, lo, hi)
    js, ps = np.asarray(jr.status), np.asarray(pr.status)
    assert ps.tolist() == js.tolist(), (ps, js)
    assert np.asarray(pr.iters).tolist() == np.asarray(jr.iters).tolist()
    assert ps[0] == 1
    scale = 1.0 + np.abs(pr.obj)
    opt = ps == 1
    np.testing.assert_array_less(np.abs(pr.obj - np.asarray(jr.obj))[opt],
                                 1e-6 * scale[opt])
    np.testing.assert_array_less(
        np.abs(pr.dual_bound - np.asarray(jr.dual_bound))[opt],
        1e-6 * scale[opt])
    assert np.all(pr.dual_bound[opt] <= pr.obj[opt])
    assert np.all(np.isfinite(pr.x))


def test_convert_carries_nl_state():
    jp = JS.ex1223_like()
    jsp = jax_stage(jp)
    with pytest.raises(ValueError, match="Problem"):
        staged_fields(jsp)
    sp_c = staged_from_numpy(staged_fields(jsp, jp))
    sp_o = stage_problem(PS.ex1223_like())
    assert sp_c.nl_rows.tolist() == sp_o.nl_rows.tolist() == [0]
    assert [q is None for q in sp_c.nl_Q] == [True]
    assert sp_c.nl_body[0].tables[0].tolist() == \
        sp_o.nl_body[0].tables[0].tolist()
    lo, hi = _lanes(sp_o, seed=3)
    rc = build_batch_solver(sp_c, IPMOptions(), device="cpu")(
        sp_c.A, sp_c.clb, sp_c.cub, lo, hi)
    ro = build_batch_solver(sp_o, IPMOptions(), device="cpu")(
        sp_o.A, sp_o.clb, sp_o.cub, lo, hi)
    assert rc.status.tolist() == ro.status.tolist()
    np.testing.assert_array_equal(rc.obj, ro.obj)
    # a quadratic row travels as its dense Q
    jq = JS.normcon(5, 2)
    sq = staged_from_numpy(staged_fields(jax_stage(jq), jq))
    assert sq.nl_body == [None] and np.array_equal(sq.nl_Q[0], np.eye(5))
    # and the port's own staged problem round-trips without a Problem
    sr = staged_from_numpy(staged_fields(sp_o))
    assert sr.obj_graph is None and len(sr.nl_graphs) == 1
