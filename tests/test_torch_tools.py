"""The measurement helpers of minotaur_tpu_torch.tools on the CPU, at a
small size (the timed runs themselves need a card)."""

import pytest

from minotaur_tpu_torch import device as mdev
from minotaur_tpu_torch.tools.profile_bnb import (_neighbours, _union_us,
                                                  plain_kernels,
                                                  solve_intquad300)


@pytest.mark.parametrize("intervals, want", [
    ([], 0.0),
    ([(0, 2), (1, 3)], 3.0),             # overlap counted once
    ([(5, 6), (0, 1), (0.5, 0.75)], 2.0),  # nested and out of order
])
def test_union_of_device_intervals(intervals, want):
    assert _union_us(intervals) == want


def test_capped_search_same_through_plain_route():
    """On CPU tensors the wrappers already run their plain versions, so
    routing the IPM through them changes nothing, and no kernel counts a
    launch."""
    mdev.reset_launches()
    a = solve_intquad300(24, n=10, device="cpu")
    with plain_kernels():
        b = solve_intquad300(24, n=10, device="cpu")
    assert set(mdev.launch_counts().values()) == {0}
    for k in ("status", "nodes", "ipm_iters", "lb", "ub"):
        assert a[k] == b[k], k
    assert a["nodes"] > 0 and a["lb"] <= a["ub"]


def test_neighbours_of_a_kernel_in_device_order():
    """The kernels run just before and after each launch of a port kernel,
    in device (start time) order, whatever order the events come in."""
    from types import SimpleNamespace as NS

    def ev(name, start):
        return NS(name=name, time_range=NS(start=start))

    kern = [ev("cast", 2), ev("spd_solve_rows_kernel<float>", 3),
            ev("add", 0), ev("spd_solve_rows_kernel<float>", 1),
            ev("cast", 4)]
    assert _neighbours(kern, "spd_solve") == {
        "before": {"add": 1, "cast": 1}, "after": {"cast": 2}}
    assert _neighbours(kern, "spd_inverse") == {"before": {}, "after": {}}


def test_ipm_routes_agree_on_the_cpu():
    """On CPU tensors every route runs the plain versions, so no lane's
    status differs from the all-plain route; the batch is the root box
    plus boxes with fixed variables."""
    import numpy as np
    from minotaur_tpu_torch.engines.staging import stage_problem
    from minotaur_tpu_torch.models.convex_suite2 import intquad
    from minotaur_tpu_torch.tools.ipm_routes import (phase5_boxes,
                                                     route_statuses)
    sp = stage_problem(intquad(12, 4, 0))
    lo, hi = phase5_boxes(sp, 4)
    assert lo.shape == (4, sp.n) and np.array_equal(lo[0], sp.vlb)
    assert all((lo[b] == hi[b]).any() for b in range(1, 4))
    assert route_statuses(12, 4, device="cpu") == {
        "kernel/kernel": [], "kernel/plain": [], "plain/kernel": []}


def test_ipm_routes_batch_option_prints_a_line_a_route(capsys):
    """`--batch` names the batch in every line; on CPU tensors no route
    moves a lane's status or iteration count."""
    import json
    from minotaur_tpu_torch.tools.ipm_routes import main
    assert main(["--batch", "phase5", "--n", "12", "--lanes", "4",
                 "--device", "cpu"]) == 0
    lines = [json.loads(s) for s in capsys.readouterr().out.splitlines()]
    assert [d["route (K1/K2)"] for d in lines] == [
        "kernel/kernel", "kernel/plain", "plain/kernel"]
    assert all(d["batch"] == "phase5" and d["lanes_differing_from_plain"]
               == [] for d in lines)


def test_ipm_routes_seeded_fixings_match_phase_7():
    """The NL batch's boxes: the root box, then 1-39 variables fixed to an
    integer below `top` in each other lane, from the seed."""
    import numpy as np
    from types import SimpleNamespace as NS
    from minotaur_tpu_torch.tools.ipm_routes import _seeded_fixings
    sp = NS(n=50, vlb=np.zeros(50), vub=np.full(50, 3.0))
    lo, hi = _seeded_fixings(sp, 6, 4)
    assert np.array_equal(lo[0], sp.vlb) and np.array_equal(hi[0], sp.vub)
    for b in range(1, 6):
        fixed = lo[b] == hi[b]
        assert 1 <= fixed.sum() <= 39
        assert set(np.unique(lo[b][fixed])) <= {0.0, 1.0, 2.0, 3.0}
    lo2, _ = _seeded_fixings(sp, 6, 4)
    assert np.array_equal(lo, lo2)
