"""The measurement helpers of minotaur_tpu_torch.tools on the CPU, at a
small size (the timed runs themselves need a card)."""

import pytest

from minotaur_tpu_torch import device as mdev
from minotaur_tpu_torch.tools.profile_bnb import (_union_us, plain_kernels,
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
