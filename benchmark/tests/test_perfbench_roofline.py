"""The frozen bounds reproduce PERF.md's bound column."""

import pytest

from benchmark.harness.roofline import bound, k1_bound, k2_bound, \
    k2_bound_rhs


@pytest.mark.parametrize("B,k,itemsize,ms", [
    (64, 300, 4, 0.0258), (64, 1378, 4, 2.4995), (64, 1024, 4, 1.0257),
    (16, 1024, 4, 0.2564)])
def test_k1_bound_column(B, k, itemsize, ms):
    assert round(k1_bound(B, k, itemsize)[0], 4) == ms


@pytest.mark.parametrize("args,ms", [
    ((64, 300, 4, 4, 0), 0.0069), ((64, 300, 4, 4, 2), 0.0138),
    ((64, 1378, 4, 4, 2), 0.2906), ((64, 1024, 8, 8, 3), 0.3211)])
def test_k2_bound_column(args, ms):
    assert round(k2_bound(*args)[0], 4) == ms


def test_k2_rhs_extends_the_single_rhs_bound():
    for args in ((64, 300, 4, 4, 0), (64, 1378, 4, 8, 2)):
        assert k2_bound_rhs(*args, R=1) == k2_bound(*args)
        assert k2_bound_rhs(*args, R=3)[0] > k2_bound(*args)[0]


def test_bound_names_its_limit():
    assert bound(67e12, 1.0, 4)[1] == "operations"
    assert bound(1.0, 3.35e12, 4)[1] == "bytes"
