"""The benchmark's instance families."""

import numpy as np
import pytest

from benchmark.generators import intquad, qkp_ghs

SIZES = dict(n=100, density=0.25, p_max=100, w_max=50, c_min=50)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_intquad_data_is_the_ports(seed):
    from minotaur_tpu_torch.models.convex_suite2 import _intquad_data
    for a, b in zip(intquad.data(300, 4, seed), _intquad_data(300, 4, seed)):
        np.testing.assert_array_equal(a, b)


def test_intquad_instance_is_the_ports_permuted():
    """Variable j of the run's instance is the port's variable perm[j]."""
    from benchmark.harness.problem import to_problem
    from minotaur_tpu_torch.models.convex_suite2 import intquad as port
    p = port(30, 4, 0)
    inst = intquad.generate({"n": 30, "u": 4}, 0, 2 ** 31 + 99, 0)
    mine = to_problem(inst)
    rng = np.random.default_rng(1)
    for _ in range(3):
        x = rng.integers(0, 5, 30).astype(float)
        y = np.empty(30)
        y[inst["perm"]] = x
        assert abs(p.eval_objective(y) - mine.eval_objective(x)) < 1e-9
        assert np.allclose(p.eval_constraints(y), mine.eval_constraints(x))


def test_ghs_class_properties():
    P, w, c = qkp_ghs.data(seed=0, **SIZES)
    n = SIZES["n"]
    assert P.shape == (n, n) and np.all(np.tril(P, -1) == 0)
    nz = P[np.triu(np.ones((n, n), bool))]
    assert set(np.unique(nz[nz > 0])) <= set(range(1, 101))
    share = (nz > 0).mean()
    assert 0.22 < share < 0.28
    assert w.min() >= 1 and w.max() <= 50 and np.all(w == np.round(w))
    assert 50 <= c <= w.sum()


def test_ghs_density_over_draws():
    shares = [(qkp_ghs.data(seed=s, **SIZES)[0] > 0).sum() /
              (SIZES["n"] * (SIZES["n"] + 1) / 2) for s in range(20)]
    assert abs(np.mean(shares) - 0.25) < 0.005


@pytest.mark.parametrize("gen,sizes", [
    (intquad, {"n": 40, "u": 4}), (qkp_ghs, SIZES)])
def test_deterministic_by_seed(gen, sizes):
    a = gen.generate(sizes, 0, 2 ** 31 + 5, 0)
    b = gen.generate(sizes, 0, 2 ** 31 + 5, 0)
    c = gen.generate(sizes, 0, 2 ** 31 + 6, 0)
    d = gen.generate(sizes, 0, 2 ** 31 + 5, 1)
    for k in ("c", "qv", "A", "rhi"):
        np.testing.assert_array_equal(a[k], b[k])
    assert not np.array_equal(a["c"], c["c"])
    assert not np.array_equal(a["c"], d["c"])
    # another seed poses the same problem in another order
    np.testing.assert_allclose(np.sort(a["c"]), np.sort(c["c"]))
    assert a["rhi"][0] == c["rhi"][0]


def test_ghs_permutation_keeps_the_pairs():
    a = qkp_ghs.generate(SIZES, 0, 1, 0)
    P, _, _ = qkp_ghs.data(seed=0, **SIZES)
    assert len(a["qv"]) == int((np.triu(P, 1) > 0).sum())
    np.testing.assert_allclose(np.sort(a["qv"]),
                               np.sort(-P[np.triu(P, 1) > 0]))
