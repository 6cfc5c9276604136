"""The port's op-cost microbenchmarks (`minotaur_tpu_torch/tools/
microbench_{inv,tailops,calib}.py`) at a small size on the CPU.

Times taken here are the host clock (`clock: "host"`) and say nothing of
a card; the tests hold what the tools compute and return.

- microbench_inv at B = 2, n = 8 in f32 and f64: every inverse
  alternative (chol+cho_solve, lu_inv, solve_eye, two Newton-Schulz
  steps from the stale inverse, K1's plain version) matches numpy's f64
  inverse of the same matrix within 1e-3 relative (f32 tolerance; the
  Newton-Schulz error from the JAX script's 10% stale inverse is about
  1e-4 after two steps), and the Cholesky factor reproduces M; the
  inputs are the JAX script's (its seeded draws, its stale inverse).
- microbench_tailops at B = 2, n = 8: each op's result against numpy in
  f64, and the split-f32 matvec's error at most 1e-6 relative.
- microbench_calib at B = 2, n = 8 and a 16^3 "peak" product: the rows,
  the split-f32 error at most 1e-6 relative, and on the CPU no graph row
  (the device time is not measured here).
- Each tool returns its rows as data, and each refuses CUDA where there
  is none.
"""

import numpy as np
import pytest
import torch

from minotaur_tpu_torch.tools import (microbench_calib, microbench_inv,
                                      microbench_tailops)

CPU = torch.device("cpu")


@pytest.fixture(autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _rel(a, b):
    a, b = np.asarray(a, dtype=np.float64), np.asarray(b, dtype=np.float64)
    return np.abs(a - b).max() / np.abs(b).max()


@pytest.mark.parametrize("dtype", ["f32", "f64"])
def test_inverse_alternatives_match_numpy(dtype):
    M, X = microbench_inv.make_inputs(2, 8, dtype, CPU)
    # the JAX script's matrices, drawn the same way
    rng = np.random.default_rng(0)
    a = rng.standard_normal((2, 8, 8))
    shift = 1.0 + rng.random((2, 1, 1))
    want_M = a @ a.transpose(0, 2, 1) / 8 + np.eye(8) * shift
    assert _rel(M.numpy(), want_M) <= (1e-6 if dtype == "f32" else 1e-14)
    inv = np.linalg.inv(M.double().numpy())
    stale = np.linalg.inv(M.double().numpy() + 0.1 * np.eye(8))
    assert _rel(X.numpy(), stale) <= 1e-6
    for name, fn in microbench_inv.alternatives(M, X).items():
        out = fn().double().numpy()
        if name == "chol_only":
            assert _rel(out @ out.transpose(0, 2, 1), M.double().numpy()) \
                <= 1e-6
        else:
            assert _rel(out, inv) <= 1e-3, name


def test_inverse_rows():
    rows = microbench_inv.run(((2, 8, "f32"), (2, 8, "f64")), device=CPU,
                              calls=2, reps=1)
    assert [r["name"] for r in rows] == list(microbench_inv.ALTERNATIVES) * 2
    for r in rows:
        assert r["clock"] == "host" and r["ms"] > 0
        assert r["residual"] <= (1e-3 if r["dtype"] == "f32" else 1e-5)
        assert "launches" not in r       # K1's plain version on the CPU


def test_tailops_rows_and_values():
    x = microbench_tailops.make_inputs(2, 8, 5, 4, CPU)
    W, v, mk = x["W64"].numpy(), x["v"].numpy(), x["mask"].numpy()
    Wb = x["Wb64"].numpy()
    want = mk * ((v * mk) @ W.T)
    ops = microbench_tailops.ops(x)
    # the masked batched operator and the mask-factored shared product
    # agree exactly where the mask holds (the masked row is zero)
    got_b = ops["batched f64 (B,n,n)@(B,n)"]().numpy()
    assert _rel(mk * got_b, want) <= 1e-12
    assert _rel(ops["shared f64 (B,n)@(n,n)"]().numpy(), want) <= 1e-12
    assert _rel(ops["split-f32 shared matvec"]().numpy(), want) <= 1e-6
    assert _rel(ops["batched f32 einsum mv"]().numpy(),
                np.einsum("bij,bj->bi", x["Mb"].double().numpy(),
                          x["v32"].double().numpy())) <= 1e-5
    assert _rel(ops["f64 (B,n,n) masked build"]().numpy(), Wb) == 0.0
    rows = microbench_tailops.run(2, 8, 5, 4, device=CPU, calls=2, reps=1)
    assert len(rows) == len(ops) + 1
    assert all(r["clock"] == "host" and r["ms"] > 0 for r in rows[:-1])
    assert rows[-1]["name"] == "split-f32 vs f64 rel err"
    assert rows[-1]["rel_err"] <= 1e-6


def test_calib_rows():
    rows = microbench_calib.run(peak_n=16, B=2, n=8, k=4, device=CPU,
                                calls=2, reps=1)
    names = [r["name"] for r in rows]
    assert names[0] == "f32 16^3 matmul, full f32"
    assert not any("TF32" in n or "graph" in n for n in names)
    floor = [r for r in rows if r["name"].startswith("vector add")]
    assert len(floor) == 1 and floor[0]["clock"] == "host"
    assert all(r["tflops"] > 0 for r in rows if "tflops" in r)
    assert rows[-1]["name"] == "split-f32 rel err"
    assert rows[-1]["rel_err"] <= 1e-6


@pytest.mark.parametrize("tool", [microbench_inv, microbench_tailops,
                                  microbench_calib])
def test_cuda_without_a_card_raises(tool):
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    with pytest.raises(RuntimeError, match="cuda"):
        tool.main([])
