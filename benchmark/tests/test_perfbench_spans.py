"""The per-layer metrics that read the program's spans (CPU, small sizes).

A short `--trace 1` run of each cell reports every span metric listed for
it, shares within [0, 100] and at least one host read an IPM iteration;
a second traced run in the same process reads only its own session."""

import time

import pytest

from conftest import small_run

SPAN_METRICS = {"host_loop.self_share", "superstep.self_share",
                "ipm.iter_ms", "ipm.sync_share", "ipm.host_reads_per_iter",
                "ipm.lane_occupancy", "pool.spill_share"}
SHARES = {"host_loop.self_share", "superstep.self_share", "ipm.sync_share",
          "ipm.lane_occupancy", "pool.spill_share"}


def _listed(cell):
    from benchmark.harness import registry
    return {m["name"] for m in registry.metrics_of(registry.benchmark(), cell,
                                                   True)} & SPAN_METRICS


@pytest.mark.parametrize("cell", ["intquad300-f64.tree",
                                  "intquad300-f64.pool",
                                  "qkp-ghs-100-25.glob"])
def test_traced_run_reports_the_span_metrics(cell):
    want = _listed(cell)
    assert want >= SPAN_METRICS - {"pool.spill_share"}
    line = small_run(cell, trace=1, seconds=3.0)
    got = {k: v["value"] for k, v in line["metrics"].items()}
    assert want <= set(got), want - set(got)
    assert set(got) & SPAN_METRICS == want
    for k in want & SHARES:
        assert 0.0 <= got[k] <= 100.0, (k, got[k])
    assert got["ipm.host_reads_per_iter"] >= 1.0
    assert got["ipm.iter_ms"] > 0.0


def test_a_second_run_reads_only_its_own_session():
    from minotaur_tpu_torch.utils import trace
    small_run("intquad300-f64.pool", trace=1, seconds=3.0)
    assert any(r.name.startswith("pool.") for r in trace.spans())
    t0 = time.time_ns()
    line = small_run("intquad300-f64.tree", trace=1, seconds=3.0)
    recs = trace.spans()
    assert recs and all(r.t0 >= t0 for r in recs)
    assert not any(r.name.startswith("pool.") for r in recs)
    assert "pool.spill_share" not in line["metrics"]
    assert _listed("intquad300-f64.tree") <= set(line["metrics"])
