"""The metrics that read the program's spans, on a hand-built Chrome trace
of two fits: known spans, launches and device operations, so every gap and
every millisecond is known."""
from types import SimpleNamespace

import pytest

from portbench import harness
from portbench.trace import load_chrome_trace

SPEC = harness.load_spec()
SPAN_METRICS = ("rsvd_busy_ms.fit", "rsvd_idle_ms.fit", "solver_busy_ms.fit",
                "solver_idle_ms.fit")

# host spans (us): the window, two fits, and the program's spans in them
SPANS = [("portbench.window", 0, 1000), ("portbench.fit", 10, 490),
         ("portbench.fit", 510, 990), ("corrla.rsvd", 20, 200),
         ("corrla.solve.pinv", 210, 300), ("corrla.solve.saddle", 310, 400),
         ("corrla.rsvd", 520, 700), ("corrla.solve.saddle", 710, 800)]
# (correlation, launched at, category, device start, device end)
OPS = [(1, 30, "kernel", 40, 100), (2, 40, "kernel", 100, 150),
       (3, 220, "gpu_memcpy", 230, 260), (4, 320, "kernel", 330, 380),
       (5, 450, "kernel", 455, 470), (6, 530, "kernel", 540, 640),
       (7, 712, "gpu_memset", 715, 745), (8, 760, "kernel", 770, 780),
       (9, 993, "kernel", 995, 998)]
# per fit, in ms: the RSVD launched 1, 2, 6 (60 + 50 + 100 us), the solvers
# 3, 4, 7, 8 (30 + 50 + 30 + 10 us); the gaps inside the fits whose middle
# lies in an RSVD span are 10-40, 150-230, 510-540 and 640-715 (30 + 80 +
# 30 + 75 us), in a solver span 260-330 and 745-770 (70 + 25 us)
WANT = {"rsvd_busy_ms.fit": 0.105, "solver_busy_ms.fit": 0.060,
        "rsvd_idle_ms.fit": 0.1075, "solver_idle_ms.fit": 0.0475}


def _trace(spans=SPANS, ops=OPS):
    events = [{"ph": "X", "cat": "user_annotation", "name": name, "ts": a,
               "dur": b - a} for name, a, b in spans]
    for corr, launched, cat, a, b in ops:
        events.append({"ph": "X", "cat": "cuda_runtime",
                       "name": "cudaLaunchKernel", "ts": launched, "dur": 2,
                       "args": {"correlation": corr}})
        events.append({"ph": "X", "cat": cat, "name": f"op{corr}", "ts": a,
                       "dur": b - a, "args": {"correlation": corr}})
    return load_chrome_trace({"traceEvents": events})


def _read(metric, trace, kind="fit"):
    run = SimpleNamespace(cell=SimpleNamespace(kind=kind), trace=trace)
    return harness._load_metric(metric).read(run)


# spans that nest inside spans the metric already reads: nothing counts twice
NESTED = [("corrla.rsvd", 25, 100), ("corrla.solve.pinv", 320, 390),
          ("corrla.rsvd", 530, 690)]


@pytest.mark.parametrize("nested", [False, True])
@pytest.mark.parametrize("metric", SPAN_METRICS)
def test_each_metric_reads_the_known_milliseconds(metric, nested):
    trace = _trace(SPANS + NESTED if nested else SPANS)
    assert _read(metric, trace) == pytest.approx(WANT[metric], abs=1e-12)


def test_the_layers_close_within_the_fits():
    trace = _trace()
    fits = trace.span_count("portbench.fit")
    busy = sum(min(b, hi) - max(a, lo) for lo, hi in trace.spans[
        "portbench.fit"] for a, b in trace._merged() if a < hi and b > lo)
    idle = sum(hi - lo for lo, hi in trace.spans["portbench.fit"]) - busy
    got = {m: _read(m, trace) for m in SPAN_METRICS}
    assert got["rsvd_busy_ms.fit"] + got["solver_busy_ms.fit"] <= (
        busy / fits * 1e-3)
    assert got["rsvd_idle_ms.fit"] + got["solver_idle_ms.fit"] <= (
        idle / fits * 1e-3)


@pytest.mark.parametrize("metric", SPAN_METRICS)
def test_none_without_the_spans_a_device_or_a_fit(metric):
    bare = [s for s in SPANS if not s[0].startswith("corrla.")]
    assert _read(metric, _trace(spans=bare)) is None
    assert _read(metric, _trace(ops=[])) is None
    assert _read(metric, _trace(), kind="predict") is None
    assert _read(metric, None) is None


@pytest.mark.parametrize("metric", SPAN_METRICS)
def test_zero_where_the_spans_hold_no_operation_and_no_gap(metric):
    # a solver span inside a device operation: nothing launched in it, no
    # gap's middle in it; the RSVD's span is absent
    spans = [s for s in SPANS if not s[0].startswith("corrla.")]
    got = _read(metric, _trace(spans=spans + [("corrla.solve.pinv", 456,
                                               458)]))
    assert got == (0.0 if metric.startswith("solver") else None)


@pytest.mark.parametrize("cell", [w["name"] for w in SPEC["workloads"]])
def test_a_traced_run_reports_the_metrics_of_its_layers(cell):
    got = {m["name"] for m in harness.metric_entries(SPEC, cell, True)}
    want = {"pod2k.fit": set(SPAN_METRICS),
            "rbf16k.fit": {"solver_busy_ms.fit", "solver_idle_ms.fit"}}
    assert got & set(SPAN_METRICS) == want.get(cell, set())
