"""``pod_modes_roofline`` on a hand-built Chrome trace of three predict
calls: known ``corrla.pod.modes`` spans, launches and device operations, so
the device time inside the spans is known; and its count of the work at the
cell's shape against a count by hand."""
from types import SimpleNamespace

import pytest

from portbench import harness
from portbench.roofline import PEAK_BYTES_S, PEAK_F32_FLOPS
from portbench.trace import load_chrome_trace

SPEC = harness.load_spec()
CELL = harness.find_cell(SPEC, "pod2k.predict")
METRIC = harness._load_metric("pod_modes_roofline")

# host spans (us): the window, three predict calls, the modes product in
# each; the third call's product launched two operations
SPANS = [("portbench.window", 0, 30000), ("portbench.predict", 10, 9000),
         ("portbench.predict", 9100, 18000),
         ("portbench.predict", 18100, 29000),
         ("corrla.pod.modes", 600, 700), ("corrla.pod.modes", 9700, 9800),
         ("corrla.pod.modes", 18700, 18800)]
# (correlation, launched at, device start, device end): the RBF matvec of
# each call before its span (not counted), the products inside
OPS = [(1, 100, 110, 170), (2, 650, 700, 5700),
       (3, 9200, 9210, 9270), (4, 9750, 9800, 14600),
       (5, 18200, 18210, 18270), (6, 18720, 18800, 18900),
       (7, 18760, 18900, 23900)]
PRODUCT_US = 5000 + 4800 + 100 + 5000


def _trace(spans=SPANS, ops=OPS):
    events = [{"ph": "X", "cat": "user_annotation", "name": name, "ts": a,
               "dur": b - a} for name, a, b in spans]
    for corr, launched, a, b in ops:
        events.append({"ph": "X", "cat": "cuda_runtime",
                       "name": "cudaLaunchKernel", "ts": launched, "dur": 2,
                       "args": {"correlation": corr}})
        events.append({"ph": "X", "cat": "kernel", "name": f"op{corr}",
                       "ts": a, "dur": b - a, "args": {"correlation": corr}})
    return load_chrome_trace({"traceEvents": events})


def _read(trace, kind="predict"):
    cell = SimpleNamespace(kind=kind, config=CELL.config,
                           traffic=CELL.traffic)
    return METRIC.read(SimpleNamespace(cell=cell, trace=trace))


def test_work_at_the_cells_shape_is_the_hand_count():
    # 200,000 points x 16,384 queries of float32 written once, the 20 modes
    # of each point and the 20 weights of each query read once: 3.92 ms at
    # 3.35 TB/s; 20 FMAs an element take 1.96 ms on the f32 pipe
    n_bytes, n_ops, itemsize = METRIC.modes_work(CELL.config, CELL.traffic)
    assert itemsize == 4
    assert n_bytes == 4 * (200_000 * 16_384 + 200_000 * 20 + 16_384 * 20)
    assert n_ops == 2 * 20 * 200_000 * 16_384
    assert n_bytes / PEAK_BYTES_S == pytest.approx(3.9178e-3, rel=1e-4)
    assert n_ops / PEAK_F32_FLOPS == pytest.approx(1.9563e-3, rel=1e-4)


def test_reads_calls_times_the_bound_over_the_spans_device_time():
    n_bytes, _, _ = METRIC.modes_work(CELL.config, CELL.traffic)
    want = 3 * (n_bytes / PEAK_BYTES_S) / (PRODUCT_US * 1e-6) * 100.0
    assert _read(_trace()) == pytest.approx(want, rel=1e-12)


def test_none_without_the_span_or_a_trace():
    bare = [s for s in SPANS if s[0] != "corrla.pod.modes"]
    assert _read(_trace(spans=bare)) is None
    assert _read(None) is None
    assert _read(_trace(), kind="fit") is None
    # spans that launched nothing
    assert _read(_trace(ops=[op for op in OPS if op[0] in (1, 3, 5)])) is None


def test_the_cell_reports_it_and_no_other_does():
    for w in SPEC["workloads"]:
        names = {m["name"] for m in harness.metric_entries(SPEC, w["name"],
                                                           True)}
        assert ("pod_modes_roofline" in names) == (w["name"] ==
                                                   "pod2k.predict")
