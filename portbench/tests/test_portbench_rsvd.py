"""The ``rsvd`` model of the benchmark on the CPU at small sizes: the plain
reference against LAPACK's SVD, its judge, the program against both, and
the metrics of the RSVD core's spans on a hand-built trace."""
import math
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from portbench import harness
from portbench.drivers import rsvd as driver
from portbench.reference import rsvd as reference
from portbench.reference.linalg import F64
from portbench.trace import load_chrome_trace

torch.set_num_threads(1)

SPEC = harness.load_spec()
CELL = harness.find_cell(SPEC, "rsvd100k.fit")
FULL = CELL.config
SMALL = dict(FULL, **FULL["test_sizes"])
LIMITS = CELL.limits
SEED = 2**31 + 25


def _inputs(cfg, count=1, seed=SEED):
    gen = torch.Generator().manual_seed(seed)
    return driver.make_fit_inputs(cfg, count, gen, "cpu")


def test_the_matrix_has_its_stated_spectrum():
    cfg = dict(SMALL, n_rows=300, n_cols=80, n_sigma=40)
    inp = _inputs(cfg)[0]
    assert inp["a"].dtype == torch.float32 and inp["a"].shape == (300, 80)
    s = np.linalg.svd(inp["a"].double().numpy(), compute_uv=False)
    np.testing.assert_allclose(s[:40], inp["sigma"].numpy(), rtol=1e-5)
    assert s[40] < 1e-6
    assert inp["sigma"][0] == 1.0 and inp["sigma"][-1] == pytest.approx(1e-3)


def test_the_reference_matches_lapack_on_a_known_spectrum():
    cfg = dict(SMALL, n_rows=600, n_cols=120, n_rank=10, n_sigma=60)
    inp = _inputs(cfg)[0]
    got = reference.fit(cfg, inp, F64)
    u, s, vt = np.linalg.svd(inp["a"].double().numpy(), full_matrices=False)
    r = cfg["n_rank"]
    np.testing.assert_allclose(got["s"].numpy(), s[:r], rtol=1e-10)
    # each singular vector up to its sign
    np.testing.assert_allclose(np.abs(np.sum(got["u"].numpy() * u[:, :r],
                                             axis=0)), 1.0, atol=1e-10)
    np.testing.assert_allclose(np.abs(np.sum(got["vt"].numpy() * vt[:r],
                                             axis=1)), 1.0, atol=1e-10)
    np.testing.assert_allclose(got["s"].numpy(), inp["sigma"][:r].numpy(),
                               rtol=1e-5)


def test_the_judge_reads_a_wrong_shape_as_inf():
    inp = _inputs(SMALL)[0]
    prog = driver.state(SMALL, driver.fit(SMALL, inp, 7))
    assert all(v <= LIMITS[k] for k, v in reference.judge_fit(
        SMALL, inp, prog, None, None).items())
    wrong = [dict(prog, u=prog["u"][1:]), dict(prog, s=prog["s"][1:]),
             dict(prog, vt=prog["vt"].mT.contiguous()),
             dict(prog, u=prog["u"][:, :-1])]
    for bad in wrong:
        got = reference.judge_fit(SMALL, inp, bad, None, None)
        assert set(got) == set(reference.NUMBERS)
        assert all(math.isinf(v) for v in got.values())


@pytest.mark.parametrize("seed", [SEED, SEED + 1])
def test_the_program_agrees_with_the_reference_and_the_known_sigma(seed):
    inp = _inputs(SMALL, seed=seed)[0]
    u, s, vt = driver.fit(SMALL, inp, seed)
    assert s.shape == (SMALL["n_rank"], 1) and u.dtype == torch.float32
    got = reference.judge_fit(SMALL, inp, driver.state(SMALL, (u, s, vt)),
                              None, None)
    assert all(got[k] <= LIMITS[k] for k in reference.NUMBERS), got
    # both within the power iteration's error of the known sigma, so within
    # twice it of each other
    want = reference.fit(SMALL, inp, F64)["s"]
    gap = ((s[:, 0].double() - want).abs() / want).max().item()
    assert gap <= 2 * LIMITS["sv_gap"]


def test_fewer_power_iterations_read_above_the_sv_gap_limit():
    inp = _inputs(SMALL)[0]
    short = dict(SMALL, n_iters=3)
    prog = driver.state(SMALL, driver.fit(short, inp, 5))
    got = reference.judge_fit(SMALL, inp, prog, None, None)
    assert got["sv_gap"] > LIMITS["sv_gap"], got


def test_the_fit_is_fit_only():
    with pytest.raises(ValueError):
        driver.make_queries(SMALL, 4, 1, None, "cpu")
    assert driver.rbf_matvec_shape(SMALL, CELL.traffic) is None


def test_the_work_of_a_fit_at_full_size():
    n_bytes, n_ops = driver.rsvd_work(FULL)
    # 18 passes over a 4.0 GB matrix at a sketch of 110 columns
    assert n_bytes == 18 * 100_000 * 10_000 * 4
    assert n_ops == 18 * 2 * 100_000 * 10_000 * 110
    roof = harness._load_metric("rsvd_roofline")
    assert roof.bound_s(n_bytes, n_ops) == pytest.approx(72e9 / 3.35e12)


# host spans (us): the window, two fits, the RSVD and its inner spans
SPANS = [("portbench.window", 0, 1000), ("portbench.fit", 10, 490),
         ("portbench.fit", 510, 990), ("corrla.rsvd", 20, 400),
         ("corrla.rsvd.products", 25, 60), ("corrla.rsvd.orth", 70, 90),
         ("corrla.rsvd.products", 95, 120), ("corrla.rsvd.svd", 300, 390),
         ("corrla.rsvd", 520, 900), ("corrla.rsvd.products", 530, 560),
         ("corrla.rsvd.orth", 600, 700)]
# (correlation, launched at, category, device start, device end)
OPS = [(1, 30, "kernel", 40, 140), (2, 80, "kernel", 140, 160),
       (3, 100, "kernel", 160, 260), (4, 200, "gpu_memset", 260, 270),
       (5, 310, "kernel", 320, 370), (6, 450, "kernel", 455, 470),
       (7, 540, "kernel", 545, 645), (8, 650, "kernel", 650, 710),
       (9, 800, "kernel", 805, 815)]
# per fit, in ms: products launched 1, 3, 7 (100 + 100 + 100 us), orth 2, 8
# (20 + 60 us); corrla.rsvd 1-5 and 7-9 (280 + 170 us)
WANT = {"rsvd_products_ms.fit": 0.150, "rsvd_orth_ms.fit": 0.040}
RSVD_BUSY_MS = 0.225


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


def _read(metric, trace, drv=driver, config=FULL, kind="fit"):
    run = SimpleNamespace(cell=SimpleNamespace(kind=kind, config=config),
                          trace=trace, driver=drv)
    return harness._load_metric(metric).read(run)


@pytest.mark.parametrize("metric", sorted(WANT))
def test_the_inner_spans_read_their_known_milliseconds(metric):
    assert _read(metric, _trace()) == pytest.approx(WANT[metric], abs=1e-12)
    assert _read("rsvd_busy_ms.fit", _trace()) == pytest.approx(
        RSVD_BUSY_MS, abs=1e-12)


def test_the_roofline_reads_the_count_over_the_rsvd_span():
    bound_ms = 72e9 / 3.35e12 * 1e3
    assert _read("rsvd_roofline", _trace()) == pytest.approx(
        bound_ms / RSVD_BUSY_MS * 100.0, rel=1e-12)
    # without the inner spans (a program before them) it reads the same
    outer = [s for s in SPANS if not s[0].startswith("corrla.rsvd.")]
    assert _read("rsvd_roofline", _trace(spans=outer)) == pytest.approx(
        bound_ms / RSVD_BUSY_MS * 100.0, rel=1e-12)


@pytest.mark.parametrize("metric", sorted(WANT) + ["rsvd_roofline"])
def test_none_without_the_spans_a_device_or_a_fit(metric):
    outer = [s for s in SPANS if not s[0].startswith("corrla.rsvd.")]
    bare = [s for s in SPANS if not s[0].startswith("corrla.")]
    if metric != "rsvd_roofline":
        assert _read(metric, _trace(spans=outer)) is None
    assert _read(metric, _trace(spans=bare)) is None
    assert _read(metric, _trace(ops=[])) is None
    assert _read(metric, _trace(), kind="predict") is None
    assert _read(metric, None) is None


def test_the_roofline_needs_the_drivers_count():
    assert _read("rsvd_roofline", _trace(), drv=SimpleNamespace()) is None


def test_the_cell_reports_its_layers_metrics():
    got = {m["name"] for m in harness.metric_entries(SPEC, CELL.name, True)}
    assert got == {"rsvd_roofline", "rsvd_products_ms.fit",
                   "rsvd_orth_ms.fit"}
    pod = {m["name"] for m in harness.metric_entries(SPEC, "pod2k.fit", True)}
    assert {"rsvd_products_ms.fit", "rsvd_orth_ms.fit"} <= pod
    e2e = {m["name"] for m in harness.metric_entries(SPEC, CELL.name, False)}
    assert e2e == {"fit_ms", "setup_s"}
