"""The plain references against NumPy at tiny sizes, and the parts of the
harness that need no program: the generator, the trace reader, the
metrics."""
import ast
import math
import subprocess
import sys
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from portbench import generator, trace as tracing
from portbench.reference import linalg, pod_i, rbf_interp
from portbench.harness import PKG, ROOT

torch.set_num_threads(1)


def test_tf32_round_keeps_ten_mantissa_bits():
    x = torch.randn(4096, generator=torch.Generator().manual_seed(0))
    r = linalg.tf32_round(x)
    assert torch.all(r.view(torch.int32) & 0x1FFF == 0)
    rel = ((r - x).abs() / x.abs()).max().item()
    assert 0 < rel <= 2.0 ** -11


def test_lu_solve_matches_numpy():
    rng = np.random.default_rng(1)
    a = rng.standard_normal((300, 300))
    b = rng.standard_normal((300, 3))
    x = linalg.lu_solve(torch.from_numpy(a), torch.from_numpy(b),
                        linalg.F64, block=64).numpy()
    np.testing.assert_allclose(x, np.linalg.solve(a, b), rtol=1e-9,
                               atol=1e-11)


def test_tf32_products_lose_digits_that_float32_keeps():
    rng = np.random.default_rng(2)
    a = torch.from_numpy(rng.standard_normal((64, 256)))
    b = torch.from_numpy(rng.standard_normal((256, 8)))
    exact = a @ b
    err32 = (linalg.F32.mm(a.float(), b.float()) - exact).abs().max()
    err_tf = (linalg.TF32.mm(a.float(), b.float()) - exact).abs().max()
    assert err_tf > 30 * err32


_PHI = {1: lambda r: r, 2: lambda r: np.sqrt(1.0 + r * r)}


def _rbf_numpy(x, y, q, kernel_type=1):
    n, phi = x.shape[0], _PHI[kernel_type]
    p = np.hstack([x, np.ones((n, 1))])
    k = phi(np.linalg.norm(x[:, None] - x[None], axis=-1))
    a = np.block([[k, p], [p.T, np.zeros((4, 4))]])
    c = np.linalg.solve(a, np.vstack([y, np.zeros((4, y.shape[1]))]))
    kq = phi(np.linalg.norm(q[:, None] - x[None], axis=-1))
    return c, kq @ c[:n] + np.hstack([q, np.ones((len(q), 1))]) @ c[n:]


CFG_RBF = {"kernel_type": 1, "kernel_param": 1.0, "poly_degree": 1,
           "dim": 3}


@pytest.mark.parametrize("kernel_type", [1, 2])
def test_rbf_reference_matches_numpy(kernel_type):
    cfg = dict(CFG_RBF, kernel_type=kernel_type)
    rng = np.random.default_rng(3)
    # points apart enough that the multiquadric's system is well posed
    x, q = 8 * rng.random((200, 3)), 8 * rng.random((50, 3))
    y = np.sin(x).sum(axis=1, keepdims=True)
    c_np, s_np = _rbf_numpy(x, y, q, kernel_type)
    inp = {"x": torch.from_numpy(x), "y": torch.from_numpy(y)}
    state = rbf_interp.fit(cfg, inp, linalg.F64)
    np.testing.assert_allclose(state["coeffs"].numpy(), c_np, rtol=1e-8,
                               atol=1e-9)
    s = rbf_interp.predict(cfg, state, torch.from_numpy(q), linalg.F64)
    np.testing.assert_allclose(s.numpy(), s_np, rtol=1e-9, atol=1e-10)
    # the reference's own coefficients are an exact answer to its judges
    got = rbf_interp.judge_fit(cfg, inp, state, lambda: state, None)
    assert got["saddle_resid"] < 1e-14 and got["support_gap"] == 0.0
    got = rbf_interp.judge_predict(cfg, inp, state, lambda: state,
                                   torch.from_numpy(q), s.float())
    assert got["pred_gap"] < 1e-6 and got["saddle_resid"] < 1e-14


def test_rbf_judges_read_a_wrong_shape_as_infinite():
    x = torch.rand(40, 3, dtype=torch.float64)
    inp = {"x": x, "y": x.sum(1, keepdim=True)}
    state = rbf_interp.fit(CFG_RBF, inp, linalg.F64)
    half = {"x": x[:20], "coeffs": state["coeffs"][:24]}
    got = rbf_interp.judge_fit(CFG_RBF, inp, half, lambda: state, None)
    assert got["saddle_resid"] == math.inf and got["support_gap"] == math.inf
    got = rbf_interp.judge_predict(CFG_RBF, inp, state, lambda: state, x[:5],
                                   torch.zeros(4, 1))
    assert got["pred_gap"] == math.inf


def test_pod_reference_matches_numpy_projection():
    """At the snapshots' own t the model is the projection of each
    snapshot on the leading right singular vectors (numpy's SVD)."""
    rng = np.random.default_rng(4)
    t = np.sort(rng.random(30))[:, None] * 8 + 1
    s = np.linspace(0, 10, 400)
    x = 0.5 * t * np.exp(-((s[None] - t) / 2.0) ** 2)
    cfg = {"n_modes": 6}
    inp = {"x": torch.from_numpy(x), "t": torch.from_numpy(t)}
    state = pod_i.fit(cfg, inp, linalg.F64)
    v = np.linalg.svd(x, full_matrices=False)[2][:6].T
    got = pod_i.predict(cfg, state, torch.from_numpy(t[[3, 17]]),
                        linalg.F64).numpy()
    want = (v @ (v.T @ x[[3, 17]].T))
    np.testing.assert_allclose(got, want, atol=1e-9 * np.abs(x).max())
    gap = pod_i.judge_fit(cfg, inp, state, lambda: state,
                          torch.Generator().manual_seed(0))
    assert gap["pod_gap"] == 0.0


def _imports(path: Path) -> set:
    tree = ast.parse(path.read_text(encoding="utf-8"))
    names = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.module:
            names.add(node.module.split(".")[0])
    return names


@pytest.mark.parametrize("path", sorted((PKG / "reference").glob("*.py")),
                         ids=lambda p: p.name)
def test_the_reference_imports_nothing_of_the_program(path):
    assert _imports(path) <= {"__future__", "contextlib", "dataclasses",
                              "math", "torch", "portbench"}
    assert not {m for m in _imports(path) if m.startswith("corrla")}


def test_the_reference_loads_no_program_module():
    probe = ("import sys; import portbench.reference.rbf_interp, "
             "portbench.reference.pod_i; "
             "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
             "('corrla_rs_tpu_torch', 'corrla_rs_torch', 'jax', 'jaxlib', "
             "'corrla_rs_tpu', 'corrla_rs')); print(bad); "
             "sys.exit(1 if bad else 0)")
    proc = subprocess.run([sys.executable, "-c", probe], cwd=ROOT,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr


def test_a_seed_gives_the_same_calls_and_every_seed_the_same_pool():
    mix = {"call": "fit", "pool": 4, "warmup_calls": 2}
    a, b = generator.Schedule(mix, 2**31 + 5), generator.Schedule(mix,
                                                                  2**31 + 5)
    calls = [a.next() for _ in range(12)]
    assert calls == [b.next() for _ in range(12)]
    other = generator.Schedule(mix, 7)
    assert sorted(i for i, _ in calls) == sorted(other.next()[0]
                                                 for _ in range(12))
    assert len({k for _, k in calls}) == 12


@pytest.mark.parametrize("mix", [
    {"call": "serve", "pool": 1, "warmup_calls": 1},
    {"call": "fit", "pool": 0, "warmup_calls": 1},
    {"call": "predict", "pool": 1, "warmup_calls": 1},
    {"call": "fit", "pool": 1}])
def test_the_generator_refuses_a_mix_it_cannot_drive(mix):
    with pytest.raises(ValueError):
        generator.check_traffic(mix)


def _event(cat, name, ts, dur, corr=None):
    e = {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur}
    if corr is not None:
        e["args"] = {"correlation": corr}
    return e


TRACE = {"traceEvents": [
    _event("user_annotation", tracing.WINDOW_SPAN, 0, 1000),
    _event("user_annotation", "portbench.predict", 10, 40),
    _event("cuda_runtime", "cudaLaunchKernel", 20, 5, corr=1),
    _event("cuda_runtime", "cudaLaunchKernel", 30, 5, corr=2),
    _event("kernel", "matvec", 100, 300, corr=1),
    _event("kernel", "gemm", 350, 150, corr=2),
    _event("cuda_runtime", "cudaDeviceSynchronize", 505, 190),
    _event("user_annotation", "portbench.predict", 696, 20),
    _event("cuda_runtime", "cudaLaunchKernel", 700, 5, corr=3),
    _event("gpu_memset", "fill", 700, 100, corr=3),
]}


def test_the_trace_reader_takes_the_union_and_the_launches():
    view = tracing.load_chrome_trace(TRACE)
    assert view.window_s == pytest.approx(1e-3)
    assert view.busy_s == pytest.approx(500e-6)
    assert view.span_count("portbench.predict") == 2
    assert {op["name"] for op in view.ops_under("portbench.predict")} == {
        "matvec", "gemm", "fill"}
    assert [op["name"] for op in view.ops_under(
        "portbench.predict", cats={"kernel"})] == ["matvec", "gemm"]
    assert view.breakdown()["idle_gaps"] == [
        ["cudaDeviceSynchronize", pytest.approx(200e-6)],
        ["portbench.window", pytest.approx(200e-6)],
        ["portbench.predict", pytest.approx(100e-6)]]
    assert view.breakdown()["device_ops"][0] == ["matvec",
                                                 pytest.approx(300e-6)]


def test_the_metrics_read_a_run():
    from portbench.harness import _load_metric
    view = tracing.load_chrome_trace(TRACE)
    cell = SimpleNamespace(kind="predict", config={"n_fit": 16384, "dim": 3,
                                                   "dtype": "float32"},
                           traffic={"call": "predict",
                                    "queries_per_call": 1 << 20})
    driver = SimpleNamespace(rbf_matvec_shape=lambda cfg, tr: (1 << 20,
                                                               16384, 3, 1))
    run = SimpleNamespace(cell=cell, driver=driver, setup_s=12.5,
                          window_s=2.0, calls=200, items=200 << 20,
                          latencies=[0.01] * 190 + [0.02] * 10,
                          dispatch=[1e-4] * 200, trace=view)
    read = {m: _load_metric(m).read(run) for m in (
        "setup_s", "predict_queries_per_s", "predict_p95_ms",
        "dispatch_ms.predict", "device_idle_pct.predict",
        "rbf_matvec_roofline", "fit_ms", "device_idle_pct.fit")}
    assert read["setup_s"] == 12.5
    assert read["predict_queries_per_s"] == pytest.approx(100 * (1 << 20))
    assert 10.0 <= read["predict_p95_ms"] <= 20.0
    assert read["dispatch_ms.predict"] == pytest.approx(0.1)
    assert read["device_idle_pct.predict"] == pytest.approx(50.0)
    # two calls' least time (3.077 ms each) over 550 us of device time
    assert read["rbf_matvec_roofline"] == pytest.approx(
        2 * 3.0769915e-3 / 550e-6 * 100, rel=1e-6)
    assert read["fit_ms"] is None and read["device_idle_pct.fit"] is None
