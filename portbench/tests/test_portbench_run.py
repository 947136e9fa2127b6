"""Whole runs of each cell at a small size on the CPU: the program comes out
correct; the control (the reference in the precision below the
configuration's, in its place) and
each fault a cell can have, planted under the timed path, come out not
correct; and the run's exits and imports are as the contract says."""
import json
import shutil
import subprocess
import sys
import time

import pytest
import torch

from portbench import harness

torch.set_num_threads(1)

SPEC = harness.load_spec()
CELLS = [w["name"] for w in SPEC["workloads"]]
SEED = 2**31 + 11
REQUIRED = ["correct", "attempted", "failed", "metrics", "device"]


def _small(cell):
    """A cell's overrides of its configuration and mix at the sizes its
    configuration's ``test_sizes`` and its driver give for tests."""
    found = harness.find_cell(SPEC, cell)
    driver, _ = harness.import_model(found.config["model"])
    traffic = {}
    if found.kind == "predict":
        traffic["queries_per_call"] = driver.TEST_QUERIES_PER_CALL
    return found.config["test_sizes"], traffic


def _run(cell, trace=False, driver=None, seconds=0.3, seed=SEED):
    config, traffic = _small(cell)
    code, result = harness.run_cell(
        cell, seed, seconds, trace, t_start=time.perf_counter(),
        device="cpu", driver=driver, config_overrides=config,
        traffic_overrides=traffic)
    assert code == 0
    return result


def _modules(cell):
    return harness.import_model(harness.find_cell(SPEC, cell).config["model"])


@pytest.mark.parametrize("trace", [False, True])
@pytest.mark.parametrize("cell", CELLS)
def test_the_program_comes_out_correct(cell, trace):
    result = _run(cell, trace)
    assert result["correct"], result["checks"]
    assert list(result)[:5] == REQUIRED and list(result)[-1] == "checks"
    assert set(result) <= set(REQUIRED) | {"breakdown", "setup_peak_bytes",
                                           "checks"}
    assert result["attempted"] >= 1 and result["failed"] == 0
    names = {m["name"] for m in harness.metric_entries(SPEC, cell, trace)}
    if not trace:
        assert set(result["metrics"]) == names
    else:
        # the CPU has no device trace: only the host's spans read
        assert "breakdown" in result and "busy_s" in result["device"]
    line = json.loads(harness.result_line(result))
    assert line["checks"] == result["checks"]


@pytest.mark.parametrize("cell", CELLS)
def test_the_control_comes_out_not_correct(cell):
    driver, reference = _modules(cell)
    arith = harness.control_arith(harness.find_cell(SPEC, cell).config)
    result = _run(cell, driver=harness.ControlDriver(driver, reference,
                                                     arith))
    assert not result["correct"], result["checks"]
    # a compared number catches it, not only the dtype of its answers
    assert any(c["value"] > c["limit"] for name, c in result["checks"].items()
               if name != "dtype_differs"), result["checks"]


class _Faulty:
    """The program's driver with one fault planted where the answers are
    produced."""

    def __init__(self, driver, fault):
        self.d, self.fault = driver, fault
        self.make_fit_inputs = driver.make_fit_inputs
        self.make_queries = driver.make_queries
        self.state = driver.state
        self.rbf_matvec_shape = driver.rbf_matvec_shape
        self.QUERY_AXIS = driver.QUERY_AXIS
        self.prev = None

    def fit(self, cfg, inp, key):
        if self.fault == "half":
            inp = {k: v[:v.shape[0] // 2] for k, v in inp.items()}
        model = self.d.fit(cfg, inp, key)
        if self.fault == "altered":
            answer = list(self.d.state(cfg, model).values())[-1]
            answer[(0,) * answer.ndim] += 1.0 + answer.abs().max()
        if self.fault == "unchanged":
            model, self.prev = self.prev or model, model
        return model

    def predict(self, cfg, model, q):
        if self.fault == "half":
            half = self.d.predict(cfg, model, q[:q.shape[0] // 2])
            dim = self.d.QUERY_AXIS
            rest = half.mean(dim=dim, keepdim=True).expand_as(half)
            out = torch.cat([half, rest], dim=dim)
            return out.narrow(dim, 0, q.shape[0])
        out = self.d.predict(cfg, model, q)
        if self.fault == "altered":
            out[(0,) * out.ndim] += 1.0
        if self.fault == "unchanged":
            out, self.prev = (out if self.prev is None else self.prev), out
        return out


@pytest.mark.parametrize("fault", ["unchanged", "half", "altered"])
@pytest.mark.parametrize("cell", CELLS)
def test_a_planted_fault_comes_out_not_correct(cell, fault):
    driver, _ = _modules(cell)
    result = _run(cell, driver=_Faulty(driver, fault))
    assert not result["correct"], (fault, result["checks"])


def test_without_a_card_the_run_exits_without_a_result():
    proc = subprocess.run(
        [sys.executable, "portbench/run.py", "--workload", CELLS[0],
         "--seed", str(SEED), "--seconds", "1", "--trace", "0"],
        cwd=harness.ROOT, capture_output=True, text=True, timeout=300,
        env={"CUDA_VISIBLE_DEVICES": "", "PATH": "/usr/bin:/bin"})
    if torch.cuda.is_available():
        pytest.skip("this machine has a card")
    assert proc.returncode == 2 and proc.stdout == ""


def test_a_run_loads_no_module_of_jax_or_the_jax_package():
    config, traffic = _small(CELLS[0])
    probe = (
        "import sys, time, torch; from portbench import harness; "
        "torch.set_num_threads(1); "
        f"code, r = harness.run_cell({CELLS[0]!r}, 5, 0.2, True, "
        "t_start=time.perf_counter(), device='cpu', "
        f"config_overrides={config!r}, traffic_overrides={traffic!r}); "
        "bad = harness.forbidden_modules(); print(bad); "
        "sys.exit(1 if bad or not r['correct'] else 0)")
    proc = subprocess.run([sys.executable, "-c", probe], cwd=harness.ROOT,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stdout + proc.stderr[-2000:]


def test_forbidden_names_are_compared_whole():
    sys.modules["corrla_rs_tpu_torch_probe_only"] = sys
    try:
        assert "corrla_rs_tpu_torch_probe_only" not in \
            harness.forbidden_modules()
    finally:
        del sys.modules["corrla_rs_tpu_torch_probe_only"]


def test_the_benchmark_alone_exits_without_a_result(tmp_path):
    shutil.copy(harness.ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(harness.PKG, tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    probe = ("import sys, time; from portbench import harness; "
             f"harness.run_cell({CELLS[0]!r}, 5, 0.2, False, "
             "t_start=time.perf_counter(), device='cpu'); print('result')")
    proc = subprocess.run([sys.executable, "-c", probe], cwd=tmp_path,
                          capture_output=True, text=True, timeout=300,
                          env={"PATH": "/usr/bin:/bin"})
    assert proc.returncode != 0 and "result" not in proc.stdout
    assert "corrla_rs_tpu_torch" in proc.stderr


@pytest.mark.cuda
def test_a_traced_run_on_the_card_reads_the_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    config, traffic = _small(CELLS[0])
    code, result = harness.run_cell(
        CELLS[0], SEED, 0.5, True, t_start=time.perf_counter(),
        config_overrides=config, traffic_overrides=traffic)
    assert code == 0 and result["correct"], result["checks"]
    assert result["device"]["busy_s"] > 0
    assert result["metrics"]
