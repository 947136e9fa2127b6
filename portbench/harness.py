"""One run of one cell: set-up, the measured window, the traced window, the
comparison with the reference, and the result line.

Everything that belongs to one configuration, traffic mix, model or metric
is found by its name in ``BENCHMARK.json``:

- a configuration is the JSON file that its entry names; its ``"model"``
  names ``portbench/drivers/<model>.py``, which makes the inputs and calls
  the program, and ``portbench/reference/<model>.py``, the plain reference
  and its comparisons;
- a traffic mix is ``portbench/traffic/<traffic>.json``, read by the one
  generator (``portbench.generator``);
- a metric is ``portbench/metrics/<metric>.py``, whose ``read(run)`` takes
  a ``Run`` and gives a number, or None where it finds nothing to read;
- the limits of a cell's compared numbers are
  ``portbench/limits/<cell>.json``.

A driver gives ``make_fit_inputs(cfg, count, gen, device)`` and
``make_queries(cfg, rows, count, gen, device)`` (in the configuration's
``dtype``), ``fit(cfg, inp, key)``, ``predict(cfg, model, queries)``,
``state(cfg, model)`` (the fitted state as tensors, the coefficients last),
``rbf_matvec_shape(cfg, traffic)``, ``QUERY_AXIS`` (the axis of a predict
answer that runs over the queries) and ``TEST_QUERIES_PER_CALL`` (the rows of
a predict batch in the benchmark's own tests; their sizes of the
configuration are its ``test_sizes``). A reference gives
``fit(cfg, inp, arith)``, ``predict(cfg, state, queries, arith)``,
``judge_fit(cfg, inp, prog, ref, gen)`` and
``judge_predict(cfg, inp, prog, ref, queries, out)``: ``prog`` is the
program's fitted state, ``ref()`` the reference's own float64 fit of
``inp`` (worked out on the first call), ``gen`` the judge's generator for
any points it draws; each judge returns numbers by name, each held to its
limit.

A run holds the program to the precision its configuration states: the
inputs are made in ``dtype``, a run whose matrix products' TF32 setting is
not ``tf32`` exits without a result, and an answer in another dtype is not
correct.
"""
from __future__ import annotations

import contextlib
import functools
import importlib
import importlib.util
import json
import math
import random
import sys
import time
import traceback
from dataclasses import dataclass, field
from pathlib import Path

import torch

from portbench import generator, trace as tracing
from portbench.reference.linalg import F32, F64, TF32, Arith

__all__ = ["PKG", "ROOT", "FORBIDDEN", "Cell", "Run", "ControlDriver",
           "load_spec", "find_cell", "metric_entries", "run_cell",
           "result_line", "check_lines", "forbidden_modules",
           "control_arith", "import_model"]

PKG = Path(__file__).resolve().parent
ROOT = PKG.parent
# top-level module names that no run may hold: JAX and the JAX package
FORBIDDEN = ("jax", "jaxlib", "flax", "corrla_rs_tpu", "corrla_rs")
# the traced window's length at most, in seconds, and its fewest calls
TRACE_SECONDS = 2.0
TRACE_MIN_CALLS = 2
# answers of the window, drawn from the seed, that the reference judges
JUDGE_CALLS = 1
# exit code of a run whose TF32 setting is not the configuration's
EXIT_PRECISION = 4
# stream of the judge's draws, apart from the inputs' stream
_JUDGE_STREAM = 0x5EED


@dataclass
class Cell:
    name: str
    chips: int
    config: dict
    traffic: dict
    limits: dict

    @property
    def kind(self) -> str:
        return self.traffic["call"]


@dataclass
class Run:
    """What a metric reads: the cell, its driver, the set-up time, the
    window, each call's latency and dispatch, and the traced window."""
    cell: Cell
    driver: object
    setup_s: float = 0.0
    window_s: float = 0.0
    calls: int = 0
    items: int = 0
    latencies: list = field(default_factory=list)
    dispatch: list = field(default_factory=list)
    trace: object = None


def control_arith(cfg: dict) -> Arith:
    """The nearest precision below the configuration's: float32 for
    float64, TF32 products for float32 with TF32 off."""
    if cfg["dtype"] == "float64":
        return F32
    if cfg["dtype"] == "float32" and not cfg["tf32"]:
        return TF32
    raise ValueError(f"no control below {cfg['dtype']} (tf32 "
                     f"{cfg['tf32']})")


class ControlDriver:
    """The reference in the program's place, computed in ``arith``: the
    control that the comparison has to find wrong. The inputs come from
    the program's driver, as in any run."""

    def __init__(self, driver, reference, arith: Arith):
        self._reference, self.arith = reference, arith
        self.make_fit_inputs = driver.make_fit_inputs
        self.make_queries = driver.make_queries
        self.rbf_matvec_shape = driver.rbf_matvec_shape
        self.QUERY_AXIS = driver.QUERY_AXIS

    def fit(self, cfg, inp, key):
        return self._reference.fit(cfg, inp, self.arith)

    def predict(self, cfg, model, queries):
        return self._reference.predict(cfg, model, queries, self.arith)

    def state(self, cfg, model):
        return model


class _Reservoir:
    """A uniform sample of ``k`` of the answers offered, drawn by ``rng``."""

    def __init__(self, k: int, rng: random.Random):
        self.k, self.rng, self.seen, self.items = k, rng, 0, []

    def offer(self, item) -> None:
        self.seen += 1
        if len(self.items) < self.k:
            self.items.append(item)
            return
        j = self.rng.randrange(self.seen)
        if j < self.k:
            self.items[j] = item


def load_spec() -> dict:
    with open(ROOT / "BENCHMARK.json", encoding="utf-8") as f:
        return json.load(f)


def _load_json(path: Path) -> dict:
    with open(path, encoding="utf-8") as f:
        return json.load(f)


def find_cell(spec: dict, name: str) -> Cell:
    """The cell ``name`` of ``spec`` with its configuration, traffic mix and
    limits read from their files."""
    cells = {w["name"]: w for w in spec["workloads"]}
    if name not in cells:
        raise KeyError(f"no workload {name!r}; known: {sorted(cells)}")
    w = cells[name]
    configs = {c["name"]: c for c in spec["configs"]}
    config = _load_json(ROOT / configs[w["config"]]["file"])
    traffic = _load_json(PKG / "traffic" / f"{w['traffic']}.json")
    generator.check_traffic(traffic)
    limits = _load_json(PKG / "limits" / f"{name}.json")
    return Cell(name, int(w["chips"]), config, traffic, limits)


def metric_entries(spec: dict, cell: str, trace: bool) -> list:
    """The metrics a run of ``cell`` reports: with ``trace`` the per-layer
    ones, else the end-to-end ones. A metric without ``workloads`` belongs
    to every cell (a per-layer one: every cell that reports the end-to-end
    metric it moves)."""
    e2e = [m for m in spec["end_to_end"]
           if "workloads" not in m or cell in m["workloads"]]
    if not trace:
        return e2e
    reported = {m["name"] for m in e2e}
    return [m for m in spec["per_layer"]
            if cell in m.get("workloads", ())
            or ("workloads" not in m and m["moves"] in reported)]


def import_model(model: str) -> tuple:
    """(driver, reference) modules of a configuration's ``"model"``."""
    return (importlib.import_module(f"portbench.drivers.{model}"),
            importlib.import_module(f"portbench.reference.{model}"))


def _load_metric(name: str):
    path = PKG / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(
        "portbench_metric_" + name.replace(".", "_").replace("-", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def forbidden_modules() -> list:
    """Loaded modules whose top-level name is one of ``FORBIDDEN``."""
    return sorted(m for m in list(sys.modules)
                  if m.split(".")[0] in FORBIDDEN)


def _tf32_differs(cfg: dict) -> bool:
    """Whether the matrix products' TF32 setting is not the
    configuration's; says so on standard error."""
    now = torch.backends.cuda.matmul.allow_tf32
    if now != bool(cfg["tf32"]):
        print(f"portbench: TF32 products are {'on' if now else 'off'}; the "
              f"configuration states tf32 {cfg['tf32']}", file=sys.stderr)
        return True
    return False


def _tensors(answer):
    if isinstance(answer, dict):
        return list(answer.values())
    return [answer]


def _worst(acc: dict, numbers: dict) -> None:
    for name, v in numbers.items():
        v = float(v)
        old = acc.get(name)
        if old is None or math.isnan(v) or (not math.isnan(old) and v > old):
            acc[name] = v


class _Loop:
    """Calls of one caller in a closed loop, each timed from the call to
    the end of its synchronisation."""

    def __init__(self, schedule, call, sync, keep: _Reservoir):
        self.schedule, self.call, self.sync, self.keep = (schedule, call,
                                                          sync, keep)
        self.failed = 0
        self.attempted = 0

    def run(self, seconds: float, span: str | None = None,
            min_calls: int = 1):
        """Calls until ``seconds`` have passed and ``min_calls`` were made;
        returns (window seconds, latencies, dispatch times)."""
        lat, disp = [], []
        t0 = time.perf_counter()
        while True:
            idx, key = self.schedule.next()
            self.attempted += 1
            ctx = (torch.profiler.record_function(span) if span
                   else contextlib.nullcontext())
            t_a = time.perf_counter()
            try:
                with ctx:
                    out = self.call(idx, key)
                t_b = time.perf_counter()
                self.sync()
            except Exception:  # a failed call counts, and the loop goes on
                if not self.failed:
                    traceback.print_exc(file=sys.stderr)
                self.failed += 1
            else:
                t_c = time.perf_counter()
                lat.append(t_c - t_a)
                disp.append(t_b - t_a)
                self.keep.offer((idx, out))
                del out
            done = time.perf_counter() - t0
            if done >= seconds and len(lat) + self.failed >= min_calls:
                return done, lat, disp


def run_cell(cell_name: str, seed: int, seconds: float, trace: bool, *,
             t_start: float, device=None, driver=None,
             config_overrides: dict | None = None,
             traffic_overrides: dict | None = None) -> tuple:
    """One run of ``cell_name``; returns (exit code, result dict or None).

    Without ``device`` the run needs as many CUDA devices as the cell asks
    for, and exits 2 without a result where there are fewer. ``device``,
    ``driver`` (in the program's driver's place) and the overrides of the
    configuration and the traffic serve the benchmark's own tests."""
    spec = load_spec()
    cell = find_cell(spec, cell_name)
    cell.config.update(config_overrides or {})
    cell.traffic.update(traffic_overrides or {})
    if device is None:
        if (not torch.cuda.is_available()
                or torch.cuda.device_count() < cell.chips):
            print(f"portbench: {cell.name} needs {cell.chips} CUDA "
                  f"device(s); found "
                  f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
                  file=sys.stderr)
            return 2, None
        device = torch.device("cuda", 0)
    device = torch.device(device)
    on_cuda = device.type == "cuda"
    sync = torch.cuda.synchronize if on_cuda else (lambda: None)
    program, reference = import_model(cell.config["model"])
    driver = driver or program
    cfg, traffic = cell.config, cell.traffic

    # set-up: inputs on the device from the seed, the fit of a predict mix,
    # and the warm-up calls
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    schedule = generator.Schedule(traffic, seed)
    pool = int(traffic["pool"])
    held: dict = {}
    if cell.kind == "predict":
        inputs = driver.make_fit_inputs(cfg, 1, gen, device)
        rows = int(traffic["queries_per_call"])
        queries = driver.make_queries(cfg, rows, pool, gen, device)
        held["model"] = driver.fit(cfg, inputs[0], schedule.setup_key)

        def call(idx, key):
            return driver.predict(cfg, held["model"], queries[idx])
    else:
        inputs = driver.make_fit_inputs(cfg, pool, gen, device)
        queries, rows = None, 1

        def call(idx, key):
            return driver.fit(cfg, inputs[idx], key)
    for i in range(int(traffic["warmup_calls"])):
        call(i % pool, schedule.setup_key)
        sync()
    run = Run(cell, driver)
    run.setup_s = time.perf_counter() - t_start
    # the program's own peak: set-up holds nothing of the judge's
    setup_peak = torch.cuda.max_memory_allocated(device) if on_cuda else 0
    if _tf32_differs(cfg):
        return EXIT_PRECISION, None

    keep = _Reservoir(JUDGE_CALLS, random.Random(seed ^ _JUDGE_STREAM))
    loop = _Loop(schedule, call, sync, keep)
    run.window_s, run.latencies, run.dispatch = loop.run(seconds)
    run.calls = len(run.latencies)
    run.items = run.calls * rows
    if trace:
        span = f"portbench.{cell.kind}"
        run.trace = tracing.profiled(
            lambda: loop.run(min(seconds, TRACE_SECONDS), span,
                             TRACE_MIN_CALLS), on_cuda)
    peak = torch.cuda.max_memory_allocated(device) if on_cuda else 0
    kind = torch.cuda.get_device_name(device) if on_cuda else "cpu"
    if _tf32_differs(cfg):
        return EXIT_PRECISION, None

    # the program's model goes before the reference runs; its fitted state
    # and the sampled answers stay
    prog = driver.state(cfg, held["model"]) if held else None
    held.clear()
    kept = keep.items
    if on_cuda:
        torch.cuda.empty_cache()
    judge_gen = torch.Generator(device=device)
    judge_gen.manual_seed(seed ^ _JUDGE_STREAM)
    numbers: dict = {}
    want = getattr(torch, cfg["dtype"])
    wrong_dtype = 0
    for idx, answer in kept:
        inp = inputs[0] if cell.kind == "predict" else inputs[idx]
        ref = functools.cache(lambda inp=inp: reference.fit(cfg, inp, F64))
        if cell.kind == "predict":
            wrong_dtype |= answer.dtype != want
            got = reference.judge_predict(cfg, inp, prog, ref, queries[idx],
                                          answer)
        else:
            state = driver.state(cfg, answer)
            wrong_dtype |= any(t.dtype != want for t in _tensors(state)
                               if t.is_floating_point())
            got = reference.judge_fit(cfg, inp, state, ref, judge_gen)
        _worst(numbers, got)
        del ref
    checks = {name: {"value": v, "limit": float(cell.limits[name])}
              for name, v in sorted(numbers.items())}
    # an answer in another dtype than the configuration states
    checks["dtype_differs"] = {"value": float(wrong_dtype), "limit": 0.0}
    correct = (loop.failed == 0 and bool(kept)
               and all(c["value"] <= c["limit"] for c in checks.values()))

    metrics = {}
    for entry in metric_entries(spec, cell.name, trace):
        value = _load_metric(entry["name"]).read(run)
        if value is not None and math.isfinite(value):
            metrics[entry["name"]] = {"value": float(value),
                                      "unit": entry["unit"]}
    dev = {"platform": "gpu" if on_cuda else "cpu", "kind": kind,
           "count": cell.chips, "memory_peak_bytes": int(peak)}
    result = {"correct": correct, "attempted": loop.attempted,
              "failed": loop.failed, "metrics": metrics, "device": dev,
              "setup_peak_bytes": int(setup_peak)}
    if run.trace is not None:
        dev["busy_s"] = run.trace.busy_s
        dev["window_s"] = run.trace.window_s
        result["breakdown"] = run.trace.breakdown()
    result["checks"] = checks
    return 0, result


def _plain(v):
    """A number as JSON takes it: non-finite ones as strings."""
    if isinstance(v, float) and not math.isfinite(v):
        return str(v)
    if isinstance(v, dict):
        return {k: _plain(x) for k, x in v.items()}
    if isinstance(v, list):
        return [_plain(x) for x in v]
    return v


def result_line(result: dict) -> str:
    return json.dumps(_plain(result), allow_nan=False)


def check_lines(result: dict) -> list:
    """One line a compared number: its name, value and limit."""
    return [f"check {name} {c['value']!r} limit {c['limit']!r} "
            f"{'ok' if c['value'] <= c['limit'] else 'FAIL'}"
            for name, c in result["checks"].items()]
