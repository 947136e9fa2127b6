"""bench_torch.py, the port's counterpart of bench.py: its emission contract
(the mirror of tests/test_bench_contract.py) and its parity with bench.py.

- (a) a smoke run (CORRLA_BENCH_SMOKE, tiny shapes on the CPU) in a
  subprocess exits 0 and prints the five metrics with the headline first
  and again last, every line with bench.py's keys and check/ok/runs/card;
- (b) in-process, a phase that raises and one over its budget print no
  line, stderr names both, the headline is still last and the exit is 5;
- (c) a lost headline leaves the value-null sentinel last and exits 4;
- (d) a wrong answer from the port fails its line's check: "ok": false,
  exit 5;
- (e) neither bench_torch.py's source nor the smoke run imports JAX, the
  JAX package or bench.py;
- (f) the shapes, ranks, iterations, oversamples, keys, seeds, chain counts,
  bounds, repetitions and budgets equal bench.py's, read from its source
  with ast (bench.py is never run), and the inputs equal the arrays that
  bench.py's own expressions give;
- (g) the ensemble's check (``bench_torch.ensemble_check``): at the smoke
  size the batched fit holds it against the lone DMDc fits; a member whose
  eigenvalues move by 1e-3 of max|lambda|, or whose A~ moves by 1e-3 of its
  norm, fails it; and on bench.py's data the f32 and f64 lone fits, whose
  six eigenvalues lie far apart (the trailing four are rounding), hold it;
- without CORRLA_BENCH_SMOKE and without a card the bench exits 3 with no
  line (no CPU fallback).
"""
from __future__ import annotations

import ast
import json
import os
import re
import subprocess
import sys
import threading

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_dmd import _controlled

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

import bench_torch  # noqa: E402

BENCH_PY = os.path.join(ROOT, "bench.py")
BENCH_TORCH = os.path.join(ROOT, "bench_torch.py")
KEYS = {"metric", "value", "unit", "vs_baseline", "baseline", "check", "ok",
        "runs", "card"}
PHASES = ("headline_rsvd", "single_pass", "cs_mcmc", "dream",
          "ensemble_dmdc")
NO_JAX = ("jax", "jaxlib", "corrla_rs_tpu", "bench")

# the smoke run through runpy, then what of JAX (or bench.py) is loaded
SMOKE_RUN = r"""
import json, runpy, sys
sys.path.insert(0, {root!r})
code = 0
try:
    runpy.run_path({path!r}, run_name="__main__")
except SystemExit as exc:
    code = exc.code or 0
sys.stdout.flush()
print("MODULES " + json.dumps(sorted(
    m for m in sys.modules if m.split(".")[0] in {no_jax!r})),
    file=sys.stderr)
sys.exit(code)
"""


def _json_lines(stdout: str) -> list:
    return [json.loads(ln) for ln in stdout.splitlines()
            if ln.startswith("{")]


def _env(**extra):
    env = {k: v for k, v in os.environ.items()
           if k != "PYTHONPATH" and not k.startswith("CORRLA_BENCH_")}
    env.update(PYTHONPATH=ROOT, OMP_NUM_THREADS="1", CUDA_VISIBLE_DEVICES="",
               **extra)
    return env


@pytest.fixture(scope="module")
def smoke_run():
    proc = subprocess.run(
        [sys.executable, "-c", SMOKE_RUN.format(
            root=ROOT, path=BENCH_TORCH, no_jax=NO_JAX)],
        cwd=ROOT, env=_env(CORRLA_BENCH_SMOKE="1"), capture_output=True,
        text=True, timeout=300)
    mods = [ln for ln in proc.stderr.splitlines() if ln.startswith("MODULES ")]
    return proc, _json_lines(proc.stdout), json.loads(mods[-1][8:])


# ---------------------------------------------------------------------------
# (a), (e): the smoke run

def test_smoke_run_prints_the_five_metrics_headline_first_and_last(
        smoke_run):
    proc, lines, _ = smoke_run
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert len(lines) == 6, proc.stdout
    assert lines[0]["metric"] == bench_torch.HEADLINE
    assert lines[0] == lines[-1]
    assert sorted(ln["metric"] for ln in lines[:-1]) == sorted(
        _bench_py_metrics())
    for ln in lines:
        assert set(ln) >= KEYS, ln
        assert isinstance(ln["baseline"], str) and ln["baseline"]
        assert ln["ok"] is True, ln
        assert ln["card"] == "cpu (smoke)"
        assert ln["runs"] and all(w > 0 for w in ln["runs"])
        assert all(set(v) == {"value", "limit"} for k, v in
                   ln["check"].items() if k not in ("limits", "note"))
    assert "kernel launches" in proc.stderr


@pytest.mark.parametrize("phase", PHASES)
def test_smoke_lines_say_which_limits_bind(smoke_run, phase):
    # the sigma and DREAM limits cannot bind at the smoke shapes; the
    # sampler's and the ensemble's do
    _, lines, _ = smoke_run
    metric = {"headline_rsvd": "rsvd_100kx10k_f32_rank100_wall",
              "single_pass": "single_pass_svd_100kx10k_wall",
              "cs_mcmc": "cs_mcmc_3000x12_wall",
              "dream": "dream_samples_per_sec_8192ch",
              "ensemble_dmdc": "ensemble_dmdc_16x_wall"}[phase]
    (ln,) = [ln for ln in lines[:-1] if ln["metric"] == metric]
    assert len(ln["runs"]) == bench_torch.REPS[phase]
    binds_in_smoke = phase in ("cs_mcmc", "ensemble_dmdc")
    assert ("limits" in ln["check"]) is not binds_in_smoke
    if phase == "cs_mcmc":
        assert ln["route"] in ("device", "host C++")
        assert ln["cpu_route_wall"] == pytest.approx(np.median(ln["runs"]))
    if phase == "ensemble_dmdc":
        value = ln["check"]["eig_err_supported_vs_lone_fits"]["value"]
        assert value <= bench_torch.ENSEMBLE_EIG_RTOL
        for name in ("one_step_residual", "one_step_vs_lone_fits"):
            assert ln["check"][name]["value"] <= \
                bench_torch.ENSEMBLE_RESIDUAL_TOL
        assert ln["supported_modes"] == [2] * bench_torch.sizes(True)[
            "ensemble"][0]


def test_no_jax_in_the_source_or_the_smoke_run(smoke_run):
    _, _, modules = smoke_run
    assert modules == []
    with open(BENCH_TORCH) as f:
        src = f.read()
    pat = re.compile(r"^\s*(import|from)\s+(jax|jaxlib|corrla_rs_tpu|bench)"
                     r"\b", re.M)
    assert not pat.findall(src)


def test_without_a_card_the_bench_exits_3_with_no_line():
    proc = subprocess.run([sys.executable, BENCH_TORCH], cwd=ROOT,
                          env=_env(), capture_output=True, text=True,
                          timeout=120)
    assert proc.returncode == 3
    assert proc.stdout == ""
    assert "no CUDA device" in proc.stderr


# ---------------------------------------------------------------------------
# (b), (c), (d): the runner, in-process

def _bench():
    return bench_torch.Bench("cpu", True, "cpu (smoke)")


def _fake(b, metric, ok=True):
    def fn():
        return b.line(metric, [0.01], 0.01, "s", None, "fake_baseline",
                      [("held", ok, True, ok, True)])
    return fn


def test_a_raising_and_an_overrunning_phase_are_reported(capsys):
    b = _bench()
    release = threading.Event()

    def raises():
        raise RuntimeError("injected")

    def overruns():
        release.wait(60)

    try:
        code = bench_torch.run(b, [
            ("headline_rsvd", _fake(b, bench_torch.HEADLINE)),
            ("cs_mcmc", raises),
            ("dream", overruns),
            ("ensemble_dmdc", _fake(b, "ensemble_dmdc_16x_wall"))], 30, 0.5)
    finally:
        release.set()
    out, err = capsys.readouterr()
    lines = _json_lines(out)
    assert code == 5
    assert [ln["metric"] for ln in lines] == [
        bench_torch.HEADLINE, "ensemble_dmdc_16x_wall", bench_torch.HEADLINE]
    assert lines[0] == lines[-1]
    assert "'cs_mcmc' failed" in err and "RuntimeError: injected" in err
    assert "'dream' exceeded its 0.5 s budget" in err
    # the line after the breach says its times are suspect
    assert "dream" in lines[1]["check"]["note"]
    assert "note" not in lines[0]["check"]


@pytest.mark.parametrize("how", ["raises", "overruns"])
def test_a_lost_headline_leaves_the_sentinel_last(capsys, how):
    b = _bench()
    release = threading.Event()

    def headline():
        if how == "raises":
            raise RuntimeError("injected")
        release.wait(60)

    try:
        code = bench_torch.run(b, [
            ("headline_rsvd", headline),
            ("dream", _fake(b, "dream_samples_per_sec_8192ch"))], 0.5, 30)
    finally:
        release.set()
    out, err = capsys.readouterr()
    last = _json_lines(out)[-1]
    assert code == 4
    assert last["metric"] == bench_torch.HEADLINE
    assert last["value"] is None and "error" in last
    assert "headline_rsvd" in err


def test_a_failed_headline_check_still_ends_the_output(capsys):
    b = _bench()
    code = bench_torch.run(b, [
        ("headline_rsvd", _fake(b, bench_torch.HEADLINE, ok=False)),
        ("dream", _fake(b, "dream_samples_per_sec_8192ch"))], 30, 30)
    out, err = capsys.readouterr()
    lines = _json_lines(out)
    assert code == 5
    assert lines[0] == lines[-1] and lines[-1]["ok"] is False
    assert "'headline_rsvd' failed its check" in err


def test_a_wrong_ensemble_fails_its_check(capsys, monkeypatch):
    from corrla_rs_tpu_torch.models import dmd

    fit_ensemble = dmd.dmdc_fit_ensemble

    def wrong(*args, **kwargs):
        fit = fit_ensemble(*args, **kwargs)
        fit["lambdas_re"][1] += 1e-3
        return fit

    monkeypatch.setattr(dmd, "dmdc_fit_ensemble", wrong)
    b = _bench()
    code = bench_torch.run(b, [
        ("headline_rsvd", _fake(b, bench_torch.HEADLINE)),
        ("ensemble_dmdc", lambda: bench_torch.bench_ensemble_dmdc(b))],
        30, 60)
    out, err = capsys.readouterr()
    lines = _json_lines(out)
    assert code == 5
    assert lines[1]["metric"] == "ensemble_dmdc_16x_wall"
    assert lines[1]["ok"] is False
    assert lines[1]["check"]["eig_err_supported_vs_lone_fits"]["value"] \
        > 5e-4
    assert lines[-1]["metric"] == bench_torch.HEADLINE
    assert "'ensemble_dmdc' failed its check" in err


# ---------------------------------------------------------------------------
# (f): bench.py's arguments and inputs, from its source

with open(BENCH_PY) as _f:
    TREE = ast.parse(_f.read())


def _func(name):
    return next(n for n in TREE.body
                if isinstance(n, ast.FunctionDef) and n.name == name)


def _calls(node, callee):
    return [n for n in ast.walk(node) if isinstance(n, ast.Call) and (
        getattr(n.func, "id", None) == callee
        or getattr(n.func, "attr", None) == callee)]


def _assign(node, target):
    """The value node of ``target = ...`` (a name or a tuple of names)."""
    for n in ast.walk(node):
        if isinstance(n, ast.Assign):
            t = n.targets[0]
            names = ([e.id for e in t.elts] if isinstance(t, ast.Tuple)
                     else [getattr(t, "id", None)])
            if names == target:
                return n.value
    raise KeyError(target)


def _module_constants(tree, smoke_name):
    """Module-level constants of a bench file, full and smoke: literal
    assignments, and float(os.environ.get(name, default)) as its
    default."""
    def values(body, into):
        for n in body:
            if isinstance(n, ast.Assign):
                t = n.targets[0]
                names = ([e.id for e in t.elts] if isinstance(t, ast.Tuple)
                         else [getattr(t, "id", None)])
                v = n.value
                if (isinstance(v, ast.Call)
                        and getattr(v.func, "id", None) == "float"):
                    v = v.args[0].args[1]
                try:
                    lit = ast.literal_eval(v)
                except ValueError:
                    continue
                if len(names) > 1:
                    into.update(zip(names, lit))
                else:
                    into[names[0]] = lit

    full = {}
    values(tree.body, full)
    smoke = dict(full)
    for n in tree.body:
        if isinstance(n, ast.If) and getattr(n.test, "id", None) == smoke_name:
            values(n.body, smoke)
    return full, smoke


def _lit(node, env):
    """A literal argument, a module constant, or jax.random.key(k)'s k."""
    if isinstance(node, ast.Name):
        return env[node.id]
    if isinstance(node, ast.Call):
        return _lit(node.args[0], env)
    return ast.literal_eval(node)


def _kw(call, env, skip=()):
    return {k.arg: _lit(k.value, env) for k in call.keywords
            if k.arg not in skip}


def _reps(func_name):
    (call,) = _calls(_func(func_name), "_min_wall")
    kw = _kw(call, {})
    default = _func("_min_wall").args.defaults[0].value
    return kw.get("reps", default)


def _bench_py_metrics():
    return [c.args[0].value for fn in TREE.body
            if isinstance(fn, ast.FunctionDef) and fn.name.startswith("bench")
            for c in _calls(fn, "_metric_line")]


def _ifexp(func_name, target):
    v = _assign(_func(func_name), target)
    return ast.literal_eval(v.body), ast.literal_eval(v.orelse)


FULL, SMOKE = _module_constants(TREE, "_SMOKE")
with open(BENCH_TORCH) as _f:
    PORT_FULL, PORT_SMOKE = _module_constants(ast.parse(_f.read()), "SMOKE")


@pytest.mark.parametrize("smoke", [False, True])
def test_svd_shapes_and_budgets_equal_bench_py(smoke):
    env = SMOKE if smoke else FULL
    port_env = PORT_SMOKE if smoke else PORT_FULL
    assert bench_torch.sizes(smoke)["svd"] == tuple(
        env[k] for k in ("N_ROWS", "N_COLS", "RANK", "N_ITER",
                         "N_OVERSAMPLES"))
    for k in ("HEADLINE_BUDGET_S", "PHASE_BUDGET_S"):
        assert float(port_env[k]) == float(env[k])


def test_rsvd_and_single_pass_calls_equal_bench_py():
    (call,) = _calls(_func("bench_headline_rsvd"), "random_svd")
    n, m, rank, n_iter, n_os = bench_torch.sizes(False)["svd"]
    assert [_lit(a, FULL) for a in call.args[1:]] == [rank, n_iter, n_os]
    # power_precision has no counterpart: the port's power iteration runs
    # in full fp32 with TF32 off
    assert "power_precision" in [k.arg for k in call.keywords]
    assert _kw(call, FULL, skip={"power_precision"}) == bench_torch.RSVD_KW
    (call,) = _calls(_func("bench_single_pass"), "single_pass_svd")
    assert [_lit(a, FULL) for a in call.args[1:]] == [rank, n_os]
    assert _kw(call, FULL) == {"key": bench_torch.SINGLE_PASS_KEY}
    assert (_reps("bench_headline_rsvd"), _reps("bench_single_pass")) == (
        bench_torch.REPS["headline_rsvd"], bench_torch.REPS["single_pass"])
    # bench.py draws its matrix from jax.random.key(0): the port's is
    # seeded alike, and the known spectrum has 200 sigma
    (call,) = _calls(_assign(_func("bench_headline_rsvd"), ["a"]), "key")
    assert _lit(call, FULL) == bench_torch.MATRIX_SEED


def test_cs_mcmc_call_equals_bench_py():
    fn = _func("bench_small_mcmc")
    (bounds,) = _calls(_assign(fn, ["bounds"]), "array")
    assert ast.literal_eval(bounds.args[0]) == bench_torch.CS_MCMC_BOUNDS
    (call,) = _calls(fn, "cs_mcmc_dirichlet_sample")
    assert tuple(_lit(a, FULL) for a in call.args[1:]) == \
        bench_torch.CS_MCMC_ARGS
    assert _kw(call, FULL) == {"seed": bench_torch.CS_MCMC_SEED}
    assert _reps("bench_small_mcmc") == bench_torch.REPS["cs_mcmc"]


def test_dream_call_and_heads_equal_bench_py():
    fn = _func("bench_dream")
    smoke, full = _ifexp("bench_dream", ["n_chains", "ndim", "n_steps"])
    assert (full, smoke) == (bench_torch.sizes(False)["dream"],
                             bench_torch.sizes(True)["dream"])
    (call,) = _calls(fn, "dream_run")
    assert _kw(call, FULL) == {"key": bench_torch.DREAM_KEY}
    (rng,) = _calls(fn, "default_rng")
    assert _lit(rng.args[0], FULL) == bench_torch.DREAM_INIT_SEED
    assert _reps("bench_dream") == bench_torch.REPS["dream"]
    # bench.py's own expression, under numpy and jax.numpy
    for n_chains, ndim, _ in (full, smoke):
        scope = {"np": np, "jnp": jnp, "n_chains": n_chains, "ndim": ndim}
        want = np.asarray(eval(compile(ast.Expression(
            _assign(fn, ["heads0"])), "bench.py", "eval"), scope))
        got = bench_torch.dream_heads(n_chains, ndim)
        assert got.dtype == want.dtype == np.float32
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-7)


def test_ensemble_call_and_data_equal_bench_py():
    fn = _func("bench_ensemble_dmdc")
    smoke, full = _ifexp("bench_ensemble_dmdc", ["n_mem", "nx", "nt"])
    assert (full, smoke) == (bench_torch.sizes(False)["ensemble"],
                             bench_torch.sizes(True)["ensemble"])
    (call,) = _calls(fn, "dmdc_fit_ensemble")
    assert _kw(call, FULL) == bench_torch.ENSEMBLE_KW
    assert _reps("bench_ensemble_dmdc") == bench_torch.REPS["ensemble_dmdc"]
    # bench.py's statements from the shapes to u_b, under jax.numpy
    body = fn.body
    first = next(i for i, n in enumerate(body) if isinstance(n, ast.Assign)
                 and isinstance(n.targets[0], ast.Tuple))
    last = next(i for i, n in enumerate(body) if isinstance(n, ast.Assign)
                and getattr(n.targets[0], "id", None) == "u_b")
    code = compile(ast.Module(body[first:last + 1], []), "bench.py", "exec")
    for is_smoke, shape in ((False, full), (True, smoke)):
        scope = {"np": np, "jnp": jnp, "_SMOKE": is_smoke}
        exec(code, scope)
        ens, u_b = bench_torch.ensemble_data(*shape)
        for got, want in ((ens, scope["ens"]), (u_b, scope["u_b"])):
            want = np.asarray(want)
            assert got.shape == want.shape and got.dtype == want.dtype
            # jax's f32 exp and sin are not correctly rounded: the arrays
            # agree to 2 ulp of their largest entry (measured 1.3e-7 of
            # it at 16 members)
            atol = 2 * np.spacing(np.abs(want).max())
            np.testing.assert_allclose(got, want, rtol=0, atol=atol)
            assert np.abs(got - want).max() <= 2e-7 * np.abs(want).max()


# ---------------------------------------------------------------------------
# (g): the ensemble's check

def test_ensemble_phase_holds_at_the_smoke_size():
    line = bench_torch.bench_ensemble_dmdc(_bench())
    assert line["ok"] is True
    check = line["check"]
    assert set(check) == {
        "finite_and_shapes", "eig_err_supported_vs_lone_fits",
        "one_step_residual", "one_step_vs_lone_fits"}
    assert check["eig_err_supported_vs_lone_fits"]["value"] <= \
        bench_torch.ENSEMBLE_EIG_RTOL
    for name in ("one_step_residual", "one_step_vs_lone_fits"):
        assert check[name]["value"] <= bench_torch.ENSEMBLE_RESIDUAL_TOL
    assert line["sequential_wall"] > 0


def _bench_members():
    ens, u_b = bench_torch.ensemble_data(*bench_torch.sizes(True)["ensemble"])
    return torch.as_tensor(ens), torch.as_tensor(u_b)


def _controlled_members():
    # test_torch_dmd's driven linear systems, three members in f32
    xs, us = zip(*(_controlled(np.float32, seed=s) for s in range(3)))
    return torch.as_tensor(np.stack(xs)), torch.as_tensor(np.stack(us))


def _held(ens, u_b, fit, singles):
    """(the check's result, whether it holds at the bench's limits)."""
    held = bench_torch.ensemble_check(ens, u_b, fit,
                                      bench_torch.stacked(singles))
    return held, bench_torch.ensemble_held(held)


@pytest.mark.parametrize("member", [0, -1])
@pytest.mark.parametrize("data", [_bench_members, _controlled_members],
                         ids=["bench", "controlled"])
def test_ensemble_check_catches_a_member_off_by_1e_3(data, member):
    # bench.py's data support 2 modes of 6 (the projected comparison), the
    # controlled systems 8 (all six eigenvalues compared)
    from corrla_rs_tpu_torch.models.dmd import dmdc_fit_ensemble

    ens, u_b = data()
    fit = dmdc_fit_ensemble(ens, u_b, **bench_torch.ENSEMBLE_KW)
    singles = bench_torch.lone_fits(ens, u_b)
    held, ok = _held(ens, u_b, fit, singles)
    assert ok, held
    r = bench_torch.ENSEMBLE_KW["n_modes"]
    assert all((k < r) == (data is _bench_members)
               for k in held["supported"]), held
    radius = max(np.abs(s.lambdas).max() for s in singles)
    fit["lambdas_im"][member] += 1e-3 * radius
    held, ok = _held(ens, u_b, fit, singles)
    assert held["eig_err"] > bench_torch.ENSEMBLE_EIG_RTOL and not ok


@pytest.mark.parametrize("member", [0, -1])
@pytest.mark.parametrize("data", [_bench_members, _controlled_members],
                         ids=["bench", "controlled"])
def test_ensemble_check_catches_a_til_off_by_1e_3(data, member):
    from corrla_rs_tpu_torch.models.dmd import dmdc_fit_ensemble

    ens, u_b = data()
    fit = dmdc_fit_ensemble(ens, u_b, **bench_torch.ENSEMBLE_KW)
    singles = bench_torch.lone_fits(ens, u_b)
    a = fit["a_til"][member]
    e = torch.as_tensor(np.random.default_rng(7).standard_normal(
        tuple(a.shape)), dtype=a.dtype)
    a += 1e-3 * torch.linalg.matrix_norm(a) * e / torch.linalg.matrix_norm(e)
    held, ok = _held(ens, u_b, fit, singles)
    assert not ok, held
    assert held["vs_lone"] > bench_torch.ENSEMBLE_RESIDUAL_TOL, held


def test_f32_and_f64_fits_differ_in_rounding_and_hold_the_check():
    # bench.py's data: the trailing four of the six eigenvalues are set by
    # rounding, so the f32 and f64 lone fits of the same data differ there
    # by far more than 1e-4 of max|lambda| (0.39 on the CPU), while what
    # the data determine agrees
    n_mem, nx, nt = bench_torch.sizes(False)["ensemble"]
    ens, u_b = (torch.as_tensor(a)
                for a in bench_torch.ensemble_data(n_mem, nx, nt))
    f32 = bench_torch.lone_fits(ens, u_b)
    f64 = bench_torch.lone_fits(ens.double(), u_b.double())
    all_six = max(bench_torch.eig_gap(a.lambdas, b.lambdas)
                  for a, b in zip(f64, f32))
    assert all_six > 0.1
    held, ok = _held(ens, u_b, bench_torch.stacked(f64), f32)
    assert ok, held
    assert held["supported"] == [2] * n_mem
