"""Port parity: utils/tracing on torch.profiler against the JAX package's.

``device_sync`` returns the JAX function's checksum on the same nested tree;
``timed`` warms up once and calls ``fn`` ``n_runs`` more times; ``trace``
writes a trace file into ``log_dir`` that holds the ``annotate`` regions.
The package's own spans: none is recorded without a profiler, each fit
opens its spans once inside its caller's, ``PodI.predict`` its modes
product's once a call, and an exported program holds no profiler node.
"""
import glob
import json
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import cpu_device  # noqa: F401 (fixture)
from corrla_rs_tpu.utils import tracing as jax_tracing
from corrla_rs_tpu_torch.utils import tracing

torch.set_num_threads(1)


def _tree(rng):
    """A nested tree of arrays (numpy) with an empty leaf, a complex one, an
    integer one and a non-array leaf."""
    return {"a": [rng.standard_normal((3, 2)), np.zeros((0, 4))],
            "b": (rng.standard_normal(5) + 1j * rng.standard_normal(5),
                  {"c": np.arange(6, dtype=np.int64).reshape(2, 3) + 7}),
            "d": 2.5}


def _map(tree, fn):
    if isinstance(tree, dict):
        return {k: _map(v, fn) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_map(v, fn) for v in tree)
    return fn(tree) if isinstance(tree, np.ndarray) else tree


def test_device_sync_equals_the_jax_checksum(rng):
    tree = _tree(rng)
    got = tracing.device_sync(_map(tree, torch.as_tensor))
    want = jax_tracing.device_sync(_map(tree, jnp.asarray))
    assert got == pytest.approx(want, rel=1e-15)
    assert tracing.device_sync([]) == 0.0


@pytest.mark.parametrize("n_runs", [1, 3])
def test_timed_returns_best_and_last_result(n_runs):
    calls = []

    def fn(x, scale=1.0):
        calls.append(x)
        return torch.full((2,), float(len(calls)) * scale)

    best, result = tracing.timed(fn, 4, n_runs=n_runs, scale=2.0)
    assert len(calls) == 1 + n_runs
    assert 0.0 <= best < 5.0
    assert result.tolist() == [2.0 * (1 + n_runs)] * 2


def test_trace_writes_the_annotated_regions(cpu_device, tmp_path):
    log_dir = str(tmp_path / "trace")
    with tracing.trace(log_dir) as prof:
        with tracing.annotate("rsvd_block"):
            x = torch.ones(64, 64) @ torch.ones(64, 64)
        with tracing.annotate("other_block"):
            x = x + 1.0
    assert float(x[0, 0]) == 65.0
    files = glob.glob(os.path.join(log_dir, "*.pt.trace.json"))
    assert len(files) == 1
    with open(files[0]) as f:
        names = {e.get("name") for e in json.load(f)["traceEvents"]}
    assert {"rsvd_block", "other_block"} <= names
    assert "rsvd_block" in {e.key for e in prof.key_averages()}


def _refuse_record_function(monkeypatch):
    def refuse(name, *args, **kwargs):
        raise AssertionError(f"record_function({name!r}) with no profiler")

    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    monkeypatch.setattr(torch.autograd.profiler, "record_function", refuse)


def _pod_and_rbf_fits(rng):
    """A small ``PodI`` fit (10 snapshots of 120 points, 3 modes) and a
    small ``RbfInterp`` fit of 40 points in 2-D, on the CPU."""
    from corrla_rs_tpu_torch.models.pod import PodI
    from corrla_rs_tpu_torch.ops.interp import RbfInterp

    t = torch.linspace(1.0, 9.0, 10, dtype=torch.float64)[:, None]
    x = torch.exp(-(torch.linspace(0.0, 10.0, 120, dtype=torch.float64)
                    - t) ** 2 / 8.0)
    pts = torch.as_tensor(rng.standard_normal((40, 2)))
    return (lambda: PodI(x, t, 3, key=1, device="cpu"),
            lambda: RbfInterp(2, 1.0, 2, 1, device="cpu").fit(
                pts, torch.sin(pts).sum(1, keepdim=True)))


def test_annotate_records_nothing_without_a_profiler(cpu_device, rng,
                                                     monkeypatch):
    _refuse_record_function(monkeypatch)
    span = tracing.annotate("corrla.rsvd")
    assert span is tracing.annotate("corrla.solve.saddle")
    with span:
        pass
    # the package's own spans take the same road on the fit paths
    for fit in _pod_and_rbf_fits(rng):
        fit()


_PRODUCTS, _ORTH = "corrla.rsvd.products", "corrla.rsvd.orth"
# the RSVD of PodI's float64 fit: 10 iterations, a thin QR from the fourth on
_POD_RSVD = (["corrla.rsvd", _PRODUCTS] + [_PRODUCTS, _PRODUCTS] * 3
             + [_ORTH, _PRODUCTS, _PRODUCTS] * 7
             + [_ORTH, _PRODUCTS, "corrla.rsvd.svd"])
# spans each fit opens, in this order (a span's inner spans after it)
FIT_SPANS = {"pod": _POD_RSVD + ["corrla.solve.pinv", "corrla.solve.saddle"],
             "rbf": ["corrla.solve.saddle"]}


@pytest.mark.parametrize("model", ["pod", "rbf"])
def test_each_fit_opens_its_spans_once_inside_the_callers(cpu_device, rng,
                                                          model):
    fit = dict(zip(("pod", "rbf"), _pod_and_rbf_fits(rng)))[model]
    activities = [torch.profiler.ProfilerActivity.CPU]
    with torch.profiler.profile(activities=activities) as prof:
        for _ in range(2):
            with tracing.annotate("caller.fit"):
                fit()
    events = sorted((e.time_range.start, e.time_range.end, e.name)
                    for e in prof.events()
                    if e.name == "caller.fit" or e.name.startswith("corrla."))
    callers = [(a, b) for a, b, name in events if name == "caller.fit"]
    assert len(callers) == 2
    for a, b in callers:
        inside = [name for s, e, name in events
                  if name != "caller.fit" and a <= s and e <= b]
        assert inside == FIT_SPANS[model]
    spans = [name for _, _, name in events if name != "caller.fit"]
    assert len(spans) == 2 * len(FIT_SPANS[model])


def test_pod_predict_opens_the_modes_span_once_a_call(cpu_device, rng,
                                                     monkeypatch):
    # the modes product, inside the caller's span, once a predict call;
    # nothing without a profiler
    pod = _pod_and_rbf_fits(rng)[0]()
    tq = torch.tensor([[2.0], [4.5], [7.0]], dtype=torch.float64)
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        for _ in range(3):
            with tracing.annotate("caller.predict"):
                want = pod.predict(tq)
    events = sorted((e.time_range.start, e.time_range.end, e.name)
                    for e in prof.events()
                    if e.name in ("caller.predict", "corrla.pod.modes"))
    callers = [(a, b) for a, b, name in events if name == "caller.predict"]
    spans = [(a, b) for a, b, name in events if name == "corrla.pod.modes"]
    assert len(callers) == len(spans) == 3
    for (a, b), (s, e) in zip(callers, spans):
        assert a <= s and e <= b
    _refuse_record_function(monkeypatch)
    assert torch.equal(pod.predict(tq), want)


@pytest.mark.parametrize("members", [None, 3], ids=["one", "members"])
@pytest.mark.parametrize("n_iter", [0, 3])
def test_random_svd_opens_its_inner_spans_inside_its_own(cpu_device, rng,
                                                         monkeypatch,
                                                         n_iter, members):
    # the member pass (the DMDc ensemble's) opens the same spans once a
    # pass over all its members
    from corrla_rs_tpu_torch.ops.random_svd import (
        _random_svd_members,
        random_svd,
    )

    shape = (96, 40) if members is None else (members, 96, 40)
    a = torch.as_tensor(rng.standard_normal(shape), dtype=torch.float32)

    def rsvd():
        if members is None:
            return random_svd(a, 5, n_iter, 4, key=3)
        return _random_svd_members(a, 5, n_iter, 4, range(3, 3 + members))

    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        want = rsvd()
    events = [(e.time_range.start, e.time_range.end, e.name)
              for e in prof.events() if e.name.startswith("corrla.")]
    outer = [(s, e) for s, e, name in events if name == "corrla.rsvd"]
    assert len(outer) == 1
    lo, hi = outer[0]
    inner = [name for s, e, name in events if name != "corrla.rsvd"]
    assert all(lo <= s and e <= hi for s, e, name in events)
    # float32: a thin QR every iteration, then the final Householder QR
    assert inner.count(_PRODUCTS) == 2 + 2 * n_iter
    assert inner.count(_ORTH) == n_iter + 1
    assert inner.count("corrla.rsvd.svd") == 1
    assert len(inner) == 3 * n_iter + 4
    # without a profiler no span is opened, and the answer is the same
    _refuse_record_function(monkeypatch)
    got = rsvd()
    for g, w in zip(got, want):
        assert torch.equal(g, w)


def test_an_exported_random_svd_holds_no_profiler_node(cpu_device, rng,
                                                       tmp_path):
    from corrla_rs_tpu_torch.ops.random_svd import random_svd
    from corrla_rs_tpu_torch.utils.export import export_fn

    a = torch.as_tensor(rng.standard_normal((64, 16)))
    program = export_fn(lambda a: random_svd(a, 4, 6, 4, key=1), (a,),
                        str(tmp_path / "rsvd.pt2"))
    targets = [str(n.target) for n in program.graph.nodes]
    assert any("linalg_svd" in t for t in targets)
    assert not [t for t in targets if "profiler" in t or "record" in t]
