"""Port parity: utils/tracing on torch.profiler against the JAX package's.

``device_sync`` returns the JAX function's checksum on the same nested tree;
``timed`` warms up once and calls ``fn`` ``n_runs`` more times; ``trace``
writes a trace file into ``log_dir`` that holds the ``annotate`` regions.
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
