"""Shared helpers of the PyTorch port's parity tests (tests/test_torch_*.py).

The port and the JAX package run in one process on the CPU: JAX with x64
(tests/conftest.py), torch with one thread per xdist worker. Inputs are made
with numpy at an explicit dtype and handed to both.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from corrla_rs_tpu.utils.prng import as_key
from corrla_rs_tpu_torch.models import dmd as port_dmd
from corrla_rs_tpu_torch.ops import random_svd as port_random_svd
from corrla_rs_tpu_torch.utils.device import default_device, set_default_device

torch.set_num_threads(1)

EPS = {np.float32: float(np.finfo(np.float32).eps),
       np.float64: float(np.finfo(np.float64).eps)}


def jax_sketch(seed, shape, dtype, device):
    """The JAX package's sketch for an int seed or a JAX key:
    ``jax.random.normal(as_key(seed), shape, dtype)``, drawn in that dtype
    (f32 and f64 draws differ, so it is not cast)."""
    jdt = jnp.float32 if dtype == torch.float32 else jnp.float64
    key = jax.random.key(int(seed)) if isinstance(seed, (int, np.integer)) \
        else seed
    draw = np.array(jax.random.normal(key, shape, jdt))
    return torch.from_numpy(draw).to(device)


def jax_split(seed, n, device):
    """The JAX package's ``jax.random.split(as_key(seed), n)``, in place of
    the port's child generators."""
    return jax.random.split(as_key(seed), int(n))


@pytest.fixture
def cpu_device():
    """Run the port on the CPU for one test."""
    prev = default_device()
    set_default_device("cpu")
    yield
    set_default_device(prev)


@pytest.fixture
def same_sketch(cpu_device, monkeypatch):
    """Port on the CPU, drawing the JAX package's sketch from the JAX
    package's keys (DMDc splits its seed as JAX does)."""
    monkeypatch.setattr(port_random_svd, "_draw_sketch", jax_sketch)
    monkeypatch.setattr(port_dmd, "_split_seed", jax_split)


def decaying(rng, shape, dtype, rate=0.8):
    """Gaussian matrix with columns scaled by rate**j: a decaying spectrum."""
    a = rng.standard_normal(shape) * rate ** np.arange(shape[1])[None, :]
    return a.astype(dtype)


def subspace_gap(a, b):
    """1 - min |diag(a^T b)|: 0 when the columns agree up to sign."""
    return float(1.0 - np.abs(np.sum(np.asarray(a) * np.asarray(b), 0)).min())
