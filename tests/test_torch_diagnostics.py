"""Port parity: ops.diagnostics against the JAX package, on the same
histories: 1e-10 stated (float64 sums in another order, an FFT, and
``torch.special.ndtri`` against ``jax.scipy.special.ndtri``)."""
import numpy as np
import pytest
import torch

from _torch_parity import cpu_device  # noqa: F401 (fixture)
from corrla_rs_tpu.ops import diagnostics as jax_diag
from corrla_rs_tpu_torch.ops import diagnostics as port_diag

torch.set_num_threads(1)

RTOL = 1e-10


def ar1(rng, n, m, d, rho):
    """AR(1) chains with lag-1 correlation rho: a correlated history."""
    x = np.zeros((n, m, d))
    x[0] = rng.standard_normal((m, d))
    for t in range(1, n):
        x[t] = rho * x[t - 1] + np.sqrt(1 - rho ** 2) * rng.standard_normal(
            (m, d))
    return x


def mcmc_like(rng, n, m, d):
    """A tie-heavy history: each step keeps the previous draw half the
    time, as a rejection does."""
    x = ar1(rng, n, m, d, 0.5)
    keep = rng.random((n, m, 1)) < 0.5
    for t in range(1, n):
        x[t] = np.where(keep[t], x[t - 1], x[t])
    return x


HISTORIES = {
    "iid": lambda rng: rng.standard_normal((200, 6, 3)),
    "odd-length": lambda rng: rng.standard_normal((101, 4, 2)),
    "correlated": lambda rng: ar1(rng, 300, 5, 2, 0.9),
    "ties": lambda rng: mcmc_like(rng, 250, 6, 2),
    "shifted-chains": lambda rng: rng.standard_normal((120, 4, 2))
    + np.arange(4)[None, :, None],
    "one-chain": lambda rng: ar1(rng, 200, 1, 2, 0.6),
}


@pytest.mark.parametrize("fn", ["gelman_rubin", "effective_sample_size",
                                "rank_normalized_rhat"])
@pytest.mark.parametrize("kind", sorted(HISTORIES))
def test_matches_jax(cpu_device, rng, fn, kind):
    h = HISTORIES[kind](rng)
    if kind == "one-chain" and fn != "effective_sample_size":
        h = np.concatenate([h, h[::-1]], axis=1)   # R-hat needs two chains
    want = np.asarray(getattr(jax_diag, fn)(h))
    got = getattr(port_diag, fn)(torch.tensor(h))
    assert got.shape == (h.shape[2],) and got.dtype == torch.float64
    np.testing.assert_allclose(got.numpy(), want, rtol=RTOL)
    # numpy in: the same numbers, on the default device
    np.testing.assert_allclose(getattr(port_diag, fn)(h).numpy(), want,
                               rtol=RTOL)


def test_f32_history_and_what_the_values_mean(cpu_device, rng):
    h = rng.standard_normal((400, 8, 2)).astype(np.float32)
    rhat = port_diag.gelman_rubin(torch.tensor(h))
    assert rhat.dtype == torch.float32
    assert float((rhat - 1).abs().max()) < 0.02
    ess = port_diag.effective_sample_size(torch.tensor(h))
    assert float(ess.min()) > 2000 and float(ess.max()) < 3200 * 1.5
    apart = h + 5.0 * np.arange(8, dtype=np.float32)[None, :, None]
    assert float(port_diag.rank_normalized_rhat(torch.tensor(apart)).min()) > 2
    slow = ar1(rng, 2000, 4, 1, 0.95)
    assert float(port_diag.effective_sample_size(slow)[0]) < 0.15 * 8000
