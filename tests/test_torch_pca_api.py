"""Port parity: api.rsvd / api.rpca / PcaRsvd against the JAX package."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import corrla_rs_tpu as crt
import corrla_rs_tpu_torch as port
from _torch_parity import (  # noqa: F401 (fixtures)
    cpu_device,
    decaying,
    same_sketch,
    subspace_gap,
)

torch.set_num_threads(1)

# sigma rtol / subspace gap: f64 to rounding (measured ~1e-15), f32 on the
# always/cholesky path (measured ~1e-6)
TOL = {np.float64: (1e-10, 1e-8), np.float32: (1e-5, 1e-4)}


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
def test_rsvd_matches_jax(same_sketch, rng, dtype):
    a = decaying(rng, (80, 24), dtype)
    uj, sj, vj = crt.rsvd(a, 6, 10, 8, seed=11)
    ut, st, vt = port.rsvd(a, 6, 10, 8, seed=11)
    assert st.shape == (6, 1) == sj.shape
    assert ut.shape == (80, 6) and vt.shape == (6, 24)
    rtol, gap = TOL[dtype]
    np.testing.assert_allclose(st.numpy(), np.asarray(sj), rtol=rtol)
    assert subspace_gap(uj, ut) <= gap
    assert subspace_gap(np.asarray(vj).T, vt.numpy().T) <= gap


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
def test_rpca_matches_jax(same_sketch, rng, dtype):
    # rpca ignores n_iters / n_oversamples (pca_rsvd.rs:65-66) in both
    a = (decaying(rng, (150, 20), dtype) + 3.0).astype(dtype)
    sj, cj = crt.rpca(a, 5, 1, 1, seed=4)
    st, ct = port.rpca(a, 5, 1, 1, seed=4)
    assert st.shape == (5, 1) == sj.shape and ct.shape == (5, 20)
    rtol, gap = TOL[dtype]
    np.testing.assert_allclose(st.numpy(), np.asarray(sj), rtol=rtol)
    assert subspace_gap(np.asarray(cj).T, ct.numpy().T) <= gap


def test_pca_rsvd_transforms_match_jax(same_sketch, rng):
    x = decaying(rng, (120, 16), np.float64, rate=0.7) + 1.5
    t = decaying(rng, (30, 16), np.float64, rate=0.7) - 0.5
    pj = crt.PcaRsvd(x, 4, key=2)
    pt = port.PcaRsvd(x, 4, key=2)
    assert pt.n_samples == pj.n_samples and pt.pca_rank == 4
    np.testing.assert_allclose(pt.explained_var().numpy(),
                               np.asarray(pj.explained_var()), rtol=1e-10)
    np.testing.assert_allclose(pt.means.numpy(), np.asarray(pj.means),
                               rtol=1e-13)
    # projections carry the components' signs: align them first
    sign = np.sign(np.sum(np.asarray(pj.components) * pt.components.numpy(),
                          axis=1))
    np.testing.assert_allclose(pt.apply_tr(t).numpy() * sign,
                               np.asarray(pj.apply_tr(t)), atol=1e-10)
    red = rng.standard_normal((7, 4))
    np.testing.assert_allclose(pt.apply_inv_tr(red * sign).numpy(),
                               np.asarray(pj.apply_inv_tr(red)), atol=1e-10)


def test_pca_config_and_n_iter(same_sketch, rng):
    x = decaying(rng, (60, 12), np.float64, rate=0.6)
    cfg = port.utils.config.PcaConfig(n_iter=3, max_oversamples=2,
                                      stabilize="always")
    pt = port.PcaRsvd(x, 3, key=1, config=cfg)
    assert (pt._n_iter, pt._max_oversamples, pt._stabilize) == (3, 2, "always")
    pj = crt.PcaRsvd(x, 3, key=1, config=crt.utils.config.PcaConfig(
        n_iter=3, max_oversamples=2, stabilize="always"))
    np.testing.assert_allclose(pt.singular_values.numpy(),
                               np.asarray(pj.singular_values), rtol=1e-10)
    assert port.PcaRsvd(x, 3, n_iter=5)._n_iter == 5


def test_debug_mode_flags_non_finite(cpu_device, rng):
    a = rng.standard_normal((20, 6))
    a[3, 2] = np.nan
    assert not port.debug_enabled()
    port.set_debug(True)
    try:
        with pytest.raises(port.NonFiniteError, match="rsvd input #0"):
            port.rsvd(a, 2, 2, 2)
        with pytest.raises(port.NonFiniteError, match="rpca"):
            port.rpca(torch.as_tensor(a), 2)
        port.rsvd(np.nan_to_num(a), 2, 2, 2)   # finite: no error
    finally:
        port.set_debug(False)
    assert not port.debug_enabled()
