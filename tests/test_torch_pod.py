"""Port parity: PodI against the JAX package, and fitted JAX state carried
into the port (utils.convert) for PodI, PcaRsvd and RbfInterp."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import corrla_rs_tpu as crt
import corrla_rs_tpu_torch as port
from _torch_parity import (  # noqa: F401 (fixtures)
    EPS,
    cpu_device,
    decaying,
    same_sketch,
    subspace_gap,
)
from corrla_rs_tpu.utils.checkpoint import save_model
from corrla_rs_tpu_torch.utils.convert import (
    from_jax_state,
    load_jax_checkpoint,
)

torch.set_num_threads(1)


def _family(n_snap, n_points, dtype):
    """Smooth one-parameter family f(s; t) = exp(-t s) + 0.3 sin(2 pi s t),
    rows = snapshots at t in [0, 1], and a few held-out t."""
    t = np.linspace(0.0, 1.0, n_snap)[:, None]
    s = np.linspace(0.0, 1.0, n_points)[None, :]

    def f(tt):
        return np.exp(-tt * s) + 0.3 * np.sin(2 * np.pi * s * tt)

    tq = (t[:-1] + t[1:])[::3] / 2.0
    return f(t).astype(dtype), t.astype(dtype), tq.astype(dtype), f(tq)


# (dtype, prediction rtol): f64 to rounding through the same sketch (LU of
# the cond ~1e3 linear-kernel saddle system); f32 on the always/cholesky
# path, mode subspace and predictions to ~1e-5 measured
@pytest.mark.parametrize("dtype,rtol", [(np.float64, 1e-9),
                                        (np.float32, 1e-4)])
def test_podi_matches_jax(same_sketch, dtype, rtol):
    x, t, tq, truth = _family(24, 150, dtype)
    pj = crt.PodI(x, t, 6, key=5)
    pt = port.PodI(x, t, 6, key=5)
    assert pt.modes.shape == (150, 6) and pt.mode_weights.shape == (24, 6)
    assert pt.n_snapshots == 24 and pt.n_modes == 6
    assert subspace_gap(pj.modes, pt.modes) <= 10 * rtol
    yj = np.asarray(pj.predict(tq))
    yt = pt.predict(tq).numpy()
    assert yt.shape == (150, len(tq)) and yt.dtype == dtype
    np.testing.assert_allclose(yt, yj, rtol=rtol,
                               atol=rtol * np.abs(yj).max())
    # and both interpolate the family: 6 modes of a smooth family plus
    # piecewise-linear interpolation in t with spacing 1/23
    assert np.abs(yt - truth.T).max() <= 1e-2


def test_podi_single_query_shapes(same_sketch):
    x, t, _, _ = _family(12, 40, np.float64)
    pt = port.PodI(x, t, 4, key=1)
    one = pt.predict(np.array([[0.25]]))
    assert one.shape == (40, 1)
    flat = pt.predict(np.array([0.25]))    # 1-D: one query point
    torch.testing.assert_close(flat, one, rtol=0, atol=0)
    with pytest.raises(ValueError, match="t rows"):
        port.PodI(x, t[:-1], 4)


def _fitted_jax_models(rng):
    x, t, tq, _ = _family(20, 60, np.float64)
    pod = crt.PodI(x, t, 5, key=3)
    data = decaying(rng, (50, 8), np.float64) + 1.0
    pca = crt.PcaRsvd(data, 3, key=2)
    xs = 2.0 * rng.random((25, 2))
    rbf = crt.RbfInterp(2, 0.9, 2, 1).fit(xs, np.sin(xs[:, 0]) * xs[:, 1])
    probes = {
        "PodI": (pod, lambda m: m.predict(tq)),
        "PcaRsvd": (pca, lambda m: m.apply_inv_tr(m.apply_tr(data[:9]))),
        "RbfInterp": (rbf, lambda m: m.predict(2.0 * np.ones((4, 2)) / 3)),
    }
    return probes


def _as_numpy_state(model):
    return {k: (np.asarray(v) if isinstance(v, jnp.ndarray) else v)
            for k, v in vars(model).items()}


@pytest.mark.parametrize("name", ["PodI", "PcaRsvd", "RbfInterp"])
def test_from_jax_state_predicts_what_jax_predicts(rng, name):
    model, probe = _fitted_jax_models(rng)[name]
    carried = from_jax_state(name, _as_numpy_state(model), device="cpu")
    assert type(carried).__name__ == name
    assert getattr(carried, "_mesh", None) is None
    want = np.asarray(probe(model))
    got = probe(carried)
    assert isinstance(got, torch.Tensor) and got.device.type == "cpu"
    # same state, same f64 arithmetic up to summation order
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-12,
                               atol=1e-12 * np.abs(want).max())


@pytest.mark.parametrize("name", ["PodI", "PcaRsvd", "RbfInterp"])
def test_load_jax_checkpoint_predicts_what_jax_predicts(rng, tmp_path, name):
    model, probe = _fitted_jax_models(rng)[name]
    path = tmp_path / f"{name}.npz"
    save_model(str(path), model)
    carried = load_jax_checkpoint(path, device="cpu")
    assert type(carried).__name__ == name
    want = np.asarray(probe(model))
    np.testing.assert_allclose(probe(carried).numpy(), want, rtol=1e-12,
                               atol=1e-12 * np.abs(want).max())


def test_from_jax_state_rejects_unknown(rng):
    with pytest.raises(ValueError, match="no port of 'NoSuchModel'"):
        from_jax_state("NoSuchModel", {}, device="cpu")
    with pytest.raises(ValueError, match="lacks"):
        from_jax_state("PodI", {"modes": np.zeros((3, 1))}, device="cpu")
