"""The port's checkpoints: round trips through ``save_model`` /
``load_model``, files the JAX package saved loading into the port (and the
port's into the JAX package), the refusal of classes the port lacks, the
DREAM state, and ``utils.convert.from_jax_state`` for the classes of the
GP and ROM slice. Everything on the CPU in f64; the randomized fits draw
the JAX package's sketches (``same_sketch``) so both packages hold one
model.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import corrla_rs_tpu as crt
import corrla_rs_tpu_torch as port
from _torch_parity import cpu_device, same_sketch  # noqa: F401 (fixtures)
from corrla_rs_tpu.utils import checkpoint as jck
from corrla_rs_tpu_torch.utils import checkpoint as pck
from corrla_rs_tpu_torch.utils.convert import from_jax_state

torch.set_num_threads(1)


def _np(a):
    return a.detach().numpy() if isinstance(a, torch.Tensor) else \
        np.asarray(a)


def _gp_data():
    rng = np.random.default_rng(1)
    x = rng.uniform(-1, 1, (30, 2))
    y = np.sin(3 * x[:, 0]) + 0.1 * rng.standard_normal(30)
    return x, y, rng.uniform(-1, 1, (15, 2))


def _sig(n=300):
    t = np.arange(n, dtype=float)
    return np.sin(0.5 * t) + 0.3 * np.cos(1.3 * t)


def _field():
    s = np.linspace(0, 1, 16)
    t = np.arange(128, dtype=float)
    return (np.outer(np.sin(np.pi * s), np.cos(2 * np.pi * t / 64))
            + np.outer(np.cos(np.pi * s), np.sin(2 * np.pi * t / 64)))


def _lti(n_t=300):
    rng = np.random.default_rng(2)
    a = np.diag([0.9, 0.7, 0.5]) + 0.1 * np.triu(np.ones((3, 3)), 1)
    b = rng.standard_normal((3, 1))
    c = rng.standard_normal((2, 3))
    u = rng.standard_normal((1, n_t))
    x = np.zeros(3)
    ys, xs = [], [x]
    for k in range(n_t):
        ys.append(c @ x)
        x = a @ x + b @ u[:, k]
        xs.append(x)
    return u, np.stack(ys, 1), np.stack(xs, 1)


# (fit in JAX, fit in the port, predict) of each class of the slice; the
# prediction takes the model and the package (jnp or numpy inputs alike)
def _gp(pkg):
    x, y, _ = _gp_data()
    return pkg.GpRegressor("matern52", 0.5, 0.8, 1e-3).fit(
        x, y, optimize_hypers=False, pad_to=32)


def _sparse_gp(pkg):
    x, y, _ = _gp_data()
    return pkg.SparseGpRegressor(inducing=x[::3], length_scale=0.6,
                                 signal_var=0.9, noise_var=0.02).fit(
        x, y, optimize_hypers=False)


def _predict_gp(m):
    return m.predict(_gp_data()[2])


def _hankel(pkg):
    return pkg.HankelDmd(_sig(), n_delays=8, n_modes=4)


def _mrdmd(pkg):
    return pkg.mrdmd(_field(), n_modes=4, max_levels=2)


def _pidmd(family):
    def fit(pkg):
        x = _field()[:, :60]
        return pkg.PiDmd(x, 4 if family == "orthogonal" else 0,
                         family=family)
    return fit


def _era(pkg):
    u, y, _ = _lti()
    return pkg.era_okid(u, y, 3)


def _online(pkg):
    u, _, x = _lti(120)
    return pkg.OnlineDmd(3, 1).fit_stream(x, u, batch=16)


CASES = {
    "GpRegressor": (_gp, _predict_gp),
    "SparseGpRegressor": (_sparse_gp, _predict_gp),
    "HankelDmd": (_hankel, lambda m: m.forecast(12)),
    "MrDmd": (_mrdmd, lambda m: m.reconstruct()),
    "PiDmd-orthogonal": (_pidmd("orthogonal"),
                         lambda m: m.predict_multiple(_field()[:, 0], 9)),
    "PiDmd-circulant": (_pidmd("circulant"),
                        lambda m: m.predict_multiple(_field()[:, 0], 9)),
    "PiDmd-diagonal": (_pidmd("diagonal"),
                       lambda m: m.predict_multiple(_field()[:, 0], 9)),
    "Era": (_era, lambda m: m.predict(_lti(40)[0])),
    "OnlineDmd": (_online,
                  lambda m: m.predict(np.ones(3), np.ones((1, 7)))),
}


def _flat(out):
    parts = out if isinstance(out, tuple) else (out,)
    return np.concatenate([_np(p).ravel() for p in parts])


def _agree(got, want, tol=1e-10):
    got, want = _flat(got), _flat(want)
    scale = max(float(np.abs(want).max()), 1.0)
    np.testing.assert_allclose(got, want, rtol=0, atol=tol * scale)


@pytest.mark.parametrize("case", sorted(CASES))
def test_port_round_trip(same_sketch, tmp_path, case):
    fit, predict = CASES[case]
    model = fit(port)
    path = str(tmp_path / "m.npz")
    port.save_model(path, model)
    back = port.load_model(path, device="cpu")
    assert type(back) is type(model)
    np.testing.assert_array_equal(_flat(predict(back)),
                                  _flat(predict(model)))


@pytest.mark.parametrize("case", sorted(CASES))
def test_jax_saved_file_loads_into_the_port(same_sketch, tmp_path, case):
    fit, predict = CASES[case]
    model = fit(crt)
    path = str(tmp_path / "m.npz")
    jck.save_model(path, model)
    back = pck.load_model(path, device="cpu")
    assert type(back).__name__ == type(model).__name__
    assert type(back).__module__.startswith("corrla_rs_tpu_torch")
    _agree(predict(back), predict(model))


@pytest.mark.parametrize("case", sorted(CASES))
def test_from_jax_state_carries_the_fit(same_sketch, case):
    fit, predict = CASES[case]
    model = fit(crt)
    name = type(model).__name__
    back = from_jax_state(name, vars(model), device="cpu")
    _agree(predict(back), predict(model))
    with pytest.raises(ValueError, match="lacks"):
        state = dict(vars(model))
        state.pop(next(iter(
            k for k in ("x_ind", "x_train", "_h_last", "levels", "family",
                        "order", "_ab") if k in state)))
        from_jax_state(name, state, device="cpu")


@pytest.mark.parametrize("case", ["GpRegressor", "Era", "HankelDmd"])
def test_port_saved_file_loads_into_jax(same_sketch, tmp_path, case):
    fit, predict = CASES[case]
    model = fit(port)
    path = str(tmp_path / "m.npz")
    pck.save_model(path, model)
    back = jck.load_model(path)
    assert type(back).__module__.startswith("corrla_rs_tpu.")
    _agree(predict(back), predict(model))


def test_unported_and_unknown_classes_raise_value_errors(tmp_path):
    # every class the JAX package checkpoints has a port now: each name
    # resolves to the port's class of that name; an unknown one raises
    jck._builtin_registry()
    names = [n for n, cls in jck._REGISTRY.items()
             if cls.__module__.startswith("corrla_rs_tpu.")]
    assert len(names) >= 33
    for name in names:
        assert pck._model_class(name).__name__ == name
    path = str(tmp_path / "m.npz")
    np.savez(path, __class__=np.asarray("NoSuchModel"),
             __scalars__=np.asarray("{}"))
    with pytest.raises(ValueError, match="NoSuchModel"):
        pck.load_model(path, device="cpu")


def test_registered_class_round_trips(cpu_device, tmp_path):
    @pck.register_model_class
    class Tiny:
        pass

    t = Tiny()
    t.w = torch.arange(3.0)
    t.parts = [torch.ones(2), torch.zeros(1)]
    t.meta = {"a": 1}
    t.nested = [[1, 2], ["x"]]
    t.where = torch.device("cpu")
    path = str(tmp_path / "t.npz")
    pck.save_model(path, t)
    back = pck.load_model(path, device="cpu")
    assert isinstance(back, Tiny)
    assert torch.equal(back.w, t.w) and back.meta == {"a": 1}
    assert [p.tolist() for p in back.parts] == [[1.0, 1.0], [0.0]]
    assert back.nested == [[1, 2], ["x"]]
    t.gen = torch.Generator()
    with pytest.raises(TypeError, match="gen"):
        pck.save_model(path, t)


def _lnp(x):
    return -0.5 * torch.sum(x * x)


def test_dream_state_round_trip_resumes(cpu_device, tmp_path):
    heads = np.random.default_rng(3).standard_normal((12, 2))
    _, state = port.dream_run(heads, _lnp, 5, key=1)
    path = str(tmp_path / "d.npz")
    pck.save_dream_state(path, state)
    back = pck.load_dream_state(path, device="cpu")
    for f in ("heads", "head_lnp", "p_cr", "jump_dist", "n_id", "n_accept",
              "t"):
        assert torch.equal(getattr(back, f), getattr(state, f)), f
    # the generator resumes where it stopped
    assert torch.equal(torch.rand(4, generator=back.key),
                       torch.rand(4, generator=state.key))
    # a generator's state resumes only on the device type it came from
    with np.load(path) as data:
        fields = {k: data[k] for k in data.files}
    fields["key_device"] = np.asarray("cuda")
    np.savez(path, **fields)
    with pytest.raises(ValueError, match="cannot resume"):
        pck.load_dream_state(path, device="cpu")


def test_jax_saved_dream_state_loads_into_the_port(cpu_device, tmp_path):
    from corrla_rs_tpu.ops.dream import dream_run as jax_dream_run

    heads = np.random.default_rng(4).standard_normal((12, 2))
    _, state = jax_dream_run(jnp.asarray(heads),
                             lambda x: -0.5 * jnp.sum(x * x), 4, key=2)
    path = str(tmp_path / "d.npz")
    jck.save_dream_state(path, state)
    back = pck.load_dream_state(path, device="cpu")
    np.testing.assert_array_equal(_np(back.heads), np.asarray(state.heads))
    assert back.t.dtype == torch.int64 and int(back.t) == int(state.t)
    # the port resumes the run from the carried state
    hist, _ = port.dream_run(None, _lnp, 3, key=5, init_state=back)
    assert tuple(hist.shape) == (3, 12, 2)
