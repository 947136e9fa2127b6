"""API drift guards for the port: the pyo3-parity surface keeps the exact
positional signatures of the reference (lib_math_utils_py.rs:17-283), as
tests/test_api_signatures.py holds the JAX package to them, and the drop-in
shim ``corrla_rs_torch`` carries the reference's twelve names."""
import inspect

import numpy as np
import pytest
import torch

import corrla_rs_tpu_torch as port

torch.set_num_threads(1)


def _positional_params(fn, n):
    params = list(inspect.signature(fn).parameters.values())
    return [p.name for p in params[:n]]


def test_rsvd_signature():
    assert _positional_params(port.rsvd, 4) == [
        "a_mat", "n_rank", "n_iters", "n_oversamples"
    ]


def test_rpca_signature():
    assert _positional_params(port.rpca, 4) == [
        "a_mat", "n_rank", "n_iters", "n_oversamples"
    ]


def test_active_ss_signature():
    assert _positional_params(port.active_ss, 5) == [
        "x", "y", "order", "n_nbr", "n_comps"
    ]


def test_cs_dirichlet_signature():
    assert _positional_params(port.cs_dirichlet_sample, 6) == [
        "bounds", "n_samples", "max_zshots", "chunk_size", "c_scale",
        "alphas",
    ]


def test_cs_mcmc_signature():
    assert _positional_params(port.cs_mcmc_dirichlet_sample, 9) == [
        "bounds", "n_samples", "n_seed_samples", "max_zshots", "chunk_size",
        "c_scale", "alphas", "gamma", "var_epsilon",
    ]


def test_class_constructor_signatures():
    assert _positional_params(port.PyRbfInterp.__init__, 5) == [
        "self", "kernel_type", "kernel_param", "dim", "poly_degree"
    ]
    assert _positional_params(port.PyPodI.__init__, 4) == [
        "self", "x_data", "t", "n_modes"
    ]
    assert _positional_params(port.PyDMDc.__init__, 5) == [
        "self", "x_data", "u_data", "n_modes", "n_iters"
    ]
    # binding parity: PyDMDc.predict is the multi-step rollout
    # (lib_math_utils_py.rs:273-282), DMDc.predict one step
    # (dmd_rom.rs:185-194)
    assert _positional_params(port.PyDMDc.predict, 3) == [
        "self", "x_0", "u_seq"
    ]
    assert _positional_params(port.DMDc.predict, 3) == [
        "self", "x_0", "u_input"
    ]


def test_shim_module():
    import corrla_rs
    import corrla_rs_torch

    names = [n for n in vars(corrla_rs) if not n.startswith("_")]
    assert len(names) == 12
    for name in names:
        assert getattr(corrla_rs_torch, name) is getattr(port, name), name
    assert corrla_rs_torch.PyPodI is port.PodI


def test_testing_helpers_take_tensors_and_arrays():
    from corrla_rs_tpu.utils import testing as jt
    from corrla_rs_tpu_torch.utils import testing as pt

    a = np.arange(6.0).reshape(2, 3)
    for helpers in (jt, pt):
        helpers.assert_mat_approx_eq(a, a + 1e-13)
        helpers.assert_mat_scale_approx_eq(a, 2.0 * a, 2.0)
        with pytest.raises(AssertionError):
            helpers.assert_mat_approx_eq(a, a + 1e-9)
        with pytest.raises(AssertionError, match="shape"):
            helpers.assert_mat_approx_eq(a, a[:1])
    pt.assert_mat_approx_eq(torch.as_tensor(a), a + 1e-13)
    pt.assert_mat_scale_approx_eq(torch.as_tensor(a), torch.as_tensor(3 * a),
                                  3.0)


def test_reversed_numpy_views_enter_the_port():
    # a numpy view with a negative stride (a reversed slice) is copied on
    # its way in; torch cannot wrap it
    from corrla_rs_tpu_torch.utils.device import as_tensor

    a = np.arange(12.0).reshape(3, 4)
    for view in (a[::-1], a[:, ::-2]):
        t = as_tensor(view, device="cpu")
        assert torch.equal(t, torch.tensor(view.copy()))
