"""Drop-in compatibility shim for the PyTorch/CUDA port:
``import corrla_rs_torch as corrla_rs`` works unchanged.

Users of the reference pyo3 module (reference lib_math_utils_py.rs:17-176)
keep their calls; every name resolves to the implementation in
corrla_rs_tpu_torch, whose entry points run on the CUDA device unless a
``device`` is given.
"""
from corrla_rs_tpu_torch import (  # noqa: F401
    DMDc,
    PcaRsvd,
    PodI,
    PyDMDc,
    PyPodI,
    PyRbfInterp,
    RbfInterp,
    active_ss,
    cs_dirichlet_sample,
    cs_mcmc_dirichlet_sample,
    rpca,
    rsvd,
)
