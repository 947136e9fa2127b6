"""Frozen configuration dataclasses: the port's hyperparameter defaults.

Copies of the slice's dataclasses in ``corrla_rs_tpu/utils/config.py``, with
the same defaults. The port keeps its own copies because importing anything
under ``corrla_rs_tpu`` imports JAX.

- RSVD: 10 iterations, 10 oversamples
- PCA: 20 power iterations, min(n_dim, 10) oversamples (pca_rsvd.rs:65-66)
- POD: 10 iterations, 10 oversamples (pod_rom.rs:56)
- DMDc: 12 oversamples (dmd_rom.rs:72,82)
- active-subspace fit_svd: 8 iterations, 10 oversamples
  (active_subspaces.rs:243)
- rejection sampler chunking (space_samplers.rs:98, benchmark defaults)
- DEMC: gamma 0.8, jitter width 1e-12
- DREAM: up to 3 chain pairs, 3 crossover values, unit-gamma jumps at
  probability 0.2, noise widths 0.05 and 1e-6, no adaptation by default
"""
from __future__ import annotations

from dataclasses import dataclass

__all__ = ["RsvdConfig", "PcaConfig", "PodConfig", "DmdConfig",
           "ActiveSsConfig", "DirichletSamplerConfig", "DemcConfig",
           "DreamConfig"]


@dataclass(frozen=True)
class RsvdConfig:
    n_iter: int = 10
    n_oversamples: int = 10
    # 'auto' resolves per-dtype: 'always' for f32, 'reference' for f64
    # (see ops.random_svd.power_iter)
    stabilize: str = "auto"
    qr_method: str = "auto"   # 'householder' (safest) / 'cholesky' (fast)


@dataclass(frozen=True)
class PcaConfig:
    n_iter: int = 20
    max_oversamples: int = 10
    stabilize: str = "auto"


@dataclass(frozen=True)
class PodConfig:
    n_iter: int = 10
    n_oversamples: int = 10


@dataclass(frozen=True)
class DmdConfig:
    n_oversamples: int = 12
    dt: float = 1.0


@dataclass(frozen=True)
class ActiveSsConfig:
    n_iter: int = 8
    n_oversamples: int = 10


@dataclass(frozen=True)
class DirichletSamplerConfig:
    max_zshots: int = 500
    chunk_size: int = 20000
    c_scale: float = 1.0


@dataclass(frozen=True)
class DemcConfig:
    gamma: float = 0.8
    var_epsilon: float = 1e-12


@dataclass(frozen=True)
class DreamConfig:
    delta_max: int = 3
    n_cr: int = 3
    gamma_jump_prob: float = 0.2
    b: float = 0.05
    b_star: float = 1e-6
    n_adapt: int = 0
