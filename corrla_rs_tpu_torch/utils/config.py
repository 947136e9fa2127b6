"""Frozen configuration dataclasses: the port's hyperparameter defaults.

Copies of the slice's dataclasses in ``corrla_rs_tpu/utils/config.py``, with
the same defaults. The port keeps its own copies because importing anything
under ``corrla_rs_tpu`` imports JAX.

- RSVD: 10 iterations, 10 oversamples
- PCA: 20 power iterations, min(n_dim, 10) oversamples (pca_rsvd.rs:65-66)
- POD: 10 iterations, 10 oversamples (pod_rom.rs:56)
"""
from __future__ import annotations

from dataclasses import dataclass

__all__ = ["RsvdConfig", "PcaConfig", "PodConfig"]


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
