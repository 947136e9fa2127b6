"""POD with mode-weight interpolation (PodI).

Counterpart of ``corrla_rs_tpu/models/pod.py`` (reference
pod_rom.rs:20-119): modes from the RSVD of the snapshot matrix with 10 power
iterations / 10 oversamples (pod_rom.rs:56), optimal per-snapshot weights
via pinv(modes) in one batched product (pod_rom.rs:61-75), one
linear-kernel RBF fit of all mode weights over the exogenous variable t
(pod_rom.rs:78-95), prediction y(t) = modes @ w(t) (pod_rom.rs:107-118).
The RBF fit and predict run through the port's CUDA kernels on the GPU.
The ``mesh=`` path is not ported yet.

Snapshot layout matches the reference: rows = snapshots.
"""
from __future__ import annotations

import torch

from corrla_rs_tpu_torch.ops.interp import rbf_fit, rbf_predict
from corrla_rs_tpu_torch.ops.mat_utils import pinv
from corrla_rs_tpu_torch.ops.random_svd import random_svd
from corrla_rs_tpu_torch.utils.config import PodConfig
from corrla_rs_tpu_torch.utils.device import as_tensor

__all__ = ["PodI"]


class PodI:
    """POD + interpolation ROM. Constructor mirrors PyPodI
    (lib_math_utils_py.rs:231-240): ``PodI(x_data, t, n_modes)``.

    ``key`` is an int seed or a ``torch.Generator``. ``device`` is where a
    numpy ``x_data`` goes (default: ``utils.device.default_device()``); t is
    moved to the snapshots' device and dtype.
    """

    def __init__(self, x_data, t, n_modes: int, key=0,
                 config: PodConfig | None = None, device=None):
        cfg = config or PodConfig()
        self._n_iter = int(cfg.n_iter)
        self._n_oversamples = int(cfg.n_oversamples)
        self._device = device
        self.fit(x_data, t, n_modes, key=key)

    def fit(self, x_data, t, n_modes: int, key=0):
        """(Re)fit, parity with pod_rom.rs:98-101."""
        x = as_tensor(x_data, device=self._device)
        t = as_tensor(t, device=x.device, dtype=x.dtype)
        if t.shape[0] != x.shape[0]:
            raise ValueError("t rows must match snapshot rows")
        self.n_snapshots = x.shape[0]
        self.n_modes = int(n_modes)
        self.t_abscissa = t
        # modes = V of the snapshot RSVD -> (n_points, n_modes)
        _u, _s, vt = random_svd(x, self.n_modes, self._n_iter,
                                self._n_oversamples, key=key)
        self.modes = vt.mT
        # optimal weights for every snapshot in one product
        self.mode_weights = x @ pinv(self.modes).mT   # (n_snap, n_modes)
        # linear-kernel, poly-degree-1 RBF over t for every mode at once
        self._rbf_coeffs = rbf_fit(t, self.mode_weights, "linear", 1.0, 1)
        return self

    def predict(self, t_query) -> torch.Tensor:
        """y(t) = sum_i w_i(t) phi_i. Parity with pod_rom.rs:107-118.

        Accepts (n_query, t_dim); returns (n_points, n_query). A 1-D input is
        one query point of dimension len(t_query).
        """
        tq = torch.atleast_2d(as_tensor(t_query, device=self.modes.device,
                                        dtype=self.modes.dtype))
        w = rbf_predict(self.t_abscissa, self._rbf_coeffs, tq, "linear",
                        1.0, 1)
        return self.modes @ w.mT
