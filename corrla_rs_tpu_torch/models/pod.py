"""POD with mode-weight interpolation (PodI).

Counterpart of ``corrla_rs_tpu/models/pod.py`` (reference
pod_rom.rs:20-119): modes from the RSVD of the snapshot matrix with 10 power
iterations / 10 oversamples (pod_rom.rs:56), optimal per-snapshot weights
via pinv(modes) in one batched product (pod_rom.rs:61-75), one
linear-kernel RBF fit of all mode weights over the exogenous variable t
(pod_rom.rs:78-95), prediction y(t) = modes @ w(t) (pod_rom.rs:107-118).
The RBF fit and predict run through the port's CUDA kernels on the GPU, and
so does the field y(t): ``ops.rbf_kernels.modes_product`` (the operator
``corrla::modes_product``; ``torch.matmul`` past 32 modes, the plain
``modes @ w.mT`` on the CPU), inside the span ``corrla.pod.modes``.

``mesh=`` (a 1-D ``DeviceMesh``) shards the points axis, every rank of the
mesh making the same call: the modes are the sharded RSVD of x^T (points
are the tall axis), the weights are the all-reduced product of x's local
columns with the local modes (orthonormal modes: pinv(modes) = modes^T),
and the RBF fit of the replicated weights runs on every rank. ``modes`` and
``predict``'s result are DTensors sharded along the points.

Snapshot layout matches the reference: rows = snapshots.
"""
from __future__ import annotations

import torch

from corrla_rs_tpu_torch.ops.interp import rbf_fit, rbf_predict
from corrla_rs_tpu_torch.ops.mat_utils import pinv
from corrla_rs_tpu_torch.ops.random_svd import random_svd
from corrla_rs_tpu_torch.ops.rbf_kernels import modes_product
from corrla_rs_tpu_torch.utils.config import PodConfig
from corrla_rs_tpu_torch.utils.device import _is_dtensor, as_tensor
from corrla_rs_tpu_torch.utils.tracing import annotate

__all__ = ["PodI"]


class PodI:
    """POD + interpolation ROM. Constructor mirrors PyPodI
    (lib_math_utils_py.rs:231-240): ``PodI(x_data, t, n_modes)``.

    ``key`` is an int seed or a ``torch.Generator``. ``device`` is where a
    numpy ``x_data`` goes (default: ``utils.device.default_device()``); t is
    moved to the snapshots' device and dtype. With ``mesh=``, ``x_data`` is
    a DTensor sharded along its columns (the points) or the full matrix on
    every rank.
    """

    def __init__(self, x_data, t, n_modes: int, key=0, mesh=None,
                 config: PodConfig | None = None, device=None):
        cfg = config or PodConfig()
        self._n_iter = int(cfg.n_iter)
        self._n_oversamples = int(cfg.n_oversamples)
        self._device = device
        self._mesh = mesh
        self.fit(x_data, t, n_modes, key=key)

    def fit(self, x_data, t, n_modes: int, key=0):
        """(Re)fit, parity with pod_rom.rs:98-101."""
        if self._mesh is not None:
            return self._fit_sharded(x_data, t, n_modes, key)
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

    def _fit_sharded(self, x_data, t, n_modes: int, key):
        from corrla_rs_tpu_torch.parallel.mesh import _axis, _dtensor, \
            _local, _psum, _size
        from corrla_rs_tpu_torch.parallel.sharded_rsvd import _check_tall, \
            _sharded_svd

        mesh = self._mesh
        axis = _axis(mesh, None)
        n_snap, n_pts = x_data.shape
        _check_tall(n_pts, n_snap, _size(mesh, axis))
        x_l, _ = _local(x_data, mesh, axis, dim=1)     # (n_snap, n_pts_l)
        t = as_tensor(t, device=x_l.device, dtype=x_l.dtype)
        if t.shape[0] != n_snap:
            raise ValueError("t rows must match snapshot rows")
        self.n_snapshots = n_snap
        self.n_modes = int(n_modes)
        self.t_abscissa = t
        # modes = left singular vectors of x^T, sharded over the points
        modes_l, _ut, _s, _vt = _sharded_svd(
            x_l.mT, None, n_snap, self.n_modes, self._n_iter,
            self._n_oversamples, key, "always", mesh, axis)
        self.modes = _dtensor(modes_l, mesh, axis, 0,
                              (n_pts, modes_l.shape[1]))
        self.mode_weights = _psum(x_l @ modes_l, mesh, axis)
        self._rbf_coeffs = rbf_fit(t, self.mode_weights, "linear", 1.0, 1)
        return self

    def predict(self, t_query) -> torch.Tensor:
        """y(t) = sum_i w_i(t) phi_i. Parity with pod_rom.rs:107-118.

        Accepts (n_query, t_dim); returns (n_points, n_query). A 1-D input is
        one query point of dimension len(t_query).
        """
        modes = (self.modes.to_local() if _is_dtensor(self.modes)
                 else self.modes)
        tq = torch.atleast_2d(as_tensor(t_query, device=modes.device,
                                        dtype=modes.dtype))
        w = rbf_predict(self.t_abscissa, self._rbf_coeffs, tq, "linear",
                        1.0, 1)
        if _is_dtensor(self.modes):
            from corrla_rs_tpu_torch.parallel.mesh import _dtensor, _placement

            mesh, axis, _ = _placement(self.modes)
            with annotate("corrla.pod.modes"):
                y_l = modes_product(modes, w)
            return _dtensor(y_l, mesh, axis, 0,
                            (self.modes.shape[0], y_l.shape[1]))
        with annotate("corrla.pod.modes"):
            return modes_product(modes, w)
