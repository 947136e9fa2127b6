"""Dynamic Mode Decomposition with control (DMDc) and plain DMD.

Counterpart of ``corrla_rs_tpu/models/dmd.py`` (Proctor / Brunton / Kutz,
"Dynamic Mode Decomposition with Control"; parity with reference
dmd_rom.rs:20-225). DMDc represents x_{t+1} = A x_t + B u_t:

- Omega = vstack(X; U), input space Omega[:, :-1], output space X'
  (dmd_rom.rs:66,149-162);
- RSVD of both spaces with 12 oversamples (dmd_rom.rs:72,82), the two
  sketches drawn from two child generators of ``key`` (``_split_seed``);
- A~ from eq. 29, B~ from eq. 30 (dmd_rom.rs:90-106);
- complex eigendecomposition of the r x r A~ (dmd_rom.rs:112-125): on the
  host (``eig_backend="host"``, LAPACK) or on the tensor's device
  (``"device"``, ``torch.linalg.eig``, which synchronises on CUDA);
- DMD modes from eq. 36 kept as real/imag parts (dmd_rom.rs:128-146), and
  the factored dynamics W = diag(lambda) Phi^+ through a rank-cutoff
  complex pseudoinverse, so A = Phi_r W_r - Phi_i W_i;
- ``est_a_til`` builds the dense (n_x, n_x) A lazily (dmd_rom.rs:165-175).

The products of eq. 36 are reassociated so that no (n_x, n_x) intermediate
forms: the mode prefactor is (X' V) (S^+ U_1^T U^), not ((X' V S^+) U_1^T) U^.
Rollouts are loops over steps of a few matrix-vector products on the
device, with no synchronisation inside the loop. ``dmdc_fit_ensemble``
fits the members one after another and takes their eigendecompositions in
one batched call (``_dmdc_reduce`` also fits a member stack in one batched
pass, which the ensemble does not take: see its docstring);
``rollout_ensemble`` steps all members at once.

``DMDc(mesh=)`` shards the state axis over a 1-D ``DeviceMesh``, every rank
of the mesh making the same call (``_dmdc_reduce_sharded``). Both RSVDs are
``parallel.sharded_rsvd``'s; the n_u control rows of Omega are not on the
state axis, so they ride as a replicated tail whose share of every
reduction is added once, after the all-reduce, and U~_2 comes out
replicated. Each product that contracts over n_x is local plus an
all-reduce; B, the mode prefactor and U^ stay sharded along the states; A~
and its eigendecomposition are replicated. The factored dynamics W come
from a complex TSQR of the sharded modes (``_pinv_comp_sharded``), sharded
along their columns. The rollouts step on the local rows: the 'modes' and
'reduced' ones with one r-vector all-reduce a step, the dense one with an
all-gather of the state.
"""
from __future__ import annotations

import numpy as np
import torch

from corrla_rs_tpu_torch.ops.eig import eig, eig_host
from corrla_rs_tpu_torch.ops.mat_utils import pinv_comp_parts, pinv_diag
from corrla_rs_tpu_torch.ops.random_svd import _random_svd_members, \
    random_svd
from corrla_rs_tpu_torch.utils.config import DmdConfig
from corrla_rs_tpu_torch.utils.device import _is_dtensor, as_tensor
from corrla_rs_tpu_torch.utils.prng import split_seed

__all__ = ["DMDc", "DMD", "dmdc_fit_ensemble", "rollout_ensemble"]

# relative cutoff of the host backend's complex pinv (the JAX package's
# _pinv_complex_np): junk mode columns of an over-parameterized fit would be
# amplified by ~1e16 under the reference's additive eps (dmd_rom.rs parity
# stays available as ops.mat_utils.mat_pinv_comp(mode="reference"))
_HOST_PINV_RTOL = 1.0e-10

# The one place DMDc derives its RSVD seeds: child generators of a seed or
# generator. The parity tests replace it to hand the JAX package's split
# keys to ops.random_svd._draw_sketch.
_split_seed = split_seed


def _check_backend(eig_backend: str) -> None:
    if eig_backend not in ("host", "device"):
        raise ValueError(
            f"eig_backend must be 'host' or 'device', got {eig_backend!r}"
        )


def _check_shape(name: str, t: torch.Tensor, rows: int, cols=None) -> None:
    if t.ndim != 2 or t.shape[0] != rows or cols not in (None, t.shape[1]):
        want = f"({rows}, {'n' if cols is None else cols})"
        raise ValueError(f"{name} must be {want}, got {tuple(t.shape)}")


def _inv_sigma(s):
    """``pinv_diag``'s cutoff on the singular values (..., r) themselves:
    |s| < 1e-20 maps to 0, else to 1 / (s + 1e-20)."""
    return torch.where(s.abs() < 1.0e-20, torch.zeros_like(s),
                       1.0 / (s + 1.0e-20))


def _dmdc_reduce(x, u, n_modes, n_iters, n_oversamples, key):
    """Stage 1: both RSVDs and the reduced operators (eqs. 29-30).

    x (n_x, n_t) and u (n_u, n_t) with one ``key``, or member stacks
    (B, n_x, n_t) and (B, n_u, n_t) with a sequence of B keys: then every
    member is fitted in one batched pass (``random_svd._random_svd_members``),
    member b seeded by ``keys[b]`` as a lone fit with that key, and equal to
    it up to rounding, which only a member with fewer supported modes than
    ``n_modes`` amplifies (see ``dmdc_fit_ensemble``).

    Returns (a_til (..., r, r), b_op (..., n_x, n_u), tmp_modes_scale
    (..., n_x, r), u_hat (..., n_x, r)).
    """
    n_x, n_u = x.shape[-2], u.shape[-2]
    omega = torch.cat([x, u], dim=-2)
    x_in = omega[..., :-1]            # input space (state + control)
    y_out = x[..., 1:]                # output space (state only)
    if x.ndim == 3:
        k1, k2 = zip(*(_split_seed(k, 2, x.device) for k in key))
        svd = _random_svd_members
    else:
        k1, k2 = _split_seed(key, 2, x.device)
        svd = random_svd
    u_til, s_til, vt_til = svd(x_in, n_modes, n_iters, n_oversamples, k1)
    v_til = vt_til.mT
    u_til_1 = u_til[..., :n_x, :]
    u_til_2 = u_til[..., n_x:n_x + n_u, :]
    u_hat, _s, _vt = svd(y_out, n_modes, n_iters, n_oversamples, k2)
    # S~^+ (pinv_diag of diag(s_til)) applied as a column / row scale
    s_til_inv = _inv_sigma(s_til)
    y_v = y_out @ v_til                                    # (n_x, r)
    # eq. 29 (dmd_rom.rs:90-97)
    tmp_op_scale = (u_hat.mT @ y_v) * s_til_inv[..., None, :]
    u1t_uhat = u_til_1.mT @ u_hat                          # (r, r)
    a_til = tmp_op_scale @ u1t_uhat
    # eq. 30 (dmd_rom.rs:100-106)
    b_op = u_hat @ (tmp_op_scale @ u_til_2.mT)
    # eq. 36 mode prefactor (dmd_rom.rs:134-139)
    tmp_modes_scale = y_v @ (s_til_inv[..., :, None] * u1t_uhat)
    return a_til, b_op, tmp_modes_scale, u_hat


def _dmdc_reduce_sharded(x_l, u, n_modes, n_iters, n_oversamples, key,
                         mesh, axis):
    """Stage 1 on the mesh: ``x_l`` is this rank's rows of the states, ``u``
    the controls every rank holds. The control rows of Omega ride as the
    sharded RSVD's replicated tail. Returns (a_til (r, r) replicated, this
    rank's rows of b_op, tmp_modes_scale and u_hat)."""
    from corrla_rs_tpu_torch.parallel.mesh import _psum
    from corrla_rs_tpu_torch.parallel.sharded_rsvd import _sharded_svd

    m = x_l.shape[1] - 1
    y_l = x_l[:, 1:]                  # output space (state only)
    k1, k2 = _split_seed(key, 2, x_l.device)
    u_til_1, u_til_2, s_til, vt_til = _sharded_svd(
        x_l[:, :-1], u[:, :-1], m, n_modes, n_iters, n_oversamples, k1,
        "auto", mesh, axis)
    u_hat, _, _, _ = _sharded_svd(y_l, None, m, n_modes, n_iters,
                                  n_oversamples, k2, "auto", mesh, axis)
    s_til_inv = pinv_diag(torch.diag(s_til))
    y_v = y_l @ vt_til.mT                                  # (n_l, r)
    # eqs. 29, 30 and 36 as in _dmdc_reduce, contracting over n_x by an
    # all-reduce
    tmp_op_scale = _psum(u_hat.mT @ y_v, mesh, axis) @ s_til_inv
    u1t_uhat = _psum(u_til_1.mT @ u_hat, mesh, axis)
    a_til = tmp_op_scale @ u1t_uhat
    b_op = u_hat @ (tmp_op_scale @ u_til_2.mT)
    tmp_modes_scale = y_v @ (s_til_inv @ u1t_uhat)
    return a_til, b_op, tmp_modes_scale, u_hat


def _pinv_comp_sharded(x_re, x_im, rtol, mesh, axis):
    """``pinv_comp_parts`` of the row-sharded (n, r) Phi = x_re + i x_im:
    this rank's columns (r, n_l) of its rank-cutoff pseudoinverse.

    A complex TSQR, Phi = Q R (local QR, all-gather of the R factors as
    real pairs, replicated QR of their stack), then the SVD of the r x r R,
    whose singular values are Phi's: pinv(Phi) = V S^+ (Q U)^H."""
    from corrla_rs_tpu_torch.parallel.mesh import _all_gather, _coord

    if rtol is None:
        rtol = 1.0e-10 if x_re.dtype == torch.float64 else 1.0e-5
    q_l, r_l = torch.linalg.qr(torch.complex(x_re, x_im), mode="reduced")
    r_all = torch.view_as_complex(
        _all_gather(torch.view_as_real(r_l.contiguous()), mesh, axis))
    q_r, r = torch.linalg.qr(r_all, mode="reduced")
    kk = r_l.shape[0]
    idx = _coord(mesh, axis)
    q_l = q_l @ q_r[idx * kk:(idx + 1) * kk]
    u, s, vh = torch.linalg.svd(r, full_matrices=False)
    s_inv = torch.where(s > rtol * s[:1], 1.0 / s.clamp_min(1e-300),
                        torch.zeros_like(s))
    p = (vh.mH * s_inv[None, :].to(vh.dtype)) @ (q_l @ u).mH
    return p.real.contiguous(), p.imag.contiguous()


def _factored(lam_re, lam_im, modes_re, modes_im, rtol=None, pinv=None):
    """W = diag(lambda) Phi^+ as (w_re, w_im), leading dims batch.
    ``pinv(re, im, rtol)`` defaults to ``pinv_comp_parts``."""
    p_re, p_im = (pinv or pinv_comp_parts)(modes_re, modes_im, rtol)
    w_re = lam_re[..., :, None] * p_re - lam_im[..., :, None] * p_im
    w_im = lam_re[..., :, None] * p_im + lam_im[..., :, None] * p_re
    return w_re, w_im


def _spectrum(a_til, eig_backend):
    """(lambdas as host complex numpy, lam_re, lam_im, v_re, v_im) with the
    parts as tensors of a_til's dtype and device."""
    if eig_backend == "device":
        lam, v = eig(a_til)
        lam_np = lam.cpu().numpy()
    else:
        lam_np, v_np = eig_host(a_til)
        lam = torch.as_tensor(lam_np, device=a_til.device)
        v = torch.as_tensor(v_np, device=a_til.device)
    dt = a_til.dtype
    return (lam_np, lam.real.to(dt), lam.imag.to(dt), v.real.to(dt),
            v.imag.to(dt))


def _roll(step, x0: torch.Tensor, n_steps: int) -> torch.Tensor:
    """Apply ``step(x, j)`` n_steps times from x0 (..., n_x, 1); returns
    (..., n_x, n_steps), column j the state after step j."""
    out = x0.new_empty((n_steps,) + x0.shape[:-1])
    x = x0
    for j in range(n_steps):
        x = step(x, j)
        out[j] = x[..., 0]
    return out.movedim(0, -1)


def _controls(b_op, u_seq):
    """B u_t for every column t, step-major: (n_times, ..., n_x, 1)."""
    return (b_op @ u_seq).movedim(-1, 0).contiguous()[..., None]


def _rollout_dense(a_op, b_op, x0, u_seq):
    bu = _controls(b_op, u_seq)
    return _roll(lambda x, j: a_op @ x + bu[j], x0, u_seq.shape[-1])


def _rollout_factored(phi_re, phi_im, w_re, w_im, b_op, x0, u_seq):
    """A x = Phi_r (W_r x) - Phi_i (W_i x) as one product pair, O(n_x r)."""
    phi = torch.cat([phi_re, -phi_im], dim=-1)
    w = torch.cat([w_re, w_im], dim=-2)
    bu = _controls(b_op, u_seq)
    return _roll(lambda x, j: phi @ (w @ x) + bu[j], x0, u_seq.shape[-1])


def _rollout_reduced(u_hat, a_til, b_op, x0, u_seq):
    """Eig-free rollout in the POD basis: U^ (A~ (U^T x)) + B u."""
    bu = _controls(b_op, u_seq)
    u_hat_t = u_hat.mT
    return _roll(lambda x, j: u_hat @ (a_til @ (u_hat_t @ x)) + bu[j], x0,
                 u_seq.shape[-1])


class DMDc:
    """DMD with control. Constructor mirrors PyDMDc
    (lib_math_utils_py.rs:262-271): ``DMDc(x_data, u_data, n_modes,
    n_iters)`` with dt fixed at 1.0 like the binding.

    x_data: (n_x, n_t) snapshot columns; u_data: (n_u, n_t) control
    columns, taken to x's device and dtype. ``key`` is an int seed or a
    ``torch.Generator``; ``device`` is where numpy ``x_data`` goes (default
    ``utils.device.default_device()``).

    eig_backend: 'host' (LAPACK on the host for the tiny r x r
    eigensolve, between the two device stages) or 'device'
    (``torch.linalg.eig`` on the data's device). ``lambdas`` is a host
    numpy complex array in both.

    ``mesh=`` (a 1-D ``DeviceMesh``): every rank of the mesh makes the same
    call with x_data a DTensor sharded along the states, or the full
    snapshots, and the full controls. The state dimension must divide the
    mesh size. ``modes_re/modes_im``, ``est_b_til()``, ``est_a_til()`` and
    every prediction are then DTensors sharded along the states; a state
    passed to ``predict``/``predict_multiple`` may be one too.
    """

    def __init__(self, x_data, u_data, n_modes: int, n_iters: int,
                 dt: float | None = None, key=0, mesh=None,
                 config: DmdConfig | None = None, eig_backend: str = "host",
                 device=None):
        cfg = config or DmdConfig()
        _check_backend(eig_backend)
        if mesh is not None:
            from corrla_rs_tpu_torch.parallel.mesh import _axis

            axis = _axis(mesh, None)
            x, u = self._sharded_inputs(x_data, u_data, mesh, axis)
            self.n_x = x_data.shape[0]
        else:
            x = as_tensor(x_data, device=device)
            u = as_tensor(u_data, device=x.device, dtype=x.dtype)
            self.n_x = x.shape[0]
        self.n_snapshots = x.shape[1]
        self.n_u = u.shape[0]
        self.n_modes = int(n_modes)
        self.dt_snapshots = float(dt if dt is not None else cfg.dt)
        args = (self.n_modes, int(n_iters), int(cfg.n_oversamples), key)
        if mesh is None:
            self._A, self._B, tmp_modes_scale, self._u_hat = _dmdc_reduce(
                x, u, *args)
        else:
            self._A, b_op, tmp_modes_scale, u_hat = _dmdc_reduce_sharded(
                x, u, *args, mesh, axis)
        self.lambdas, lam_re, lam_im, v_re, v_im = _spectrum(self._A,
                                                             eig_backend)
        self.modes_re = tmp_modes_scale @ v_re
        self.modes_im = tmp_modes_scale @ v_im
        self._a_full = None
        rtol = None if eig_backend == "device" else _HOST_PINV_RTOL
        if mesh is None:
            self._w_re, self._w_im = _factored(lam_re, lam_im, self.modes_re,
                                               self.modes_im, rtol)
            return
        w_re, w_im = _factored(
            lam_re, lam_im, self.modes_re, self.modes_im, rtol,
            lambda re, im, tol: _pinv_comp_sharded(re, im, tol, mesh, axis))
        from corrla_rs_tpu_torch.parallel.mesh import _dtensor

        rows = (self.n_x, self.n_modes)
        self._B = _dtensor(b_op, mesh, axis, 0, (self.n_x, self.n_u))
        self._u_hat = _dtensor(u_hat, mesh, axis, 0, rows)
        self.modes_re = _dtensor(self.modes_re, mesh, axis, 0, rows)
        self.modes_im = _dtensor(self.modes_im, mesh, axis, 0, rows)
        self._w_re = _dtensor(w_re, mesh, axis, 1, rows[::-1])
        self._w_im = _dtensor(w_im, mesh, axis, 1, rows[::-1])

    @staticmethod
    def _sharded_inputs(x_data, u_data, mesh, axis):
        """(this rank's rows of x, the full u) on the mesh's device."""
        from corrla_rs_tpu_torch.parallel.mesh import _local, _size

        n_dev = _size(mesh, axis)
        n_x, n_t = x_data.shape
        if n_x % n_dev != 0:
            raise ValueError(
                f"DMDc mesh= requires the state dimension ({n_x}) to divide "
                f"the mesh size ({n_dev}); pad the snapshots or drop mesh= "
                "(silently falling back to one device would hide a large "
                "performance cliff)"
            )
        x_l, _ = _local(x_data, mesh, axis)
        u = as_tensor(u_data, device=x_l.device, dtype=x_l.dtype)
        if n_x + u.shape[0] < n_t - 1:
            raise ValueError(
                f"DMDc mesh= shards the states, which must be the long axis: "
                f"{n_x} states and {u.shape[0]} controls against "
                f"{n_t - 1} snapshot pairs; drop mesh= for a short state")
        return x_l, u

    def _sharding(self):
        """(mesh, axis) of a fit made with mesh=, else None."""
        if not _is_dtensor(self._B):
            return None
        from corrla_rs_tpu_torch.parallel.mesh import _placement

        mesh, axis, _ = _placement(self._B)
        return mesh, axis

    def est_a_til(self) -> torch.Tensor:
        """Full-state A = Phi_r W_r - Phi_i W_i (dmd_rom.rs:165-175), built
        once on first use: O(n_x^2) memory (with mesh=, this rank's rows,
        from an all-gather of W)."""
        if self._a_full is None:
            sharded = self._sharding()
            if sharded is None:
                self._a_full = (self.modes_re @ self._w_re
                                - self.modes_im @ self._w_im)
            else:
                from corrla_rs_tpu_torch.parallel.mesh import _all_gather, \
                    _dtensor

                mesh, axis = sharded
                w_re, w_im = (_all_gather(w.to_local().mT, mesh, axis).mT
                              for w in (self._w_re, self._w_im))
                a_l = (self.modes_re.to_local() @ w_re
                       - self.modes_im.to_local() @ w_im)
                self._a_full = _dtensor(a_l, mesh, axis, 0,
                                        (self.n_x, self.n_x))
        return self._a_full

    def est_b_til(self) -> torch.Tensor:
        """Full-state B operator. dmd_rom.rs:178-180."""
        return self._B

    def _input(self, v) -> torch.Tensor:
        b = self._B.to_local() if _is_dtensor(self._B) else self._B
        return as_tensor(v, device=b.device, dtype=b.dtype)

    def predict(self, x_0, u_input) -> torch.Tensor:
        """One step: A x_0 + B u. Parity with dmd_rom.rs:185-194."""
        sharded = self._sharding()
        if sharded is not None:
            return self._predict_sharded(x_0, u_input, *sharded)
        x0, u = self._input(x_0), self._input(u_input)
        _check_shape("x_0", x0, self.n_x, 1)
        _check_shape("u_input", u, self.n_u, 1)
        return self.est_a_til() @ x0 + self._B @ u

    def _predict_sharded(self, x_0, u_input, mesh, axis):
        from corrla_rs_tpu_torch.parallel.mesh import _dtensor, _full

        x0 = self._input(_full(x_0))
        u = self._input(u_input)
        _check_shape("x_0", x0, self.n_x, 1)
        _check_shape("u_input", u, self.n_u, 1)
        y_l = self.est_a_til().to_local() @ x0 + self._B.to_local() @ u
        return _dtensor(y_l, mesh, axis, 0, (self.n_x, 1))

    def predict_multiple(self, x_0, u_seq, method: str = "dense"):
        """Roll the dynamics over the columns of u_seq. dmd_rom.rs:199-225.

        Returns (n_x, n_times); column j is the state after stepping with
        u_seq[:, j]. method='modes' applies A in factored form (O(n_x r) a
        step, no dense A); method='reduced' rolls in the POD basis
        U^ A~ U^T and needs no eigendecomposition.
        """
        sharded = self._sharding()
        if sharded is not None:
            return self._predict_multiple_sharded(x_0, u_seq, method,
                                                  *sharded)
        x0, u = self._input(x_0), self._input(u_seq)
        _check_shape("x_0", x0, self.n_x, 1)
        _check_shape("u_seq", u, self.n_u)
        if method == "modes":
            return _rollout_factored(self.modes_re, self.modes_im,
                                     self._w_re, self._w_im, self._B, x0, u)
        if method == "reduced":
            return _rollout_reduced(self._u_hat, self._A, self._B, x0, u)
        return _rollout_dense(self.est_a_til(), self._B, x0, u)

    def _predict_multiple_sharded(self, x_0, u_seq, method, mesh, axis):
        """The rollouts on this rank's rows: one r-vector all-reduce a step
        ('modes', 'reduced'), or an all-gather of the state (dense)."""
        from corrla_rs_tpu_torch.parallel.mesh import _all_gather, \
            _dtensor, _local, _psum

        _check_shape("x_0", x_0, self.n_x, 1)
        b_op = self._B.to_local()
        x0, _ = _local(x_0, mesh, axis, device=b_op.device,
                       dtype=b_op.dtype)
        u = self._input(u_seq)
        _check_shape("u_seq", u, self.n_u)
        bu = _controls(b_op, u)
        if method == "modes":
            phi = torch.cat([self.modes_re.to_local(),
                             -self.modes_im.to_local()], dim=-1)
            w = torch.cat([self._w_re.to_local(), self._w_im.to_local()],
                          dim=-2)

            def step(x, j):
                return phi @ _psum(w @ x, mesh, axis) + bu[j]
        elif method == "reduced":
            u_hat, a_til = self._u_hat.to_local(), self._A

            def step(x, j):
                return u_hat @ (a_til @ _psum(u_hat.mT @ x, mesh, axis)) \
                    + bu[j]
        else:
            a_l = self.est_a_til().to_local()

            def step(x, j):
                return a_l @ _all_gather(x, mesh, axis) + bu[j]
        out = _roll(step, x0, u.shape[-1])
        return _dtensor(out, mesh, axis, 0, (self.n_x, u.shape[-1]))


def dmdc_fit_ensemble(x_batch, u_batch, n_modes: int, n_iters: int, key=0,
                      config: DmdConfig | None = None, device=None):
    """DMDc fits over an ensemble of snapshot families (EXTENSION).

    x_batch: (B, n_x, n_t); u_batch: (B, n_u, n_t). Member b's RSVD seeds
    are the children of the b-th child of ``key``, as the JAX package splits
    its keys, and its reduction is ``DMDc``'s with that child, so member b is
    ``DMDc`` fitted alone with it, up to the eig backend. The members are
    reduced one after another; their eigendecompositions run as one batched
    ``torch.linalg.eig`` on the device, and the factored dynamics use the
    dtype-aware cutoff of ``pinv_comp_parts``.

    The JAX package fits the members as one ``jit(vmap)`` program. The port
    has that batched pass (``_dmdc_reduce`` on the member stack, 3-19x
    faster than the loop on an H100) but does not take it: where a member
    has fewer supported modes than ``n_modes`` in f32, its trailing
    eigenvalues are set by rounding, and only the lone fit's own arithmetic
    reproduces them (ROADMAP, "Differences by design").

    Returns a dict of batched tensors: ``lambdas_re/lambdas_im`` (B, r),
    ``modes_re/modes_im`` (B, n_x, r), ``a_til`` (B, r, r), ``b_op``
    (B, n_x, n_u), ``u_hat`` (B, n_x, r), ``w_re/w_im`` (B, r, n_x), ready
    for ``rollout_ensemble``.

    ``x_batch`` a DTensor sharded along the members (``Shard(0)`` on a 1-D
    mesh; every rank calls): each rank fits its own members, member b
    still seeded by the b-th child of ``key``, with no collective; the
    batched ``eig`` runs over the rank's members. ``u_batch`` is then a
    DTensor sharded alike or the full batch every rank holds, and every
    tensor of the fit comes back a DTensor with ``Shard(0)``.
    """
    cfg = config or DmdConfig()
    sh = _ensemble_members(x_batch)
    if sh is not None:
        x_batch = sh.local
        u_batch = _member_rows(u_batch, sh, x_batch)
    else:
        x_batch = as_tensor(x_batch, device=device)
        u_batch = as_tensor(u_batch, device=x_batch.device,
                            dtype=x_batch.dtype)
    if x_batch.ndim != 3 or u_batch.ndim != 3:
        raise ValueError(
            f"expected (B, n_x, n_t) and (B, n_u, n_t) batches, got "
            f"{tuple(x_batch.shape)} and {tuple(u_batch.shape)}"
        )
    keys = _split_seed(key, x_batch.shape[0] if sh is None else sh.n,
                       x_batch.device)
    if sh is not None:
        keys = keys[sh.rows]
    parts = [_dmdc_reduce(x, u, int(n_modes), int(n_iters),
                          int(cfg.n_oversamples), k)
             for x, u, k in zip(x_batch, u_batch, keys)]
    a_til, b_op, tmp_modes_scale, u_hat = (torch.stack(p) for p in
                                           zip(*parts))
    lam, v = torch.linalg.eig(a_til)
    dt = a_til.dtype
    lam_re, lam_im = lam.real.to(dt), lam.imag.to(dt)
    modes_re = tmp_modes_scale @ v.real.to(dt)
    modes_im = tmp_modes_scale @ v.imag.to(dt)
    w_re, w_im = _factored(lam_re, lam_im, modes_re, modes_im)
    fit = dict(lambdas_re=lam_re, lambdas_im=lam_im, modes_re=modes_re,
               modes_im=modes_im, a_til=a_til, b_op=b_op, u_hat=u_hat,
               w_re=w_re, w_im=w_im)
    return fit if sh is None else {k: sh.dtensor(v) for k, v in fit.items()}


def _ensemble_members(x):
    """The ``parallel.mesh._Members`` of a batch given as a DTensor sharded
    along the members (any other placement raises), else None."""
    if not _is_dtensor(x):
        return None
    from corrla_rs_tpu_torch.parallel.mesh import _Members, rows_of_dtensor

    _, _, mesh, axis = rows_of_dtensor(x)
    return _Members(x, mesh, axis, "the ensemble size")


def _member_rows(a, sh, like):
    """This rank's members of ``a``: a DTensor sharded like the ensemble,
    or the full batch every rank holds."""
    from corrla_rs_tpu_torch.parallel.mesh import _local

    if int(a.shape[0]) != sh.n:
        raise ValueError(f"expected {sh.n} members, got {tuple(a.shape)}")
    return _local(a, sh.mesh, sh.axis, device=like.device,
                  dtype=like.dtype)[0]


def rollout_ensemble(fit, x0_batch, u_seq, method: str = "reduced"):
    """Roll every ensemble member forward, all members in each step.

    fit: output of ``dmdc_fit_ensemble``; x0_batch: (B, n_x, 1); u_seq:
    (n_u, n_times) shared controls or (B, n_u, n_times) per member.
    method: 'reduced' (POD-basis rollout) or 'modes' (factored
    eigendynamics). Returns (B, n_x, n_times).

    A fit whose tensors are DTensors sharded along the members (a
    member-sharded ``dmdc_fit_ensemble``) rolls each rank's members on
    that rank: ``x0_batch`` and per-member controls are DTensors sharded
    alike or full batches, and the result is a DTensor with ``Shard(0)``.
    """
    if method not in ("reduced", "modes"):
        raise ValueError(
            f"method must be 'reduced' or 'modes', got {method!r}")
    sh = _ensemble_members(fit["b_op"])
    if sh is not None:
        fit = {k: v.to_local() for k, v in fit.items()}
    b_op = fit["b_op"]
    if sh is None:
        x0 = as_tensor(x0_batch, device=b_op.device, dtype=b_op.dtype)
    else:
        x0 = _member_rows(x0_batch, sh, b_op)
    u = (u_seq if sh is None or len(u_seq.shape) == 2
         else _member_rows(u_seq, sh, b_op))
    u = as_tensor(u, device=b_op.device, dtype=b_op.dtype)
    if u.ndim == 2:
        u = u.expand((x0.shape[0],) + u.shape)
    if method == "reduced":
        out = _rollout_reduced(fit["u_hat"], fit["a_til"], b_op, x0, u)
    else:
        out = _rollout_factored(fit["modes_re"], fit["modes_im"],
                                fit["w_re"], fit["w_im"], b_op, x0, u)
    return out if sh is None else sh.dtensor(out)


# ---------------------------------------------------------------------------
# Plain (uncontrolled) DMD: EXTENSION, no reference analogue
# ---------------------------------------------------------------------------

def _dmd_reduce_exact(x, n_modes, n_iters, n_oversamples, key,
                      rank_rtol=0.0):
    """Exact DMD stage 1 (Tu et al. 2014): rank-r RSVD of X1, A~ = U^T X2 V
    S^{-1}, and the exact-mode prefactor X2 V S^{-1}. rank_rtol=0 keeps the
    reference's eps-pinv of S; rank_rtol > 0 zeroes directions with
    s < rank_rtol * s_max (they surface as lambda ~= 0 modes)."""
    x1, x2 = x[:, :-1], x[:, 1:]
    u_r, s_r, vt_r = random_svd(x1, n_modes, n_iters, n_oversamples, key=key)
    if rank_rtol > 0.0:
        inv = torch.where(s_r > rank_rtol * s_r[0],
                          1.0 / s_r.clamp_min(1e-300), torch.zeros_like(s_r))
        s_inv = torch.diag(inv)
    else:
        s_inv = pinv_diag(torch.diag(s_r))
    proj = (x2 @ vt_r.mT) @ s_inv
    return u_r.mT @ proj, proj, u_r


def _pod_project(x, n_modes, n_iters, n_oversamples, key):
    u_pod, _, _ = random_svd(x, n_modes, n_iters, n_oversamples, key=key)
    return u_pod, u_pod.mT @ x[:, :-1], u_pod.mT @ x[:, 1:]


def _dmd_reduce_tls(x, n_modes, n_iters, n_oversamples, key):
    """Total-least-squares DMD stage 1 (Hemati et al. 2017): the leading r
    left singular directions U_z = [U11; U21] of the stacked projected
    snapshots [X1r; X2r], from one eigh of their (2r, 2r) Gram;
    A~ = U21 U11^{-1}."""
    u_pod, x1r, x2r = _pod_project(x, n_modes, n_iters, n_oversamples, key)
    z = torch.cat([x1r, x2r], dim=0)
    _, evecs = torch.linalg.eigh(z @ z.mT)                 # ascending
    uz = evecs.flip(-1)[:, :n_modes]
    u11, u21 = uz[:n_modes], uz[n_modes:]
    a_til = torch.linalg.solve(u11.mT, u21.mT).mT
    return a_til, u_pod, u_pod


def _sqrtm_db(a: torch.Tensor, n_steps: int = 30) -> torch.Tensor:
    """Principal matrix square root by the Denman-Beavers iteration:
    Y <- (Y + Z^{-1})/2, Z <- (Z + Y^{-1})/2 from Y0=A, Z0=I."""
    y, z = a, torch.eye(a.shape[0], dtype=a.dtype, device=a.device)
    for _ in range(n_steps):
        y, z = 0.5 * (y + torch.linalg.inv(z)), 0.5 * (z + torch.linalg.inv(y))
    return y


def _dmd_reduce_fb(x, n_modes, n_iters, n_oversamples, key):
    """Forward-backward DMD stage 1 (Dawson et al. 2016): the geometric
    mean A = (A_f A_b^{-1})^{1/2} of the forward and backward operators in
    one shared POD basis, through the real Denman-Beavers root."""
    u_pod, x1r, x2r = _pod_project(x, n_modes, n_iters, n_oversamples, key)
    g11, g22, g21 = x1r @ x1r.mT, x2r @ x2r.mT, x2r @ x1r.mT
    a_f = torch.linalg.solve(g11.mT, g21.mT).mT
    a_b = torch.linalg.solve(g22.mT, g21).mT
    a_sq = torch.linalg.solve(a_b.mT, a_f.mT).mT
    return _sqrtm_db(a_sq), u_pod, u_pod


class DMD:
    """Exact Dynamic Mode Decomposition (no control input), EXTENSION.

    x_data: (n_x, n_t) snapshot columns of x_{t+1} ~= A x_t. Rank-r fit via
    the randomized SVD; ``key`` is an int seed or a ``torch.Generator``.

    eig_backend: 'host' (LAPACK) or 'device' (``torch.linalg.eig``).
    rank_rtol (solver='exact' only): 0 = reference eps-pinv semantics;
    > 0 truncates singular values below rank_rtol * s_max.
    solver: 'exact' (ordinary LS, exact modes), 'tls' (total least
    squares) or 'fb' (forward-backward); 'tls'/'fb' return projected modes
    Phi = U_pod W.

    Attributes after fit: ``lambdas`` and ``amplitudes`` (b = Phi^+ x_0) as
    host numpy complex arrays, ``modes_re``/``modes_im`` (n_x, r).
    """

    def __init__(self, x_data, n_modes: int, n_iters: int = 10, key=0,
                 eig_backend: str = "host", solver: str = "exact",
                 config: DmdConfig | None = None, rank_rtol: float = 0.0,
                 device=None):
        cfg = config or DmdConfig()
        _check_backend(eig_backend)
        if solver not in ("exact", "tls", "fb"):
            raise ValueError(
                f"solver must be 'exact', 'tls' or 'fb', got {solver!r}"
            )
        if rank_rtol and solver != "exact":
            raise ValueError(
                "rank_rtol is only meaningful for solver='exact' (tls/fb "
                "regularize through their POD projection instead)"
            )
        x = as_tensor(x_data, device=device)
        self.n_x, self.n_t = x.shape
        self.n_modes = int(n_modes)
        self.solver = solver
        args = (x, self.n_modes, int(n_iters), int(cfg.n_oversamples), key)
        if solver == "exact":
            a_til, proj, u_r = _dmd_reduce_exact(*args,
                                                 rank_rtol=float(rank_rtol))
        else:
            reduce = {"tls": _dmd_reduce_tls, "fb": _dmd_reduce_fb}[solver]
            a_til, proj, u_r = reduce(*args)
        self._A = a_til
        self._u_r = u_r
        self.lambdas, lam_re, lam_im, v_re, v_im = _spectrum(a_til,
                                                             eig_backend)
        self.modes_re = proj @ v_re
        self.modes_im = proj @ v_im
        rtol = None if eig_backend == "device" else _HOST_PINV_RTOL
        p_re, p_im = pinv_comp_parts(self.modes_re, self.modes_im, rtol)
        self._w_re = lam_re[:, None] * p_re - lam_im[:, None] * p_im
        self._w_im = lam_re[:, None] * p_im + lam_im[:, None] * p_re
        p = torch.complex(p_re, p_im)
        self.amplitudes = (p @ x[:, 0:1].to(p.dtype))[:, 0].cpu().numpy()

    def eigs_continuous(self, dt: float = 1.0) -> np.ndarray:
        """Continuous-time eigenvalues log(lambda)/dt: real part = growth
        rate, imaginary part = angular frequency."""
        return np.log(self.lambdas.astype(np.complex128)) / float(dt)

    def predict_multiple(self, x_0, n_steps: int,
                         method: str = "modes") -> torch.Tensor:
        """Roll x <- A x for ``n_steps`` from x_0 (n_x, 1); returns
        (n_x, n_steps), column j = state after j+1 steps. method='modes'
        (factored A, O(n_x r) a step) or 'reduced' (U_r A~ U_r^T)."""
        x0 = as_tensor(x_0, device=self._A.device, dtype=self._A.dtype)
        _check_shape("x_0", x0, self.n_x, 1)
        n_steps = int(n_steps)
        if method == "reduced":
            u_t = self._u_r.mT
            return _roll(lambda x, j: self._u_r @ (self._A @ (u_t @ x)), x0,
                         n_steps)
        if method != "modes":
            raise ValueError(
                f"method must be 'modes' or 'reduced', got {method!r}"
            )
        phi = torch.cat([self.modes_re, -self.modes_im], dim=1)
        w = torch.cat([self._w_re, self._w_im], dim=0)
        return _roll(lambda x, j: phi @ (w @ x), x0, n_steps)

    def reconstruct(self, n_steps: int | None = None) -> torch.Tensor:
        """Best-fit reconstruction of the training trajectory from the
        fitted spectrum: columns 1..n_steps regenerated from snapshot 0
        (host complex arithmetic, returned on the modes' device)."""
        n = self.n_t - 1 if n_steps is None else int(n_steps)
        phi = (self.modes_re.cpu().numpy()
               + 1j * self.modes_im.cpu().numpy())
        ks = np.arange(1, n + 1)
        lam_pow = self.lambdas[None, :] ** ks[:, None]      # (n, r)
        states = (lam_pow * self.amplitudes[None, :]) @ phi.T
        return torch.as_tensor(np.real(states).T.copy(),
                               device=self.modes_re.device)
