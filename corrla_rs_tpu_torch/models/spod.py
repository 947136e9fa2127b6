"""Spectral POD (SPOD).

Counterpart of ``corrla_rs_tpu/models/spod.py`` (Towne, Schmidt & Colonius
2018): the cross-spectral density is diagonalized at each frequency, giving
modes that are orthogonal at every frequency and energy-ranked there.

- Welch segmentation is one gather, (n_x, n_blocks, n_fft), windowed.
- The windowed real DFT is ``torch.fft.rfft`` over the blocks, in complex
  dtypes (complex64 for float32 data): the JAX package does the same DFT
  as two real GEMMs against cos/sin matrices and carries re/im parts apart,
  because its TPU had no complex dtypes. The FFT rounds differently from
  those GEMMs, so the two agree to the data's precision, not bit for bit.
- The per-frequency cross-spectral Grams M_f = Q_f^H Q_f / B are one
  batched complex GEMM on the device; their eigendecomposition is one
  batched complex ``eigh`` on the host over all frequencies (B x B each),
  as in the JAX package.
- The mode lift Phi_f = Q_f V_f Lambda_f^{-1/2} is one batched complex GEMM
  on the device; directions below eps * lambda_max(f) get zero columns.

- ``mesh=``: rows of x (space) shard across the mesh. The mean removal,
  the blocks, the DFT and the mode lift stay on each rank's rows; only the
  (B, B) cross-spectral Grams are psummed (one complex (n_freq, B, B)
  block). The modes come back as DTensors sharded along their spatial
  axis (``Shard(1)``), the energies replicated.
"""
from __future__ import annotations

import numpy as np
import torch

from corrla_rs_tpu_torch.utils.checkpoint import register_model_class
from corrla_rs_tpu_torch.utils.device import _host_f64, as_tensor

__all__ = ["Spod", "spod"]


@register_model_class
class Spod:
    """Fitted SPOD (see :func:`spod`).

    ``freqs`` (n_freq,) host array, rfft frequencies in cycles a time unit;
    ``energies`` (n_freq, n_save) tensor, the modal energy spectra
    (descending in j); ``modes_re``/``modes_im`` (n_freq, n_x, n_save)
    tensors, orthonormal within each frequency: Phi_f^H Phi_f = I.
    """

    @property
    def n_freq(self) -> int:
        return int(self.energies.shape[0])

    def mode(self, i_freq: int, j: int = 0):
        """(re, im) spatial shape of mode j at frequency bin i_freq."""
        return (self.modes_re[i_freq, :, j],
                self.modes_im[i_freq, :, j])

    def energy_interval(self, confidence: float = 0.95):
        """(lo, hi) multiplicative confidence bounds on ``energies`` as host
        arrays: lambda_hat / lambda follows chi2(2 n_blocks) / (2 n_blocks)
        (Schmidt & Colonius 2020, sec. IV)."""
        from scipy.stats import chi2

        if not 0.0 < confidence < 1.0:
            raise ValueError(
                f"confidence must be in (0, 1), got {confidence}"
            )
        a = 1.0 - float(confidence)
        dof = 2 * self.n_blocks
        lo = dof / chi2.ppf(1.0 - a / 2.0, dof)
        hi = dof / chi2.ppf(a / 2.0, dof)
        e = _host_f64(self.energies)
        return e * lo, e * hi

    def peak_frequencies(self, n_peaks: int = 1) -> np.ndarray:
        """Frequencies of the n_peaks largest leading-mode energies
        (excludes the DC bin)."""
        lead = _host_f64(self.energies[:, 0]).copy()
        lead[0] = -np.inf
        order = np.argsort(lead)[::-1][: int(n_peaks)]
        return np.asarray(self.freqs)[np.sort(order)]


def spod(x_data, n_fft: int = 128, overlap: float = 0.5,
         dt: float = 1.0, window: str = "hann",
         n_modes: int | None = None, weights=None, mesh=None,
         device=None) -> Spod:
    """Spectral POD of snapshot columns x_data (n_x, n_t).

    n_fft: Welch block length; overlap: fractional block overlap in [0, 1);
    dt: sample spacing; window: 'hann' or 'boxcar'; n_modes: modes kept a
    frequency (default all n_blocks); weights: optional (n_x,) positive
    spatial quadrature weights W (modes come back W-orthonormal); mesh: a
    DeviceMesh (``parallel.mesh.make_mesh``; every rank calls) over whose
    first axis the rows of x shard (a DTensor sharded so, or the full
    array every rank holds; the rows must divide the axis size). Energies
    are scaled like the one-sided Welch PSD. ``device`` is where numpy
    input goes.
    """
    psum, rows = (lambda t: t), None
    if mesh is not None:
        from corrla_rs_tpu_torch.parallel.mesh import _axis, _local, _psum, \
            _size

        axis = _axis(mesh, None)
        shape = tuple(x_data.shape)
        if len(shape) != 2:
            raise ValueError(f"x_data must be 2-d, got {len(shape)}-d")
        n_dev = _size(mesh, axis)
        if shape[0] % n_dev:
            raise ValueError(f"rows ({shape[0]}) must divide the mesh axis "
                             f"size ({n_dev})")
        x, _ = _local(x_data, mesh, axis, device=device)
        rows = (mesh, axis, shape[0] // n_dev * mesh.get_local_rank(axis))

        def psum(t):
            return _psum(t, mesh, axis)
    else:
        x = as_tensor(x_data, device=device)
        shape = tuple(x.shape)
    if len(shape) != 2:
        raise ValueError(f"x_data must be 2-d, got {len(shape)}-d")
    n_x, n_t = int(shape[0]), int(shape[1])
    n_fft = int(n_fft)
    if not 4 <= n_fft <= n_t:
        raise ValueError(
            f"n_fft must be in [4, n_t={n_t}], got {n_fft}"
        )
    if not 0.0 <= float(overlap) < 1.0:
        raise ValueError(f"overlap must be in [0, 1), got {overlap}")
    hop = max(1, int(round(n_fft * (1.0 - float(overlap)))))
    n_blocks = (n_t - n_fft) // hop + 1
    if n_blocks < 2:
        raise ValueError(
            f"need >= 2 Welch blocks (n_t={n_t}, n_fft={n_fft}, "
            f"hop={hop} gives {n_blocks}); shorten n_fft or raise overlap"
        )
    if window == "hann":
        w_np = 0.5 - 0.5 * np.cos(
            2.0 * np.pi * np.arange(n_fft) / n_fft
        )
    elif window == "boxcar":
        w_np = np.ones(n_fft)
    else:
        raise ValueError(
            f"window must be 'hann' or 'boxcar', got {window!r}"
        )
    # one-sided Welch scaling: per-block DFTs x sqrt(2 dt / (n_fft W))
    w_pow = float(np.sum(w_np ** 2))
    dt_ = x.dtype
    dev = x.device
    sqrt_w = None
    if weights is not None:
        w_arr = np.asarray(weights, np.float64).reshape(-1)
        if w_arr.shape[0] != n_x or np.any(w_arr <= 0):
            raise ValueError(
                f"weights must be (n_x={n_x},) positive, got "
                f"shape {w_arr.shape}"
            )
        sqrt_w = np.sqrt(w_arr)
        if rows is not None:
            sqrt_w = sqrt_w[rows[2]:rows[2] + x.shape[0]]
        x = x * torch.as_tensor(sqrt_w, dtype=dt_, device=dev)[:, None]
    x = x - x.mean(dim=1, keepdim=True)
    win = torch.as_tensor(w_np * np.sqrt(2.0 * float(dt) / w_pow),
                          dtype=dt_, device=dev)

    # Welch blocks (n_x, B, n_fft), windowed, and their rfft
    idx = (torch.arange(n_blocks, device=dev)[:, None] * hop
           + torch.arange(n_fft, device=dev)[None, :])
    spec = torch.fft.rfft(x[:, idx] * win, dim=-1)      # (n_x, B, n_freq)
    q = spec.permute(2, 0, 1).contiguous()              # (n_freq, n_x, B)
    del spec
    m = psum(q.mH @ q) / n_blocks                        # (n_freq, B, B)

    # host complex Hermitian eigendecomposition of the (B, B) Grams,
    # batched over frequencies: no eigenvector-pairing ambiguity
    w_all, v_all = np.linalg.eigh(m.cpu().numpy().astype(np.complex128))
    w_all = np.maximum(w_all[:, ::-1], 0.0)             # descending, >= 0
    v_all = v_all[:, :, ::-1]
    keep = n_blocks if n_modes is None else min(int(n_modes), n_blocks)
    w_all, v_all = w_all[:, :keep], v_all[:, :, :keep]
    # relative floor: directions below eps * lambda_max(f) carry no energy,
    # so their modes are zero instead of amplified roundoff
    tiny = np.finfo(np.float64).eps * np.maximum(
        w_all[:, :1], np.finfo(np.float64).tiny
    )
    good = w_all > tiny
    scale = np.where(good, 1.0 / np.sqrt(
        np.maximum(w_all, tiny) * n_blocks
    ), 0.0)
    v_scaled = torch.as_tensor(
        np.ascontiguousarray(v_all * scale[:, None, :]), dtype=q.dtype,
        device=dev)
    phi = q @ v_scaled                                   # (n_freq, n_x, k)
    del q
    if sqrt_w is not None:
        # back to physical units: modes W-orthonormal, not 2-orthonormal
        phi = phi * torch.as_tensor(1.0 / sqrt_w, dtype=dt_,
                                    device=dev)[None, :, None]
    # undo the one-sided doubling at DC (and Nyquist for even n_fft)
    fix = np.ones(n_fft // 2 + 1)
    fix[0] = 0.5
    if n_fft % 2 == 0:
        fix[-1] = 0.5
    out = Spod.__new__(Spod)
    out.n_state = n_x
    out.n_blocks = n_blocks
    out.n_fft = n_fft
    out.freqs = np.fft.rfftfreq(n_fft, d=float(dt))
    out.energies = torch.as_tensor(w_all * fix[:, None], dtype=dt_,
                                   device=dev)
    out.modes_re = phi.real.contiguous()
    out.modes_im = phi.imag.contiguous()
    if rows is not None:
        from corrla_rs_tpu_torch.parallel.mesh import _dtensor

        mesh, axis, _ = rows
        full = (phi.shape[0], n_x, phi.shape[2])
        out.modes_re = _dtensor(out.modes_re, mesh, axis, 1, full)
        out.modes_im = _dtensor(out.modes_im, mesh, axis, 1, full)
    return out
