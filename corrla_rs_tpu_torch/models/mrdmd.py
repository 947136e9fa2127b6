"""Multi-resolution DMD (mrDMD).

Counterpart of ``corrla_rs_tpu/models/mrdmd.py`` (Kutz, Fu & Brunton 2016):
at each level fit DMD on the window, keep only the modes slow enough to be
coherent across it (|log lambda| below ~max_cycles oscillations per
window), subtract their reconstruction, split the residual in half and
recurse. Slow global structure lands at level 0, faster and more localised
events at deeper levels.

Each node's fit is the port's :class:`DMD` (randomized SVD on the device);
the spectral bookkeeping (r x m coefficient tables, slow-mode masks) is
small host complex algebra, and a window's reconstruction returns to the
device as two real (n_x, r) x (r, m) products. The recursion over windows
is a host recursion of device calls (at most 2^levels nodes).
"""
from __future__ import annotations

import numpy as np
import torch

from corrla_rs_tpu_torch.models.dmd import DMD
from corrla_rs_tpu_torch.utils.checkpoint import register_model_class
from corrla_rs_tpu_torch.utils.config import DmdConfig
from corrla_rs_tpu_torch.utils.device import _host_f64 as _host
from corrla_rs_tpu_torch.utils.device import as_tensor

__all__ = ["MrDmd", "mrdmd"]


def _slow_reconstruction(node_modes_re, node_modes_im, lam, b, m):
    """Device reconstruction of a node over its window: two real products
    with a host-computed (r, m) complex coefficient table."""
    k = np.arange(m)
    coef = (lam[:, None] ** k[None, :]) * b[:, None]       # (r, m) complex
    like = dict(dtype=node_modes_re.dtype, device=node_modes_re.device)
    c_re = torch.as_tensor(np.ascontiguousarray(coef.real), **like)
    c_im = torch.as_tensor(np.ascontiguousarray(coef.imag), **like)
    return node_modes_re @ c_re - node_modes_im @ c_im


@register_model_class
class MrDmd:
    """Fitted multi-resolution DMD (see :func:`mrdmd`).

    Parallel per-node lists (node i):
    ``levels[i]``/``t0s[i]``/``t1s[i]``: level and window [t0, t1);
    ``modes_re[i]``/``modes_im[i]``: (n_x, r_i) slow-mode shapes;
    ``lam_re[i]``/``lam_im[i]``: r_i eigenvalues of the window's one-step
    operator; ``amp_re[i]``/``amp_im[i]``: spectral amplitudes at the window
    start (float64 tensors on the modes' device).
    ``reconstruct(levels=...)`` rebuilds the trajectory from any subset of
    levels; ``node_frequencies(dt)`` gives |Im log lambda| / dt.
    """

    def _node(self, i):
        lam = _host(self.lam_re[i]) + 1j * _host(self.lam_im[i])
        b = _host(self.amp_re[i]) + 1j * _host(self.amp_im[i])
        return lam, b

    def reconstruct(self, levels=None) -> torch.Tensor:
        """(n_x, n_t) sum of node reconstructions over their windows.
        levels: iterable of level indices to include (default: all)."""
        keep = None if levels is None else set(int(l) for l in levels)
        if self.modes_re:
            out = self.modes_re[0].new_zeros((self.n_x, self.n_t))
        else:
            out = torch.zeros((self.n_x, self.n_t))
        for i in range(len(self.levels)):
            if keep is not None and self.levels[i] not in keep:
                continue
            lam, b = self._node(i)
            m = self.t1s[i] - self.t0s[i]
            out[:, self.t0s[i]:self.t1s[i]] += _slow_reconstruction(
                self.modes_re[i], self.modes_im[i], lam, b, m)
        return out

    def node_frequencies(self, dt: float = 1.0):
        """List of per-node |angular frequency| arrays (rad / time unit):
        |Im log lambda| / dt."""
        out = []
        for i in range(len(self.levels)):
            lam, _ = self._node(i)
            lam = np.where(np.abs(lam) < 1e-300, 1e-300, lam)
            out.append(np.abs(np.imag(np.log(lam))) / float(dt))
        return out

    @property
    def n_nodes(self) -> int:
        return len(self.levels)


def mrdmd(x_data, n_modes: int, max_levels: int = 3,
          max_cycles: float = 1.0, n_iters: int = 10, key=0,
          rank_rtol: float | None = None,
          config: DmdConfig | None = None, device=None) -> MrDmd:
    """Multi-resolution DMD of snapshot columns.

    x_data: (n_x, n_t); n_modes: rank of each node's DMD fit (clamped to
    the window); max_levels: recursion depth (level l has 2^l windows);
    max_cycles: a mode is kept at a node when |log lambda| * m_window
    <= 2 pi * max_cycles; n_iters / key / config: forwarded to each node's
    :class:`DMD` fit; ``device`` is where numpy input goes.

    rank_rtol: relative singular-value cutoff for the node fits (default
    1e-9 for f64 inputs, 1e-5 for f32). Residual windows are generically
    rank-deficient (the slow content was just subtracted), so the
    truncating pinv is essential here.
    """
    x = as_tensor(x_data, device=device)
    if x.ndim != 2:
        raise ValueError(f"x_data must be 2-d, got {x.ndim}-d")
    if int(max_levels) < 1:
        raise ValueError(f"max_levels must be >= 1, got {max_levels}")
    if float(max_cycles) <= 0:
        raise ValueError(f"max_cycles must be > 0, got {max_cycles}")
    if int(n_modes) < 1:
        raise ValueError(f"n_modes must be >= 1, got {n_modes}")
    cfg = config or DmdConfig()
    if rank_rtol is None:
        rank_rtol = 1e-5 if x.dtype == torch.float32 else 1e-9

    out = MrDmd.__new__(MrDmd)
    out.n_x, out.n_t = int(x.shape[0]), int(x.shape[1])
    out.max_levels = int(max_levels)
    out.max_cycles = float(max_cycles)
    out.levels, out.t0s, out.t1s = [], [], []
    out.modes_re, out.modes_im = [], []
    out.lam_re, out.lam_im = [], []
    out.amp_re, out.amp_im = [], []

    def f64(a):
        return torch.as_tensor(np.ascontiguousarray(a), dtype=torch.float64,
                               device=x.device)

    def visit(xw, level, t0):
        m = int(xw.shape[1])
        r = min(int(n_modes), m - 1, out.n_x)
        if r >= 1:
            n_os = max(0, min(int(cfg.n_oversamples),
                              min(out.n_x, m - 1) - r))
            fit = DMD(xw, r, n_iters=int(n_iters), key=key,
                      rank_rtol=float(rank_rtol),
                      config=DmdConfig(n_oversamples=n_os, dt=cfg.dt))
            lam = fit.lambdas
            # coherent across the window: at most ~max_cycles
            # oscillations / e-foldings over its m steps
            safe = np.where(np.abs(lam) < 1e-300, 1e-300, lam)
            slow = np.abs(np.log(safe)) * m <= 2 * np.pi * float(max_cycles)
            if np.any(slow):
                keep = torch.as_tensor(np.flatnonzero(slow),
                                       device=x.device)
                lam_s = lam[slow]
                b_s = fit.amplitudes[slow]
                out.levels.append(int(level))
                out.t0s.append(int(t0))
                out.t1s.append(int(t0 + m))
                out.modes_re.append(fit.modes_re[:, keep].to(xw.dtype))
                out.modes_im.append(fit.modes_im[:, keep].to(xw.dtype))
                out.lam_re.append(f64(lam_s.real))
                out.lam_im.append(f64(lam_s.imag))
                out.amp_re.append(f64(b_s.real))
                out.amp_im.append(f64(b_s.imag))
                xw = xw - _slow_reconstruction(
                    out.modes_re[-1], out.modes_im[-1], lam_s, b_s, m
                )
        if level + 1 < int(max_levels) and m >= 4:
            half = m // 2
            visit(xw[:, :half], level + 1, t0)
            visit(xw[:, half:], level + 1, t0 + half)

    visit(x, 0, 0)
    return out
