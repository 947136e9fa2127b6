"""Hankel (time-delay) DMD.

Counterpart of ``corrla_rs_tpu/models/hankel_dmd.py``: d consecutive
snapshots stacked into one column (a block-Hankel matrix) make the embedded
system linear of full dynamic rank (Takens; Brunton et al. 2017, Arbabi &
Mezic 2017), even from one sensor channel. The Hankel matrix is one gather
(``x[:, idx]`` with a (d, m_h) index grid) and a reshape, and everything
downstream is the port's exact DMD: ``HankelDmd`` subclasses
:class:`~corrla_rs_tpu_torch.models.dmd.DMD`.
"""
from __future__ import annotations

import torch

from corrla_rs_tpu_torch.models.dmd import DMD
from corrla_rs_tpu_torch.utils.checkpoint import register_model_class
from corrla_rs_tpu_torch.utils.config import DmdConfig
from corrla_rs_tpu_torch.utils.device import as_tensor

__all__ = ["HankelDmd", "hankel_embed"]


def hankel_embed(x_data, n_delays: int, device=None) -> torch.Tensor:
    """Block-Hankel time-delay embedding of snapshot columns.

    x_data: (n_x, n_t). Returns (n_x * n_delays, n_t - n_delays + 1) whose
    column j stacks x[:, j], x[:, j+1], ..., x[:, j+d-1]: the newest
    snapshot is the bottom block.
    """
    x = as_tensor(x_data, device=device)
    n_x, n_t = x.shape
    m_h = n_t - n_delays + 1
    if n_delays < 1:
        raise ValueError(f"n_delays must be >= 1, got {n_delays}")
    if m_h < 1:
        raise ValueError(
            f"n_delays={n_delays} leaves no embedded columns (n_t={n_t})"
        )
    idx = (torch.arange(m_h, device=x.device)[None, :]
           + torch.arange(n_delays, device=x.device)[:, None])
    h = x[:, idx]                                  # (n_x, d, m_h)
    return h.permute(1, 0, 2).reshape(n_delays * n_x, m_h)


@register_model_class
class HankelDmd(DMD):
    """Exact DMD on a time-delay (block-Hankel) embedding.

    x_data: (n_x, n_t) snapshots; n_delays: embedding depth d; n_modes /
    n_iters / key / eig_backend / solver / config: forwarded to
    :class:`DMD` on the embedded matrix; ``device`` is where numpy input
    goes.

    After fit, ``lambdas`` / ``eigs_continuous(dt)`` are the spectrum of the
    underlying dynamics, and ``modes_re``/``modes_im`` live in the embedded
    space; ``state_modes()`` returns their newest-time block.
    ``forecast(n)`` continues the training series; ``forecast(n,
    x_hist=...)`` continues any d-deep history.
    """

    def __init__(self, x_data, n_delays: int, n_modes: int,
                 n_iters: int = 10, key=0, eig_backend: str = "host",
                 solver: str = "exact", config: DmdConfig | None = None,
                 device=None):
        x = as_tensor(x_data, device=device)
        if x.ndim == 1:
            x = x[None, :]
        if x.ndim != 2:
            raise ValueError(f"x_data must be 1-d or 2-d, got {x.ndim}-d")
        d = int(n_delays)
        if d < 1:
            raise ValueError(f"n_delays must be >= 1, got {n_delays}")
        if x.shape[1] - d + 1 < 2:
            raise ValueError(
                f"need n_t - n_delays + 1 >= 2 embedded columns, got "
                f"n_t={x.shape[1]}, n_delays={d}"
            )
        self.n_delays = d
        self.n_state = int(x.shape[0])
        h = hankel_embed(x, d)
        self._h_last = h[:, -1:]
        super().__init__(h, n_modes, n_iters=n_iters, key=key,
                         eig_backend=eig_backend, solver=solver,
                         config=config)

    def state_modes(self):
        """(n_x, r) real/imag mode shapes on the raw state: the
        newest-time block of the embedded modes."""
        return (self.modes_re[-self.n_state:, :],
                self.modes_im[-self.n_state:, :])

    def _embed_tail(self, x_hist) -> torch.Tensor:
        xh = as_tensor(x_hist, device=self._A.device, dtype=self._A.dtype)
        if xh.ndim == 1:
            xh = xh[None, :]
        if xh.shape[0] != self.n_state or xh.shape[1] < self.n_delays:
            raise ValueError(
                f"x_hist must be ({self.n_state}, >= {self.n_delays}), "
                f"got {tuple(xh.shape)}"
            )
        # (n_x, d) tail -> (d, n_x) -> flat: delay-major like hankel_embed
        return xh[:, -self.n_delays:].mT.reshape(-1, 1)

    def forecast(self, n_steps: int, x_hist=None,
                 method: str = "modes") -> torch.Tensor:
        """Roll the embedded system ``n_steps`` forward and read off the
        newest-time block: (n_x, n_steps) future raw states.

        x_hist: optional (n_x, >= n_delays) history whose last d columns
        seed the embedded state (default: the end of the training data).
        method: 'modes' or 'reduced', as in :meth:`DMD.predict_multiple`.
        """
        h0 = self._h_last if x_hist is None else self._embed_tail(x_hist)
        hs = self.predict_multiple(h0, int(n_steps), method=method)
        return hs[-self.n_state:, :]
