"""Sequential Monte Carlo filtering (bootstrap particle filter) and the
unscented Kalman filter.

Counterpart of ``corrla_rs_tpu/ops/particle.py`` (no reference analogue; it
completes the state-estimation family: ``ops/kalman`` is linear-Gaussian,
``ops/enkf`` the ensemble one, here the sigma-point and the fully
non-Gaussian ones).

Why both: the UKF is the cheap deterministic option while the posterior
stays near-Gaussian (2n+1 sigma points, no sampling noise, exact on linear
systems); the particle filter is the asymptotically exact option for
multimodal and heavy-tailed posteriors and returns an UNBIASED estimate of
the marginal likelihood p(y_{1:T}) (Del Moral 2004), the model-evidence
number that turns a state-space model into something to compare and
calibrate (particle MCMC uses exactly this).

Both filters are one host loop over the record that reads nothing from the
device. The particle step is a propagation of the whole cloud, a weight
logsumexp and systematic resampling as a ``searchsorted`` gather; the
resampling is computed every step and SELECTED by the adaptive-ESS predicate
with ``torch.where``, so no step branches on the data. The UKF step is a
Cholesky and three small products on the sigma-point batch.

**The contract of ``propagate`` differs from the JAX package's.** There,
``propagate(key, x)`` gets one JAX key and one particle under ``vmap``.
torch cannot hand a generator through ``vmap``, so here ``propagate(gen,
x)`` is called once a step with the run's ``torch.Generator`` and the whole
(N, n) cloud, and returns the propagated (N, n) cloud, drawing its process
noise from ``gen`` on the cloud's device. ``loglik_obs(x, y)`` stays per
particle and is batched with ``torch.func.vmap``.

On a mesh (``mesh=``) the cloud is sharded along the particles and every
rank makes the same call. ``propagate`` gets the rank's (N/W, n) rows and
a generator of the rank's own: coordinate 0 the run's generator, so that
a world of one is the single-device run, and coordinate c > 0
``prng.fold_seed`` of it with c, taken after the resampling offsets are
drawn, so those stay the same on every rank (a difference by design:
JAX's per-particle keys do not depend on the mesh). The likelihoods run on
the rank's rows; the (N,) log-weights are all-gathered once a step, so the
evidence, the ESS and the resampling indices come from the whole vector
as on one device; the filtered mean all-reduces an (n,) vector. The
resample moves only the distinct ancestor rows that change rank
(``parallel.mesh._take_rows``), never the (N, n) cloud.
"""
from __future__ import annotations

import math

import torch

from corrla_rs_tpu_torch.ops.kalman import _cov, _ndim
from corrla_rs_tpu_torch.ops.smc import _systematic_resample
from corrla_rs_tpu_torch.utils.device import as_tensor
from corrla_rs_tpu_torch.utils.prng import as_generator, fold_seed

__all__ = ["particle_filter", "ukf_filter"]


def _draw_offsets(gen, n_steps, dtype):
    """The systematic resampler's uniform offset of every step, (n_steps,)
    on the generator's device: the one place this module draws (the
    process noise is ``propagate``'s own)."""
    return torch.rand((n_steps,), generator=gen, dtype=dtype,
                      device=gen.device)


def particle_filter(x0_particles, y_seq, propagate, loglik_obs, key,
                    resample_threshold: float = 0.5, mesh=None,
                    axis_name=None):
    """Bootstrap (SIR) particle filter with adaptive systematic resampling.

    x0_particles (N, n): draws from the initial state distribution; y_seq
    (T, p) observations; propagate(gen, x) -> x': the STOCHASTIC transition
    of the whole (N, n) cloud, called once a step with the run's
    ``torch.Generator`` (fold the process noise in here; see the module
    docstring for how this differs from the JAX package); loglik_obs(x, y)
    -> scalar log p(y | x) for one particle (batched with
    ``torch.func.vmap``); key: int seed or ``torch.Generator`` on the
    cloud's device; resample_threshold: resample when ESS < threshold * N
    (1.0 = always, 0.0 = never).

    mesh / axis_name: shard the cloud along the particles over the mesh
    axis (see the module docstring); ``x0_particles`` is a DTensor sharded
    so or the full array every rank holds, and the axis size must divide
    N. ``particles`` and ``log_weights`` then come back DTensors with
    ``Shard(0)``; the rest is replicated.

    Returns a dict: ``means`` (T, n) posterior-weighted filtered means,
    ``loglik``, the log marginal likelihood estimate log p(y_{1:T})
    (unbiased in expectation of the likelihood; the particle-MCMC and
    model-comparison number), ``ess`` (T,) the effective sample size per
    step, ``particles`` / ``log_weights``, the final posterior cloud.
    """
    from corrla_rs_tpu_torch.parallel.mesh import _member_view

    parts = as_tensor(x0_particles) if mesh is None else x0_particles
    if parts.ndim != 2:
        raise ValueError(f"x0_particles must be (N, n), got "
                         f"{tuple(parts.shape)}")
    n_part = int(parts.shape[0])
    sh = _member_view(parts, mesh, axis_name, "the particle count")
    parts = sh.local
    y_seq = as_tensor(y_seq, device=parts.device, dtype=parts.dtype)
    if y_seq.ndim == 1:
        y_seq = y_seq[:, None]
    if not 0.0 <= float(resample_threshold) <= 1.0:
        raise ValueError("resample_threshold must be in [0, 1]")
    thresh = float(resample_threshold) * n_part
    gen = as_generator(key, parts.device)
    lik_v = torch.func.vmap(loglik_obs, in_dims=(0, None))
    log_n = math.log(float(n_part))
    n_steps = int(y_seq.shape[0])
    offsets = _draw_offsets(gen, n_steps, parts.dtype)
    if sh.coord:
        gen = fold_seed(gen, sh.coord, parts.device)
    stay = torch.arange(n_part, device=parts.device)
    # the whole (N,) vector, also on a mesh
    log_w = parts.new_full((n_part,), -log_n)
    ll = parts.new_zeros(())
    means = parts.new_empty((n_steps, parts.shape[1]))
    ess_hist = parts.new_empty((n_steps,))
    for t in range(n_steps):
        parts = propagate(gen, parts)
        lw_new = sh.gather(log_w[sh.rows] + lik_v(parts, y_seq[t]))
        # evidence increment: log sum_i w_i p(y|x_i) with normalized w
        inc = torch.logsumexp(lw_new, dim=0)
        log_w = lw_new - inc
        ess = 1.0 / torch.sum(torch.exp(2.0 * log_w))
        means[t] = sh.sum(torch.exp(log_w[sh.rows]) @ parts)
        ess_hist[t] = ess
        # adaptive resampling without a branch: the indices are computed
        # every step and selected by the ESS predicate
        take = ess < thresh
        idx = torch.where(take, _systematic_resample(offsets[t], log_w,
                                                     n_part), stay)
        parts = sh.take(parts, idx)
        log_w = torch.where(take, torch.full_like(log_w, -log_n), log_w)
        ll = ll + inc
    return {"means": means, "loglik": float(ll), "ess": ess_hist,
            "particles": sh.dtensor(parts),
            "log_weights": sh.dtensor(log_w[sh.rows])}


def _ut_weights(n, alpha, beta, kappa, like):
    lam = alpha**2 * (n + kappa) - n
    c = n + lam
    wm = like.new_full((2 * n + 1,), 1.0 / (2.0 * c))
    wm[0] = lam / c
    wc = wm.clone()
    wc[0] = lam / c + (1.0 - alpha**2 + beta)
    return wm, wc, c


def _noise_cov(x, n: int, like: torch.Tensor) -> torch.Tensor:
    """A noise covariance given as a scalar, a diagonal or a matrix."""
    if _ndim(x) == 1:
        return torch.diag(as_tensor(x, device=like.device, dtype=like.dtype))
    return _cov(x, n, like)


def ukf_filter(x0_mean, x0_cov, y_seq, f, h, q, r,
               alpha: float = 1.0, beta: float = 2.0,
               kappa: float = 0.0, jitter: float = 0.0):
    """Unscented Kalman filter (Julier-Uhlmann sigma points, Wan-van der
    Merwe scaling) over an observation record.

    x0_mean (n,) / x0_cov (n, n): initial state belief; y_seq (T, p);
    f(x) -> x' the DETERMINISTIC transition (process noise enters as the
    additive covariance q); h(x) -> y the observation map, both for one
    (n,) state and batched with ``torch.func.vmap``; q / r: process /
    observation noise covariances (scalars broadcast); alpha/beta/kappa:
    the standard UT scaling knobs (default alpha=1: the textbook
    1e-3..1e-1 values make the UT weights huge and cancelling (w0 = -99 at
    alpha=0.1, n=2), which costs about 4 digits in f32; shrink alpha only in
    f64); jitter: added to the predicted covariance diagonal before each
    Cholesky (set about 1e-9 for stiff f32 problems).

    Exact on linear systems: means, covariances AND the innovations
    log-likelihood reproduce the closed-form Kalman filter. Returns a dict:
    ``means`` (T, n), ``covs`` (T, n, n) filtered moments, ``loglik`` the
    Gaussian innovations log-likelihood (the model-evidence surrogate for
    near-Gaussian posteriors; compare with :func:`particle_filter`'s exact
    one).
    """
    mean = as_tensor(x0_mean).reshape(-1)
    n = int(mean.shape[0])
    cov = _noise_cov(x0_cov, n, mean) if _ndim(x0_cov) == 0 else as_tensor(
        x0_cov, device=mean.device, dtype=mean.dtype)
    if cov.shape != (n, n):
        raise ValueError(f"x0_cov must be ({n}, {n}), got "
                         f"{tuple(cov.shape)}")
    y_seq = as_tensor(y_seq, device=mean.device, dtype=mean.dtype)
    if y_seq.ndim == 1:
        y_seq = y_seq[:, None]
    n_steps, p = int(y_seq.shape[0]), int(y_seq.shape[1])
    q_mat = _noise_cov(q, n, mean)
    r_mat = torch.atleast_2d(_noise_cov(r, p, mean))
    if q_mat.shape != (n, n) or r_mat.shape != (p, p):
        raise ValueError(
            f"q must be ({n}, {n}) and r ({p}, {p}), got "
            f"{tuple(q_mat.shape)} / {tuple(r_mat.shape)}"
        )
    wm, wc, c = _ut_weights(n, float(alpha), float(beta), float(kappa), mean)
    sqrt_c = math.sqrt(c)
    f_v, h_v = torch.func.vmap(f), torch.func.vmap(h)
    jit_eye = float(jitter) * torch.eye(n, dtype=mean.dtype,
                                        device=mean.device)
    log2pi = math.log(2.0 * math.pi)

    def sigma_points(mean, cov):
        chol = torch.linalg.cholesky(0.5 * (cov + cov.mT) + jit_eye)
        offs = sqrt_c * chol.mT                     # rows: scaled cols of L
        return torch.cat([mean[None, :], mean + offs, mean - offs], dim=0)

    def wgram(w, da, db):
        return (w[:, None] * da).mT @ db

    ll = mean.new_zeros(())
    means = mean.new_empty((n_steps, n))
    covs = mean.new_empty((n_steps, n, n))
    for t in range(n_steps):
        # --- predict ---
        sp_f = f_v(sigma_points(mean, cov))         # (2n+1, n)
        m_pred = wm @ sp_f
        d_f = sp_f - m_pred
        p_pred = wgram(wc, d_f, d_f) + q_mat
        # --- update (fresh sigma points from the prediction) ---
        sp2 = sigma_points(m_pred, p_pred)
        sp_h = h_v(sp2)
        y_pred = wm @ sp_h
        d_y = sp_h - y_pred
        s = wgram(wc, d_y, d_y) + r_mat             # innovation cov
        c_xy = wgram(wc, sp2 - m_pred, d_y)         # cross cov
        gain = torch.linalg.solve(s.mT, c_xy.mT).mT     # C_xy S^{-1}
        innov = y_seq[t] - y_pred
        mean = m_pred + gain @ innov
        cov = p_pred - gain @ s @ gain.mT
        cov = 0.5 * (cov + cov.mT)
        sign, logdet = torch.linalg.slogdet(s)
        # a loss of positive definiteness of the innovation covariance
        # (f32) must surface as NaN in loglik, not as a silently wrong value
        logdet = torch.where(sign > 0, logdet, math.nan)
        quad = torch.sum(innov * torch.linalg.solve(s, innov))
        ll = ll - 0.5 * (p * log2pi + logdet + quad)
        means[t], covs[t] = mean, cov
    return {"means": means, "covs": covs, "loglik": float(ll)}
