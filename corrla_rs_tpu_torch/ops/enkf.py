"""Ensemble data assimilation: EnKF, ETKF and ES-MDA.

Counterpart of ``corrla_rs_tpu/ops/enkf.py`` (no reference analogue; it
completes the state-estimation family next to the linear-Gaussian filter in
``ops/kalman.py``).

The linear Kalman filter needs the model as explicit (A, B, C) matrices and
propagates a full n x n covariance. Ensemble methods need only a black-box
forward map and carry the covariance IMPLICITLY in an ensemble of N states:
the workhorse for nonlinear and high-dimensional assimilation (weather,
reservoir history matching) and for Bayesian calibration of expensive
simulators (ES-MDA).

The ensemble is an (N, n) matrix, so propagation is one batch and every
analysis is dense linear algebra. Both analyses work in ENSEMBLE space (all
O(N^2) Grams and an N x N eigh), so the cost is O(N^2 (n + p)) and the n x n
covariance is never formed:

- stochastic EnKF (Burgers/Evensen 1998): perturbed observations, centered
  so the analysis mean is unbiased; the gain solve in whichever of
  observation space (p x p) and ensemble space (N x N, Woodbury) is smaller;
- ETKF (Bishop 2001, in Hunt 2007's ensemble-space form): a deterministic
  square-root filter with the exact mean update and the exact posterior
  SAMPLE covariance (I - KH) P_b, with no sampling noise from perturbations;
- ES-MDA (Emerick & Reynolds 2013): n_mda tempered EnKF updates with
  inflated observation noise alpha_i R, sum(1/alpha_i) = 1, the ensemble
  analogue of the tempered-likelihood ladder in ``ops/smc``.

``enkf_filter`` runs the forecast/analysis cycle as a host loop over the
record that reads nothing from the device. Every standard normal of an entry
point is drawn at once through the one seam ``_draw_normals``. ``propagate``,
``forward`` and a callable ``h`` take one member's (n,) state and are batched
with ``torch.func.vmap``. An ensemble runs where it is: a numpy ensemble
goes to ``utils.device.default_device()`` whatever its size.

On a mesh (``mesh=``) the ensemble is sharded along the members and every
rank makes the same call with the same arguments; the ensemble is a
DTensor sharded so, or the full array every rank holds. The normals are
drawn for the whole ensemble from the one key on every rank and each rank
keeps its rows, so a sharded analysis is the single-device one up to the
order of its sums. Forecasts and forward evaluations run on the rank's
rows with no collective. The stochastic update all-reduces the member-axis
means and Grams, O(p (p + n)) numbers, and never moves a member. The ETKF
all-gathers the (N, p) observation anomalies, builds the (N, N) transform
on every rank, and applies it to the state in a column-sharded layout: one
all-to-all there and one back, each moving (W - 1)/W of a rank's block
(``parallel.mesh._rows_to_cols``). What JAX returns sharded (the ensemble,
ES-MDA's predictions) comes back a DTensor with ``Shard(0)``; the rest is
replicated.
"""
from __future__ import annotations

import math

import torch

from corrla_rs_tpu_torch.ops.kalman import _ndim
from corrla_rs_tpu_torch.utils.device import as_tensor
from corrla_rs_tpu_torch.utils.prng import as_generator

__all__ = ["enkf_analysis", "etkf_analysis", "enkf_filter", "esmda"]


def _draw_normals(key, n_steps, n_ens, n_state, p, dtype, device):
    """(z_state (n_steps, N, n_state) or None, z_obs (n_steps, N, p)):
    the standard normals of ``n_steps`` steps (or stages) of an entry
    point, on ``device``: the one place this module draws. ``n_state`` 0
    means no process noise. ``key`` is an int seed or a generator."""
    gen = as_generator(key, device)
    z_state = None
    if n_state:
        z_state = torch.randn((n_steps, n_ens, n_state), generator=gen,
                              dtype=dtype, device=device)
    return z_state, torch.randn((n_steps, n_ens, p), generator=gen,
                                dtype=dtype, device=device)


def _ensemble(x_ens, mesh, axis_name):
    """(this rank's members, all of them without a mesh; their
    ``parallel.mesh._Members``, or its ``_Whole`` without a mesh)."""
    from corrla_rs_tpu_torch.parallel.mesh import _member_view

    sh = _member_view(x_ens, mesh, axis_name, "the ensemble size")
    return sh.local, sh


def _as_r_matrix(r, p, like):
    """Broadcast a scalar / vector / matrix observation covariance to
    (p, p); returns (r_mat, r_diag_or_None) so that a diagonal R keeps its
    cheap inverse."""
    if _ndim(r) == 0:
        d = like.new_full((p,), float(r))
        return torch.diag(d), d
    r = as_tensor(r, device=like.device, dtype=like.dtype)
    if r.ndim == 1:
        if r.shape[0] != p:
            raise ValueError(f"diagonal r must have length {p}, got "
                             f"{tuple(r.shape)}")
        return torch.diag(r), r
    if r.shape != (p, p):
        raise ValueError(f"r must be ({p}, {p}), got {tuple(r.shape)}")
    return r, None


def _obs_ensemble(x_ens, h):
    """Apply the observation operator: a (p, n) matrix or a per-member
    callable x (n,) -> (p,), batched over the ensemble."""
    if callable(h):
        return torch.func.vmap(h)(x_ens)
    return x_ens @ as_tensor(h, device=x_ens.device, dtype=x_ens.dtype).mT


def _center(x, sh):
    return x - sh.mean(x)


def _perturbations(z, r_diag, r_chol, scale: float = 1.0):
    """Centered observation perturbations from standard normals ``z``
    (N, p), the whole ensemble's: exact zero-mean noise, so that the
    ENSEMBLE MEAN sees the unperturbed innovation. ``scale`` multiplies
    R."""
    if r_diag is not None:
        e = torch.sqrt(scale * r_diag) * z
    else:
        e = z @ (math.sqrt(scale) * r_chol).mT
    return e - torch.mean(e, dim=0)


def _enkf_obs_space(x_ens, y_ens, d_pert, r_mat, sh):
    """Perturbed-obs update with the (p, p) solve: good when p <= N. The
    rows are the rank's members (``sh``) and the member-axis Grams are
    summed over the ranks."""
    n_ens = sh.n
    xa, ya = _center(x_ens, sh), _center(y_ens, sh)       # (N, n), (N, p)
    c_yy, c_yx = sh.sum(ya.mT @ ya), sh.sum(ya.mT @ xa)
    c_yy = c_yy / (n_ens - 1) + r_mat                     # (p, p)
    # X_a = X + (D - Y) C_yy^{-1} C_yx, with C_yx = Ya^T Xa / (N-1)
    w = torch.linalg.solve(c_yy, c_yx / (n_ens - 1))      # (p, n)
    return x_ens + (d_pert - y_ens) @ w


def _enkf_ens_space(x_ens, y_ens, d_pert, r_inv_diag, sh):
    """Perturbed-obs update via Woodbury in ensemble space (an N x N
    solve): good when p >> N and R is diagonal.

    (S S^T/(N-1) + R)^{-1} = R^-1 - R^-1 S ((N-1) I + S^T R^-1 S)^{-1}
    S^T R^-1  with S = Ya^T (p, N).

    On a mesh (``sh``) the (N, p) anomalies are all-gathered, the rank's
    rows of the (N, N) solve stay its own, and the state update goes
    through the (p, n) Gram Ya^T Xa summed over the ranks, so no member
    moves."""
    n_ens = sh.n
    xa, ya = _center(x_ens, sh), _center(y_ens, sh)
    ya_all = sh.gather(ya)
    yr = ya_all * r_inv_diag                              # Ya R^-1
    inner = (n_ens - 1) * torch.eye(n_ens, dtype=x_ens.dtype,
                                    device=x_ens.device) + yr @ ya_all.mT
    t1 = (d_pert - y_ens) * r_inv_diag                    # resid R^-1
    t3 = torch.linalg.solve(inner.mT, (t1 @ ya_all.mT).mT).mT  # (N, N)
    coeff = t1 - t3 @ yr                   # (N, p): resid C_yy^{-1}
    return x_ens + coeff @ sh.sum(ya.mT @ xa) / (n_ens - 1)


def _inflate(x_ens, inflation: float, sh):
    if inflation == 1.0:
        return x_ens
    mean = sh.mean(x_ens)
    return mean + inflation * (x_ens - mean)


def _analysis_inputs(x_ens, y_obs, h, r, inflation, mesh, axis_name):
    """The checks and the forecast observations both analyses share:
    (members, y_obs, their observations, r_mat, r_diag, their view)."""
    if mesh is None:
        x_ens = as_tensor(x_ens)
    if x_ens.ndim != 2:
        raise ValueError(f"x_ens must be (N, n), got {tuple(x_ens.shape)}")
    n_ens = int(x_ens.shape[0])
    if n_ens < 2:
        raise ValueError("need at least 2 ensemble members")
    x_ens, sh = _ensemble(x_ens, mesh, axis_name)
    y_obs = as_tensor(y_obs, device=x_ens.device,
                      dtype=x_ens.dtype).reshape(-1)
    p = int(y_obs.shape[0])
    r_mat, r_diag = _as_r_matrix(r, p, x_ens)
    x_ens = _inflate(x_ens, inflation, sh)
    y_ens = _obs_ensemble(x_ens, h)
    if y_ens.shape != (x_ens.shape[0], p):
        raise ValueError(
            f"observation operator produced {tuple(y_ens.shape)}, expected "
            f"({x_ens.shape[0]}, {p})"
        )
    return x_ens, y_obs, y_ens, r_mat, r_diag, sh


def enkf_analysis(x_ens, y_obs, h, r, key, inflation: float = 1.0,
                  mesh=None, axis_name=None):
    """Stochastic (perturbed-observation) EnKF analysis step.

    x_ens (N, n) forecast ensemble; y_obs (p,) observation; h the
    observation operator, a (p, n) matrix or a callable x -> y (batched
    over members); r the observation-noise covariance (scalar / diagonal
    vector / full matrix); key (int seed or ``torch.Generator``) drives the
    observation perturbations (CENTERED, so the analysis mean is unbiased);
    inflation multiplies forecast anomalies before the update.

    Returns the analysis ensemble (N, n). The ensemble-space Woodbury form
    is taken when p > N and R is diagonal, so megapixel observation vectors
    never trigger a (p, p) solve.

    mesh / axis_name: shard the ensemble along the members over the mesh
    axis (see the module docstring; the axis size must divide N); the
    analysis ensemble then comes back a DTensor with ``Shard(0)``.
    """
    x_ens, y_obs, y_ens, r_mat, r_diag, sh = _analysis_inputs(
        x_ens, y_obs, h, r, inflation, mesh, axis_name)
    p = y_ens.shape[1]
    n_ens = sh.n
    _, z = _draw_normals(key, 1, n_ens, 0, p, x_ens.dtype, x_ens.device)
    r_chol = None if r_diag is not None else torch.linalg.cholesky(r_mat)
    d_pert = y_obs + _perturbations(z[0], r_diag, r_chol)[sh.rows]
    if r_diag is not None and p > n_ens:
        x_a = _enkf_ens_space(x_ens, y_ens, d_pert, 1.0 / r_diag, sh)
    else:
        x_a = _enkf_obs_space(x_ens, y_ens, d_pert, r_mat, sh)
    return sh.dtensor(x_a)


def _etkf_update(x_ens, y_ens, y_obs, r_inv_diag, sh):
    """Hunt 2007 ensemble-space square-root update (diagonal R). On a mesh
    (``sh``) the (N, p) anomalies are all-gathered, the (N, N) transform
    is built on every rank, and it mixes the members' state anomalies in
    the column-sharded layout."""
    n_ens = sh.n
    xbar = sh.mean(x_ens)
    ybar = sh.mean(y_ens)
    ya = sh.gather(y_ens - ybar)                          # (N, p)
    c = ya * r_inv_diag                                   # Ya R^-1 (N, p)
    inner = (n_ens - 1) * torch.eye(n_ens, dtype=x_ens.dtype,
                                    device=x_ens.device) + c @ ya.mT
    evals, evecs = torch.linalg.eigh(inner)
    evals = evals.clamp_min(torch.finfo(x_ens.dtype).tiny)
    # Pa~ = inner^{-1};  W = sqrt((N-1) Pa~)  (symmetric sqrt)
    pa_half = (evecs * torch.rsqrt(evals)) @ evecs.mT * math.sqrt(n_ens - 1)
    wbar = (evecs * (1.0 / evals)) @ (evecs.mT @ (c @ (y_obs - ybar)))
    # rows of wbar + pa_half: the per-member weights
    cols_block, cols = sh.to_cols(x_ens - xbar)
    return xbar + sh.to_rows((wbar + pa_half) @ cols_block, cols)


def etkf_analysis(x_ens, y_obs, h, r, inflation: float = 1.0,
                  mesh=None, axis_name=None):
    """Deterministic ensemble-transform Kalman filter analysis.

    The signature of :func:`enkf_analysis` minus the key (no perturbations:
    it is a square-root filter). It works with a diagonal R (scalar or
    vector); a full R is whitened by its Cholesky factor first. The analysis
    MEAN equals the exact Kalman update built from the sample covariances,
    and the analysis SAMPLE covariance equals (I - KH) P_b exactly, with no
    Monte-Carlo noise, which is why ETKF dominates the stochastic EnKF at
    small N.

    mesh / axis_name: as in :func:`enkf_analysis`.
    """
    x_ens, y_obs, y_ens, r_mat, r_diag, sh = _analysis_inputs(
        x_ens, y_obs, h, r, inflation, mesh, axis_name)
    if r_diag is None:
        # whiten a full R: solve L z = y, so that the whitened problem has
        # identity noise covariance
        chol = torch.linalg.cholesky(r_mat)
        y_ens = torch.linalg.solve_triangular(chol, y_ens.mT,
                                              upper=False).mT
        y_obs = torch.linalg.solve_triangular(chol, y_obs[:, None],
                                              upper=False)[:, 0]
        r_inv_diag = torch.ones_like(y_obs)
    else:
        r_inv_diag = 1.0 / r_diag
    return sh.dtensor(_etkf_update(x_ens, y_ens, y_obs, r_inv_diag, sh))


def enkf_filter(x0_ens, y_seq, propagate, h, r, key,
                method: str = "etkf", inflation: float = 1.0,
                q=None, mesh=None, axis_name=None):
    """Full forecast/analysis assimilation cycle over a record.

    x0_ens (N, n) initial ensemble; y_seq (T, p) observations; propagate:
    per-member state map x (n,) -> (n,) (batched with ``torch.func.vmap``);
    h / r as in :func:`enkf_analysis`; key: int seed or ``torch.Generator``;
    q: optional additive process-noise covariance (scalar / diagonal
    vector), sampled fresh each forecast; method 'etkf' (deterministic,
    default) or 'stochastic'.

    Returns a dict: ``means`` (T, n) analysis means, ``ensemble`` (N, n)
    the final analysis ensemble, ``spread`` (T,) the mean analysis std, the
    filter-health diagnostic (collapse => inflate).

    mesh / axis_name: shard the ensemble along the members for the whole
    record (see the module docstring; the axis size must divide N): the
    forecasts run on each rank's members, ``ensemble`` comes back a
    DTensor with ``Shard(0)``, ``means`` and ``spread`` replicated.
    """
    x_ens, sh = _ensemble(x0_ens, mesh, axis_name)
    n_ens = sh.n
    n_state = int(x_ens.shape[1])
    y_seq = as_tensor(y_seq, device=x_ens.device, dtype=x_ens.dtype)
    if y_seq.ndim == 1:
        y_seq = y_seq[:, None]
    n_steps, p = int(y_seq.shape[0]), int(y_seq.shape[1])
    if method not in ("etkf", "stochastic"):
        raise ValueError(f"method must be 'etkf' or 'stochastic', "
                         f"got {method!r}")
    r_mat, r_diag = _as_r_matrix(r, p, x_ens)
    if method == "etkf" and r_diag is None:
        raise ValueError("etkf filtering needs scalar/diagonal r; "
                         "use method='stochastic' for full R")
    q_diag = None
    if q is not None:
        q_diag = (x_ens.new_full((n_state,), float(q)) if _ndim(q) == 0
                  else as_tensor(q, device=x_ens.device, dtype=x_ens.dtype))
        if q_diag.shape != (n_state,):
            raise ValueError(f"q must be scalar or ({n_state},), got "
                             f"{tuple(q_diag.shape)}")
    prop_v = torch.func.vmap(propagate)
    infl = float(inflation)
    # chol(R) does not change over the record: factor it once
    r_chol = None if r_diag is not None else torch.linalg.cholesky(r_mat)
    z_q, z_r = _draw_normals(key, n_steps, n_ens,
                             n_state if q_diag is not None else 0, p,
                             x_ens.dtype, x_ens.device)
    means = x_ens.new_empty((n_steps, n_state))
    spreads = x_ens.new_empty((n_steps,))
    for t in range(n_steps):
        x_f = prop_v(x_ens)
        if q_diag is not None:
            x_f = x_f + torch.sqrt(q_diag) * z_q[t][sh.rows]
        x_f = _inflate(x_f, infl, sh)
        y_ens = _obs_ensemble(x_f, h)
        if method == "etkf":
            x_ens = _etkf_update(x_f, y_ens, y_seq[t], 1.0 / r_diag, sh)
        else:
            x_ens = _enkf_obs_space(
                x_f, y_ens, y_seq[t] + _perturbations(
                    z_r[t], r_diag, r_chol)[sh.rows], r_mat, sh)
        means[t] = sh.mean(x_ens)
        spreads[t] = torch.mean(torch.sqrt(sh.mean((x_ens - means[t]) ** 2)))
    return {"means": means, "ensemble": sh.dtensor(x_ens),
            "spread": spreads}


def esmda(x_ens, forward, y_obs, r, key, n_mda: int = 4,
          alphas=None, mesh=None, axis_name=None):
    """Ensemble smoother with multiple data assimilation (Emerick &
    Reynolds 2013): ensemble Bayesian inversion of a black-box forward
    model.

    x_ens (N, d) prior parameter ensemble; forward: per-member map
    theta (d,) -> predicted data (p,) (batched with ``torch.func.vmap``);
    y_obs (p,) the observed data; r observation-noise covariance (scalar /
    diagonal / full); key: int seed or ``torch.Generator``; n_mda tempering
    steps with inflation coefficients alphas (default n_mda repeats of
    n_mda; they must satisfy sum(1/alpha) = 1 for the Gaussian-linear case
    to be exact).

    Returns a dict: ``ensemble`` (N, d) posterior ensemble, ``mean``,
    ``predicted`` (N, p) final forward evaluations, ``data_misfit``
    (n_mda+1,) the mean normalized misfit per stage as a host array, read
    once at the end (a monotone decrease is the convergence diagnostic).

    mesh / axis_name: shard the ensemble along the members once (see the
    module docstring; the axis size must divide N): the forward
    evaluations run on each rank's members, ``ensemble`` and ``predicted``
    come back DTensors with ``Shard(0)``, ``mean`` replicated.
    """
    x_ens, sh = _ensemble(x_ens, mesh, axis_name)
    n_ens = sh.n
    y_obs = as_tensor(y_obs, device=x_ens.device,
                      dtype=x_ens.dtype).reshape(-1)
    p = int(y_obs.shape[0])
    if alphas is None:
        alphas = [float(n_mda)] * int(n_mda)
    alphas = [float(a) for a in alphas]
    s = sum(1.0 / a for a in alphas)
    if abs(s - 1.0) > 1e-8:
        raise ValueError(
            f"sum(1/alpha) must be 1 (got {s:.6f}); e.g. n_mda equal "
            f"coefficients of value n_mda"
        )
    r_mat, r_diag = _as_r_matrix(r, p, x_ens)
    r_chol = None if r_diag is not None else torch.linalg.cholesky(r_mat)
    fwd_v = torch.func.vmap(forward)
    misfits = []

    def misfit(y_ens):
        resid = y_ens - y_obs
        if r_diag is not None:
            per_member = torch.sum(resid ** 2 / r_diag, dim=1)
        else:
            per_member = torch.sum(
                resid * torch.linalg.solve(r_mat, resid.mT).mT, dim=1)
        return sh.mean(per_member)

    _, z = _draw_normals(key, len(alphas), n_ens, 0, p, x_ens.dtype,
                         x_ens.device)
    for i, alpha in enumerate(alphas):
        y_ens = fwd_v(x_ens)
        if y_ens.shape != (x_ens.shape[0], p):
            raise ValueError(
                f"forward produced {tuple(y_ens.shape)}, expected "
                f"({x_ens.shape[0]}, {p})"
            )
        misfits.append(misfit(y_ens))
        d_pert = y_obs + _perturbations(z[i], r_diag, r_chol, alpha)[sh.rows]
        if r_diag is not None and p > n_ens:
            x_ens = _enkf_ens_space(x_ens, y_ens, d_pert,
                                    1.0 / (alpha * r_diag), sh)
        else:
            x_ens = _enkf_obs_space(x_ens, y_ens, d_pert, alpha * r_mat, sh)
    y_final = fwd_v(x_ens)
    misfits.append(misfit(y_final))
    return {"ensemble": sh.dtensor(x_ens), "mean": sh.mean(x_ens),
            "predicted": sh.dtensor(y_final),
            "data_misfit": torch.stack(misfits).double().cpu().numpy()}
