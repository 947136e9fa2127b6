"""Polynomial chaos expansion (PCE) surrogates.

Counterpart of ``corrla_rs_tpu/ops/pce.py`` (Sudret 2008): a model is
projected onto an orthonormal polynomial basis of its inputs (Legendre for
uniform inputs, probabilists' Hermite for Gaussian ones, or a basis
orthonormal to the data's own marginals by discrete Stieltjes
recurrences), and its mean, variance and Sobol' indices are read off the
coefficients.

The per-dimension recurrence tables and the basis matrix Psi (n, P) are
built on the device, Psi as a running product over the dimensions of the
tables gathered at the multi-indices (one (n, P) buffer, where a gather of
the whole (n, P, d) block would take d times as much); the regression fit
is ``torch.linalg.lstsq`` and prediction one GEMM. As in the JAX package,
the multi-index sets, the Stieltjes recurrences and the sparse fit's
greedy selection (``_omp_loo``) are host numpy. ``fit_quadrature``
evaluates the model once over the rule's nodes with ``torch.func.vmap``.
The standardisation (``bounds``, ``_mean``, ``_std``), the multi-indices and
the recurrences are host arrays; ``coeffs`` is a tensor.
"""
from __future__ import annotations

import math

import numpy as np
import torch

from corrla_rs_tpu_torch.utils.device import _host_f64, as_tensor

__all__ = ["PolynomialChaos", "total_degree_multi_indices"]


def total_degree_multi_indices(dim: int, order: int) -> np.ndarray:
    """All multi-indices alpha in N^dim with sum(alpha) <= order,
    graded-lexicographic (constant term first). Shape (P, dim),
    P = C(dim + order, order)."""
    if dim < 1:
        raise ValueError(f"dim must be >= 1, got {dim}")

    def comps(total, slots):
        # graded compositions, O(P * dim) — a filtered itertools.product
        # would enumerate (total+1)^dim tuples, which hangs by dim ~ 12
        if slots == 1:
            yield (total,)
            return
        for first in range(total + 1):
            for rest in comps(total - first, slots - 1):
                yield (first,) + rest

    idx = [
        alpha
        for total in range(order + 1)
        for alpha in comps(total, dim)
    ]
    return np.asarray(idx, dtype=np.int32)


def _legendre_table(z: torch.Tensor, order: int) -> torch.Tensor:
    """Orthonormal Legendre on U(-1, 1): (n, d, order+1).
    P~_k = sqrt(2k+1) P_k; E[P~_j P~_k] = delta_jk under U(-1,1)."""
    polys = [torch.ones_like(z), z]
    for k in range(1, order):
        polys.append(((2 * k + 1) * z * polys[k] - k * polys[k - 1])
                     / (k + 1))
    scale = torch.as_tensor(
        [math.sqrt(2 * k + 1) for k in range(order + 1)], dtype=z.dtype,
        device=z.device)
    return torch.stack(polys[: order + 1], dim=-1) * scale


def _hermite_table(z: torch.Tensor, order: int) -> torch.Tensor:
    """Orthonormal probabilists' Hermite on N(0, 1): (n, d, order+1).
    He~_k = He_k / sqrt(k!)."""
    polys = [torch.ones_like(z), z]
    for k in range(1, order):
        polys.append(z * polys[k] - k * polys[k - 1])
    scale = torch.as_tensor(
        [1.0 / math.sqrt(math.factorial(k)) for k in range(order + 1)],
        dtype=z.dtype, device=z.device)
    return torch.stack(polys[: order + 1], dim=-1) * scale


def _stieltjes_recurrence(z: np.ndarray, order: int):
    """Three-term recurrence coefficients of the polynomials
    ORTHONORMAL under the empirical measure of the samples ``z`` (n,)
    — the discrete Stieltjes procedure (numerically robust, unlike
    Hankel-moment approaches). Returns (a (order,), sb (order+1,)) with
    sb[0] = 1 and the recurrence
    p_{k+1} = ((z - a[k]) p_k - sb[k] p_{k-1}) / sb[k+1]."""
    n = z.shape[0]
    a = np.zeros(order)
    sb = np.ones(order + 1)
    p_prev = np.zeros(n)
    p = np.ones(n)
    for k in range(order):
        a[k] = float(np.mean(z * p * p))
        q = (z - a[k]) * p - sb[k] * p_prev
        b_next = float(np.mean(q * q))
        if b_next <= 1e-12:
            raise ValueError(
                f"data supports orthonormal polynomials only up to "
                f"degree {k}; requested order {order} (need more "
                f"distinct sample values)"
            )
        sb[k + 1] = np.sqrt(b_next)
        p_prev, p = p, q / sb[k + 1]
    return a, sb


def _data_table(z: torch.Tensor, rec_a: torch.Tensor, rec_sb: torch.Tensor,
                order: int) -> torch.Tensor:
    """(n, d, order+1) table of the per-dimension data-driven orthonormal
    polynomials from their Stieltjes recurrences (rec_a (d, K),
    rec_sb (d, K+1), K >= order)."""
    polys = [torch.ones_like(z)]
    if order >= 1:
        polys.append((z - rec_a[None, :, 0]) / rec_sb[None, :, 1])
    for k in range(1, order):
        nxt = ((z - rec_a[None, :, k]) * polys[k]
               - rec_sb[None, :, k] * polys[k - 1]) / rec_sb[None, :, k + 1]
        polys.append(nxt)
    return torch.stack(polys[: order + 1], dim=-1)


def _omp_loo(psi: np.ndarray, y: np.ndarray, max_terms: int):
    """Greedy forward selection (orthogonal matching pursuit) with exact
    corrected leave-one-out model selection.

    Returns ``(sel, loo, coeffs)``: the best support (column indices of
    ``psi``, constant column 0 always first), its relative corrected LOO
    error, and its OLS coefficients. Host numpy f64: the factorizations
    are (n, k) with k <= max_terms, trivial; exactness of the LOO (from
    the hat diagonal, no refits) is what matters.
    """
    n, p = psi.shape
    norms = np.linalg.norm(psi, axis=0)
    norms[norms == 0] = 1.0
    psi_n = psi / norms
    y_var = max(float(np.var(y)), 1e-300)

    active = [0]  # constant term always in
    best = None
    stall = 0
    for _step in range(min(max_terms, p, max(n - 2, 1))):
        a = psi[:, active]
        q, rr = np.linalg.qr(a)
        coef_a = np.linalg.solve(
            rr, q.T @ y
        ) if rr.shape[0] else np.zeros(0)
        y_hat = a @ coef_a
        h = np.minimum(np.sum(q * q, axis=1), 1.0 - 1e-12)
        k = len(active)
        loo = float(np.mean(((y - y_hat) / (1.0 - h)) ** 2)) / y_var
        if n > k:
            # Blatman-Sudret corrected LOO: (n/(n-k)) (1 + tr(C^-1)) with
            # C = Psi_A^T Psi_A (orthonormal basis columns have norm^2
            # ~ n, so tr(C^-1) ~ k/n) — penalizes collinear / overgrown
            # supports that plain hat-LOO under-counts because the
            # support itself was chosen on the same data
            rinv = np.linalg.inv(rr)
            tr_cinv = float(np.sum(rinv * rinv))
            loo *= n / (n - k) * (1.0 + tr_cinv)
        if best is None or loo < best[0] * (1.0 - 1e-9):
            best = (loo, list(active), coef_a)
            stall = 0
        else:
            stall += 1
            if stall >= 10:
                break  # 10 consecutive non-improving terms: overfitting
        r = y - y_hat
        # next term: max |correlation| with the residual
        corr = np.abs(psi_n.T @ r)
        corr[active] = -np.inf
        j = int(np.argmax(corr))
        if not np.isfinite(corr[j]) or corr[j] <= 0:
            break
        active.append(j)

    loo, sel, coeffs = best
    return sel, loo, coeffs


def _moments(x):
    """Column means and population standard deviations of x, float64
    host arrays."""
    return (_host_f64(x.mean(dim=0)),
            _host_f64(x.std(dim=0, correction=0)))


class PolynomialChaos:
    """PCE surrogate with analytic moments and Sobol' indices.

    dist: "uniform" (inputs uniform on the box ``bounds``, Legendre basis),
    "gaussian" (inputs N(mean, std^2) per dim, Hermite basis; pass
    ``mean``/``std`` or let ``fit`` estimate them), or "data" (arbitrary
    polynomial chaos: a basis orthonormal to the training inputs' empirical
    marginals). All assume independent inputs. order: total polynomial
    degree; the basis has C(d + order, order) terms. Inputs go to
    ``device`` when numpy (default ``utils.device.default_device()``).
    """

    def __init__(self, order: int, dist: str = "uniform", bounds=None,
                 mean=None, std=None):
        if dist not in ("uniform", "gaussian", "data"):
            raise ValueError(
                f"dist must be 'uniform'|'gaussian'|'data', got {dist!r}"
            )
        if dist == "uniform" and bounds is None:
            raise ValueError("dist='uniform' requires bounds (d, 2)")
        self.order = int(order)
        self.dist = dist
        self.bounds = None if bounds is None else np.asarray(
            bounds, dtype=np.float64
        )
        self._mean = None if mean is None else np.asarray(mean, np.float64)
        self._std = None if std is None else np.asarray(std, np.float64)

    def _standardize(self, x: torch.Tensor) -> torch.Tensor:
        def const(v):
            return torch.as_tensor(v, dtype=x.dtype, device=x.device)

        if self.dist == "uniform":
            lo = const(self.bounds[:, 0])
            span = const(self.bounds[:, 1] - self.bounds[:, 0])
            return 2.0 * (x - lo) / span - 1.0
        return (x - const(self._mean)) / const(self._std)

    def _ensure_data_recurrences(self, x, up_to: int) -> None:
        """(Re)build the per-dimension Stieltjes recurrences from the
        training inputs when dist='data' and the stored depth is
        insufficient (orthonormal under the empirical marginals of x)."""
        have = getattr(self, "_rec_a", None)
        if have is not None and have.shape[1] >= up_to:
            return
        z = _host_f64(self._standardize(x))
        d = z.shape[1]
        a = np.zeros((d, up_to))
        sb = np.ones((d, up_to + 1))
        for j in range(d):
            a[j], sb[j] = _stieltjes_recurrence(z[:, j], up_to)
        self._rec_a, self._rec_sb = a, sb

    def _basis(self, x: torch.Tensor) -> torch.Tensor:
        z = self._standardize(x)
        if self.dist == "uniform":
            table = _legendre_table(z, self.order)
        elif self.dist == "gaussian":
            table = _hermite_table(z, self.order)
        else:                                       # data-driven (aPC)
            table = _data_table(
                z, torch.as_tensor(self._rec_a, dtype=z.dtype,
                                   device=z.device),
                torch.as_tensor(self._rec_sb, dtype=z.dtype,
                                device=z.device), self.order,
            )                                       # (n, d, order+1)
        # Psi[:, k] = prod_j table[:, j, alpha_k[j]], as a running product
        # over j of (n, P) gathers
        alpha = torch.as_tensor(np.asarray(self._alpha), dtype=torch.int64,
                                device=z.device)    # (P, d)
        psi = table[:, 0, alpha[:, 0]]
        for j in range(1, alpha.shape[1]):
            psi = psi * table[:, j, alpha[:, j]]
        return psi                                  # (n, P)

    def _set_moments(self, x) -> None:
        """Estimate mean and std independently (a user-provided std must
        survive a None mean, and vice versa)."""
        if self.dist in ("gaussian", "data"):
            mean, std = _moments(x)
            if self._mean is None:
                self._mean = mean
            if self._std is None:
                self._std = std

    def fit(self, x, y, device=None):
        """Least-squares PCE fit on (n, d) samples and (n,) responses."""
        x = as_tensor(x, device=device)
        y = as_tensor(y, device=x.device).reshape(-1)
        d = x.shape[1]
        self._alpha = total_degree_multi_indices(d, self.order)
        self._set_moments(x)
        if self.dist == "data":
            self._ensure_data_recurrences(x, self.order)
        psi = self._basis(x)                        # (n, P)
        n, p = psi.shape
        if n < p:
            raise ValueError(
                f"{n} samples cannot determine {p} coefficients "
                f"(order {self.order}, dim {d}); add samples or lower order"
            )
        y = y.to(psi.dtype)                         # y may be integer
        coeffs = torch.linalg.lstsq(psi, y[:, None]).solution[:, 0]
        self.coeffs = coeffs
        # training diagnostics
        y_hat = psi @ coeffs
        ss_res = torch.sum((y - y_hat) ** 2)
        ss_tot = torch.sum((y - y.mean()) ** 2).clamp_min(
            torch.finfo(y.dtype).tiny)
        self.r2 = float(1.0 - ss_res / ss_tot)
        return self

    def fit_quadrature(self, fn, level: int = 3, rule=None, device=None):
        """Stochastic collocation: each coefficient c_k = E[f Psi_k] by a
        sparse quadrature matched to the input measure (Smolyak
        Clenshaw-Curtis for uniform inputs, Gauss-Hermite for Gaussian), or
        any ``rule`` over the standard space. fn: callable (d,) -> scalar,
        evaluated once over all nodes with ``torch.func.vmap`` on ``device``.
        """
        from corrla_rs_tpu_torch.ops.quadrature import smolyak_quadrature

        if self.dist == "data":
            raise ValueError(
                "fit_quadrature needs a closed-form input measure; "
                "dist='data' bases are defined by samples — use fit()")
        if self.dist == "uniform":
            d = self.bounds.shape[0]
        else:
            if self._mean is None or self._std is None:
                raise ValueError(
                    "dist='gaussian' projection needs mean=/std= at "
                    "construction (there are no samples to estimate "
                    "them from)")
            d = self._mean.shape[0]
        self._alpha = total_degree_multi_indices(d, self.order)
        if rule is None:
            kind = ("clenshaw_curtis" if self.dist == "uniform"
                    else "gauss_hermite")
            rule = smolyak_quadrature(d, int(level), rule=kind)
        z = np.asarray(rule.nodes)                   # standard space
        w = np.asarray(rule.weights)
        if self.dist == "uniform":
            lo = self.bounds[:, 0]
            span = self.bounds[:, 1] - self.bounds[:, 0]
            x_nodes = lo + 0.5 * (z + 1.0) * span
            w = w / 2.0 ** d        # dz-mass 2^d -> probability measure
        else:
            x_nodes = self._mean + self._std * z
        x_nodes = as_tensor(x_nodes, device=device)
        vals = as_tensor(torch.func.vmap(fn)(x_nodes),
                         device=x_nodes.device).reshape(-1)
        psi = self._basis(x_nodes)                   # (n_nodes, P)
        vals = vals.to(psi.dtype)
        wj = torch.as_tensor(w, dtype=psi.dtype, device=psi.device)
        self.coeffs = psi.mT @ (wj * vals)
        # diagnostic: weighted surrogate residual at the nodes
        y_hat = psi @ self.coeffs
        num = torch.sum(wj.abs() * (vals - y_hat) ** 2)
        den = torch.sum(wj.abs() * (vals - torch.sum(wj * vals)
                                    / torch.sum(wj)) ** 2).clamp_min(
            torch.finfo(psi.dtype).tiny)
        self.r2 = float(1.0 - num / den)
        return self

    def fit_sparse(self, x, y, max_order: int | None = None,
                   max_terms: int | None = None,
                   max_candidates: int = 20000, device=None):
        """Sparse adaptive PCE (Blatman & Sudret 2011 style).

        Total-degree bases explode combinatorially (C(d + q, q) terms —
        d=20, q=3 is already 1771), so the dense ``fit`` needs n >~ P
        samples. This method selects a SPARSE basis instead:

        - degree-adaptive outer loop: candidate bases of growing total
          degree q = 1, 2, ... (up to ``max_order``, default: grow while
          the error improves);
        - greedy forward selection on each candidate set (orthogonal
          matching pursuit — the same greedy-path idea as the hybrid
          LAR of Blatman & Sudret; terms enter by correlation with the
          residual, each step refit by OLS on the active set);
        - model selection by corrected leave-one-out error, computed
          exactly from the OLS hat matrix (no refits): the classic
          eps_LOO = mean(((y - y_hat) / (1 - h))^2) / var(y) with the
          (n / (n - k)) small-sample correction.

        Keeps the best support found across all degrees; the constant
        term is always included (so ``mean``/``var``/``sobol_indices``
        read off the coefficients unchanged). Typical outcome: a 20-d
        quadratic with a handful of interactions is recovered from
        n ~ tens of samples where the dense basis would need n >= 231.

        Selection runs in f64 on the host (tiny (n, k) factorizations);
        ``predict`` stays one matmul on the device over the sparse basis. Returns self; sets ``loo_error`` (relative corrected LOO
        of the selected model) and ``r2``.
        """
        x = as_tensor(x, device=device)
        y_dev = as_tensor(y, device=x.device).reshape(-1)
        d = x.shape[1]
        n = x.shape[0]
        yh = _host_f64(y_dev)
        y_var = float(np.var(yh))
        if y_var <= 0:
            raise ValueError("response has zero variance")
        if max_terms is None:
            max_terms = max(2, min(n - 2, n * 2 // 3))
        self._set_moments(x)

        best = None  # (loo, order, alpha_sel, coeffs)
        q = 1
        while True:
            alpha_full = total_degree_multi_indices(d, q)
            if alpha_full.shape[0] > max_candidates:
                if best is None:
                    raise ValueError(
                        f"even the degree-1 candidate basis exceeds "
                        f"max_candidates={max_candidates} (d={d}); raise "
                        "max_candidates"
                    )
                break
            self.order = q
            self._alpha = alpha_full
            if self.dist == "data":
                try:
                    self._ensure_data_recurrences(x, q)
                except ValueError:
                    # the data cannot support degree-q orthonormal
                    # polynomials; stop growing and keep the best model
                    if best is None:
                        raise
                    break
            psi = _host_f64(self._basis(x))               # (n, P)
            sel, loo, coeffs = _omp_loo(psi, yh, max_terms)
            # the degree loop demands a REAL improvement (1%) to continue:
            # richer dictionaries always shave a little post-selection LOO
            # by fitting noise, and that bias must not drive q upward
            if best is None or loo < best[0] * 0.99:
                best = (loo, q, alpha_full[sel], coeffs)
                improved = True
            else:
                improved = False
            if max_order is not None:
                if q >= max_order:
                    break
            elif not improved or best[0] < 1e-12:
                break
            q += 1

        loo, q_best, alpha_sel, coeffs = best
        self.order = int(alpha_sel.max()) if alpha_sel.size else 0
        # keep per-dim max degree for the basis table; order bounds it
        self.order = max(self.order, 1)
        self._alpha = np.asarray(alpha_sel, np.int32)
        self.coeffs = torch.as_tensor(coeffs, device=x.device)
        self.loo_error = float(loo)
        y_hat = _host_f64(self.predict(x))
        ss_res = float(np.sum((yh - y_hat) ** 2))
        self.r2 = 1.0 - ss_res / (n * y_var)
        return self

    def predict(self, xq) -> torch.Tensor:
        """The surrogate at (n, d) points, on the coefficients' device."""
        xq = as_tensor(xq, device=self.coeffs.device)
        return self._basis(xq).to(self.coeffs.dtype) @ self.coeffs

    # ---- analytic statistics (orthonormal basis => sums of squares) ----

    @property
    def mean(self) -> float:
        return float(self.coeffs[0])

    @property
    def var(self) -> float:
        return float(torch.sum(self.coeffs[1:] ** 2))

    def sobol_indices(self):
        """dict with ``s1`` and ``st`` (d,) tensors on the coefficients'
        device, exact for the surrogate (Sudret 2008): S1_i sums c_k^2
        over terms involving only dim i, ST_i over all terms involving
        dim i."""
        alpha = np.asarray(self._alpha)              # (P, d) host
        c2 = _host_f64(self.coeffs) ** 2
        var = max(float(c2[1:].sum()), 1e-300)
        d = alpha.shape[1]
        active = alpha > 0                           # (P, d)
        n_active = active.sum(axis=1)
        s1 = np.array([
            c2[(active[:, i]) & (n_active == 1)].sum() / var
            for i in range(d)
        ])
        st = np.array([c2[active[:, i]].sum() / var for i in range(d)])
        dev = self.coeffs.device
        return {"s1": torch.as_tensor(s1, device=dev),
                "st": torch.as_tensor(st, device=dev)}
