"""Canonical (C-) vine copula with bivariate pair-copula families.

Counterpart of ``corrla_rs_tpu/ops/vine.py``: a C-vine pair-copula
construction per Aas, Czado, Frigessi & Bakken (2009), "Pair-copula
constructions of multiple dependence".

Families: gaussian, clayton, gumbel, frank, independent, the 90/180/270
rotations of clayton/gumbel, and Student-t on a df grid (t3/t5/t8/t15).
Fitting inverts Kendall's tau per pair (closed form for the ellipticals
and clayton/gumbel, bisection on the Debye-function relation for frank)
and selects the family by AIC; conditioning uses the h-functions
(conditional CDFs), sampling the inverse h-functions (closed form except
gumbel and t, which use fixed-iteration bisection and Newton steps).

Every h, h-inverse and log-density is an elementwise tensor expression on
the data's device, and every fixed-count loop keeps its count: gumbel's
h-inverse 50 bisection steps, the frank tau inversion 60, the t quantile
12 safeguarded Newton steps, the maximum-likelihood refinement 40
golden-section steps. The JAX package compiles each family's score into
one program; eager PyTorch launches every elementwise step, and a t
quantile costs 12 incomplete-beta evaluations of 200 continued-fraction
steps each. So a pair fit scores its admissible families in batches
(``_PairScorer``): the four t families as one computation with nu a
(4, 1, 1) tensor and u, v stacked, whose quantiles are computed once a
pair (they do not depend on rho) and reused by every evaluation of the
golden-section search, and the rotations of clayton and gumbel as one
computation on the reflected arguments. ``_t_cdf`` evaluates the one
incomplete beta each element needs (the JAX package evaluates both forms
and selects one).

Kendall's tau: the O(n^2) sign product on the device up to
``_TAU_DEVICE_MAX_N`` points (summed in row blocks that bound its memory),
Knight's O(n log n) in the C++ host runtime (``native.kendall_tau_host``)
beyond, as the JAX package decides. Uniform draws go through the seam
``_draw_uniform``, which the parity tests fill with the JAX package's
draws; ``ops.copula`` and ``ops.rvine`` draw through it too.
"""
from __future__ import annotations

import math

import numpy as np
import torch

from corrla_rs_tpu_torch.ops.univariate_rv import betainc
from corrla_rs_tpu_torch.utils.device import _host_f64, as_tensor
from corrla_rs_tpu_torch.utils.prng import as_generator

__all__ = ["CVineCopula", "kendall_tau", "FAMILIES", "BASE_FAMILIES"]

BASE_FAMILIES = ("independent", "gaussian", "clayton", "gumbel", "frank")

# Full family set including the 90/180/270-degree rotations of the
# asymmetric (single-tail) archimedean families (negative dependence and
# the opposite tail) and the Student-t grid, whose degrees of freedom AIC
# picks alongside the family (a 2-parameter penalty: rho and the df).
FAMILIES = (
    "independent", "gaussian", "frank",
    "clayton", "clayton90", "clayton180", "clayton270",
    "gumbel", "gumbel90", "gumbel180", "gumbel270",
    "t3", "t5", "t8", "t15",
)

# df grid for the Student-t families ("t5" -> nu = 5)
_T_NU = {"t3": 3.0, "t5": 5.0, "t8": 8.0, "t15": 15.0}

_SQRT2 = math.sqrt(2.0)
_EPS = 1e-6

# above this the O(n^2) device comparison stops being the right tool
_TAU_DEVICE_MAX_N = 8192
# sign products a block of the device tau holds at once
_TAU_BLOCK_ELEMS = 1 << 24


def _draw_uniform(key, shape, dtype, device, low: float = _EPS,
                  high: float = 1.0 - _EPS) -> torch.Tensor:
    """Uniforms on [low, high) of ``shape``: the one place the copulas
    and vines draw (``jax.random.uniform(key, shape, minval=low,
    maxval=high)`` in the JAX package)."""
    gen = as_generator(key, device)
    u = torch.rand(shape, generator=gen, dtype=dtype, device=device)
    return u * (high - low) + low


def _param(th, like: torch.Tensor) -> torch.Tensor:
    """A family parameter as a tensor on ``like``'s device and dtype."""
    if isinstance(th, torch.Tensor):
        return th.to(device=like.device, dtype=like.dtype)
    return torch.as_tensor(th, dtype=like.dtype, device=like.device)


def _norm_cdf(z):
    return 0.5 * (1.0 + torch.erf(z / _SQRT2))


def _norm_ppf(u):
    return _SQRT2 * torch.special.erfinv(2.0 * u - 1.0)


def _clip_u(u):
    return torch.clamp(u, _EPS, 1.0 - _EPS)


def _pseudo_obs(x: torch.Tensor) -> torch.Tensor:
    """(ranks + 0.5) / n of every column, float64 on x's device (argsort,
    then the ranks scattered back)."""
    n, d = x.shape
    order = torch.argsort(x, dim=0, stable=True)
    ranks = torch.empty_like(order)
    ranks.scatter_(0, order, torch.arange(n, device=x.device)[:, None]
                   .expand(n, d).contiguous())
    return (ranks.to(torch.float64) + 0.5) / n


def _interp(x, xp, fp):
    """``jnp.interp(x, xp, fp)`` with constant extrapolation: xp
    ascending."""
    i = torch.searchsorted(xp, x, right=True).clamp(1, xp.shape[0] - 1)
    df = fp[i] - fp[i - 1]
    dx = xp[i] - xp[i - 1]
    delta = x - xp[i - 1]
    dx0 = dx.abs() <= np.spacing(np.finfo(np.float64).eps)
    f = torch.where(dx0, fp[i - 1],
                    fp[i - 1] + (delta / torch.where(dx0, 1.0, dx)) * df)
    f = torch.where(x < xp[0], fp[0], f)
    return torch.where(x > xp[-1], fp[-1], f)


def _marginal_sample(us, n: int, marginals):
    """Data-scale samples: each uniform column through its stored
    empirical marginal."""
    us = torch.clamp(us, 0.5 / n, 1.0 - 0.5 / n)
    grid = (torch.arange(n, dtype=torch.float64, device=us.device) + 0.5) / n
    return torch.stack([_interp(us[:, j].contiguous(), grid,
                                marginals[:, j])
                        for j in range(us.shape[1])], dim=1)


def kendall_tau(x, y, method: str = "auto", device=None):
    """Kendall's tau.

    method='device': O(n^2) sign-product mean on the data's device (numpy
    input goes to ``device``, default ``utils.device.default_device()``),
    exact for tie-free data, summed in row blocks. method='host': Knight's
    O(n log n) merge-sort algorithm in the C++ runtime
    (native/corrla_host.cpp); returns a float. method='auto' (default):
    the device up to 8192 points, the host beyond when the native runtime
    is available.
    """
    if method == "auto":
        n = np.shape(x)[0] if not hasattr(x, "shape") else x.shape[0]
        if n > _TAU_DEVICE_MAX_N:
            from corrla_rs_tpu_torch import native

            if native.available():
                method = "host"
        if method == "auto":
            method = "device"
    if method == "host":
        from corrla_rs_tpu_torch import native

        return native.kendall_tau_host(_host_f64(x), _host_f64(y))
    x = as_tensor(x, device=device)
    return _tau_device(x, as_tensor(y, device=x.device))


def _tau_device(x, y):
    n = x.shape[0]
    rows = max(1, _TAU_BLOCK_ELEMS // max(n, 1))
    total = torch.zeros((), dtype=torch.float64, device=x.device)
    for lo in range(0, n, rows):
        sx = torch.sign(x[lo:lo + rows, None] - x[None, :])
        sy = torch.sign(y[lo:lo + rows, None] - y[None, :])
        total += (sx * sy).sum(dtype=torch.float64)
    dt = x.dtype if x.is_floating_point() else torch.float64
    return (total / (n * (n - 1.0))).to(dt)


# ---------------------------------------------------------------------------
# pair-copula families: tau->param, log-pdf, h, h-inverse
# h(u | v; th) = dC(u, v)/dv  (conditional CDF of u given v)
# ---------------------------------------------------------------------------

def _gauss_logpdf(u, v, rho):
    rho = _param(rho, u)
    x, y = _norm_ppf(_clip_u(u)), _norm_ppf(_clip_u(v))
    r2 = rho * rho
    return (
        -0.5 * torch.log(1.0 - r2)
        - (r2 * (x * x + y * y) - 2.0 * rho * x * y) / (2.0 * (1.0 - r2))
    )


def _gauss_h(u, v, rho):
    rho = _param(rho, u)
    x, y = _norm_ppf(_clip_u(u)), _norm_ppf(_clip_u(v))
    return _norm_cdf((x - rho * y) / torch.sqrt(1.0 - rho * rho))


def _gauss_hinv(w, v, rho):
    rho = _param(rho, w)
    y = _norm_ppf(_clip_u(v))
    x = _norm_ppf(_clip_u(w)) * torch.sqrt(1.0 - rho * rho) + rho * y
    return _norm_cdf(x)


def _clayton_logpdf(u, v, th):
    th = _param(th, u)
    u, v = _clip_u(u), _clip_u(v)
    lu, lv = torch.log(u), torch.log(v)
    s = torch.exp(-th * lu) + torch.exp(-th * lv) - 1.0
    return (
        torch.log1p(th) - (th + 1.0) * (lu + lv)
        - (2.0 + 1.0 / th) * torch.log(s)
    )


def _clayton_h(u, v, th):
    th = _param(th, u)
    u, v = _clip_u(u), _clip_u(v)
    s = u ** (-th) + v ** (-th) - 1.0
    return v ** (-th - 1.0) * s ** (-1.0 - 1.0 / th)


def _clayton_hinv(w, v, th):
    th = _param(th, w)
    w, v = _clip_u(w), _clip_u(v)
    t = (w * v ** (th + 1.0)) ** (-th / (th + 1.0))
    return (t + 1.0 - v ** (-th)) ** (-1.0 / th)


def _gumbel_logpdf(u, v, th):
    th = _param(th, u)
    u, v = _clip_u(u), _clip_u(v)
    lu, lv = -torch.log(u), -torch.log(v)   # positive
    s = lu ** th + lv ** th
    spow = s ** (1.0 / th)
    return (
        -spow + lu + lv
        + (th - 1.0) * (torch.log(lu) + torch.log(lv))
        + (1.0 / th - 2.0) * torch.log(s)
        + torch.log(spow + th - 1.0)
    )


def _gumbel_h(u, v, th):
    th = _param(th, u)
    u, v = _clip_u(u), _clip_u(v)
    lu, lv = -torch.log(u), -torch.log(v)
    s = lu ** th + lv ** th
    c = torch.exp(-s ** (1.0 / th))
    return c / v * s ** (1.0 / th - 1.0) * lv ** (th - 1.0)


def _gumbel_hinv(w, v, th, n_bisect: int = 50):
    """No closed form: fixed-iteration bisection on u."""
    th = _param(th, w)
    w, v = _clip_u(w), _clip_u(v)
    w, v = torch.broadcast_tensors(w, v)
    lo = torch.full_like(w, _EPS)
    hi = torch.full_like(w, 1.0 - _EPS)
    for _ in range(n_bisect):
        mid = 0.5 * (lo + hi)
        too_big = _gumbel_h(mid, v, th) > w
        hi = torch.where(too_big, mid, hi)
        lo = torch.where(too_big, lo, mid)
    return 0.5 * (lo + hi)


def _frank_logpdf(u, v, th):
    th = _param(th, u)
    u, v = _clip_u(u), _clip_u(v)
    et = torch.expm1(-th)
    eu = torch.expm1(-th * u)
    ev = torch.expm1(-th * v)
    den = et + eu * ev
    return (
        torch.log(th.abs()) + torch.log(et.abs())
        - th * (u + v) - 2.0 * torch.log(den.abs())
    )


def _frank_h(u, v, th):
    th = _param(th, u)
    u, v = _clip_u(u), _clip_u(v)
    et = torch.expm1(-th)
    eu = torch.expm1(-th * u)
    ev = torch.expm1(-th * v)
    return (torch.exp(-th * v) * eu) / (et + eu * ev)


def _frank_hinv(w, v, th):
    # solve w = e^{-th v}(e^{-th u}-1)
    #           / [(e^{-th}-1)+(e^{-th u}-1)(e^{-th v}-1)]
    # for u: (e^{-th u}-1) = w (e^{-th}-1) / (e^{-th v}(1-w) + w)
    th = _param(th, w)
    w, v = _clip_u(w), _clip_u(v)
    et = torch.expm1(-th)
    ev = torch.exp(-th * v)
    return _clip_u(-torch.log1p(w * et / (ev * (1.0 - w) + w)) / th)


# ---------------------------------------------------------------------------
# Student-t copula (elliptical, tail dependence in both tails); theta = rho,
# nu fixed per family ("t5" etc.), or a tensor of nus for a batch of them:
#   logpdf: bivariate-t density over the product of the marginals
#   h(u|v) = T_{nu+1}( (x - rho y) / sqrt((1-rho^2)(nu+y^2)/(nu+1)) )
#   (Aas et al. 2009, eq. 10-12), with x = T_nu^{-1}(u), y = T_nu^{-1}(v)
# ---------------------------------------------------------------------------

def _t_cdf(x, nu):
    """Student-t CDF through the regularized incomplete beta function.

    Two forms of the tail mass P(T > |x|), picked by region: I_z(nu/2,
    1/2) with z = nu/(nu+x^2) in the tails, and 1 - I_w(1/2, nu/2) with
    w = x^2/(nu+x^2) near the median (where z rounds to 1). Each element
    evaluates only the form it takes; the incomplete beta is elementwise,
    so the values are those of evaluating both and selecting."""
    nu = _param(nu, x)
    x2 = x * x
    far = x2 > nu
    arg = torch.where(far, nu / (nu + x2), x2 / (nu + x2))
    beta = betainc(torch.where(far, nu / 2.0, 0.5),
                   torch.where(far, 0.5, nu / 2.0), arg)
    tail = torch.where(far, 0.5 * beta, 0.5 * (1.0 - beta))
    return torch.where(x >= 0, 1.0 - tail, tail)


def _t_logpdf_uni(x, nu):
    nu = _param(nu, x)
    return (
        torch.lgamma((nu + 1.0) / 2.0)
        - torch.lgamma(nu / 2.0)
        - 0.5 * torch.log(nu * math.pi)
        - (nu + 1.0) / 2.0 * torch.log1p(x * x / nu)
    )


def _t_ppf_newton(u, nu):
    """Cornish-Fisher seed and 12 safeguarded Newton steps, the bracket
    kept from the iterates' own signs (starting at +-1e3, far beyond
    T_3^{-1}(_EPS) ~ 72)."""
    u = _clip_u(u)
    z = _norm_ppf(u)
    x0 = (
        z
        + (z ** 3 + z) / (4.0 * nu)
        + (5.0 * z ** 5 + 16.0 * z ** 3 + 3.0 * z) / (96.0 * nu * nu)
    )
    lo = torch.full_like(x0, -1e3)
    hi = torch.full_like(x0, 1e3)
    x = torch.clamp(x0, -1e3, 1e3)
    for _ in range(12):
        f = _t_cdf(x, nu) - u
        lo = torch.where(f < 0, x, lo)   # cdf too small -> x below root
        hi = torch.where(f > 0, x, hi)   # cdf too big   -> x above root
        pdf = torch.exp(_t_logpdf_uni(x, nu))
        x_new = x - f / torch.clamp_min(pdf, 1e-300)
        # strict bracket test: a converged lane's degenerate step
        # (x_new == x == hi) is not "bad"
        bad = (x_new < lo) | (x_new > hi) | ~torch.isfinite(x_new)
        x = torch.where(bad, 0.5 * (lo + hi), x_new)
    return x


class _TPpf(torch.autograd.Function):
    """T_nu^{-1}(u) with the implicit-function derivative 1/pdf(x) (the
    JAX package's custom JVP); nu is not differentiated."""

    @staticmethod
    def forward(u, nu):
        return _t_ppf_newton(u, nu)

    @staticmethod
    def setup_context(ctx, inputs, output):
        ctx.save_for_backward(output)
        ctx.nu = inputs[1]

    @staticmethod
    def backward(ctx, grad):
        (x,) = ctx.saved_tensors
        return grad / torch.exp(_t_logpdf_uni(x, ctx.nu)), None


def _t_ppf(u, nu):
    return _TPpf.apply(u, _param(nu, u))


def _t_logpdf_xy(x, y, rho, nu):
    """The t copula's log-density at quantiles x = T^{-1}(u), y =
    T^{-1}(v)."""
    rho, nu = _param(rho, x), _param(nu, x)
    r2 = rho * rho
    q = (x * x - 2.0 * rho * x * y + y * y) / (1.0 - r2)
    lg = torch.lgamma
    return (
        lg((nu + 2.0) / 2.0) + lg(nu / 2.0) - 2.0 * lg((nu + 1.0) / 2.0)
        - 0.5 * torch.log(1.0 - r2)
        - (nu + 2.0) / 2.0 * torch.log1p(q / nu)
        + (nu + 1.0) / 2.0 * (torch.log1p(x * x / nu)
                              + torch.log1p(y * y / nu))
    )


def _t_logpdf(u, v, rho, nu):
    return _t_logpdf_xy(_t_ppf(u, nu), _t_ppf(v, nu), rho, nu)


def _t_h(u, v, rho, nu):
    rho = _param(rho, u)
    x, y = _t_ppf(u, nu), _t_ppf(v, nu)
    scale = torch.sqrt((1.0 - rho * rho) * (nu + y * y) / (nu + 1.0))
    return _t_cdf((x - rho * y) / scale, nu + 1.0)


def _t_hinv(w, v, rho, nu):
    rho = _param(rho, w)
    y = _t_ppf(v, nu)
    scale = torch.sqrt((1.0 - rho * rho) * (nu + y * y) / (nu + 1.0))
    x = _t_ppf(w, nu + 1.0) * scale + rho * y
    return _t_cdf(x, nu)


def _debye1(t: float, n_grid: int = 200) -> float:
    """D1(t) = (1/t) int_0^t x/(e^x - 1) dx by a fixed trapezoid grid."""
    xs = np.linspace(1e-8, 1.0, n_grid) * t
    f = xs / np.expm1(xs)
    return float(np.sum(np.diff(xs) * (f[1:] + f[:-1]) / 2.0)) / t


def _frank_tau(th: float) -> float:
    return 1.0 - 4.0 / th * (1.0 - _debye1(th))


def _frank_theta_from_tau(tau: float, n_bisect: int = 60) -> float:
    """Invert tau(theta) by bisection (|theta| <= 50 covers |tau| < 0.94);
    host float64 arithmetic on one scalar."""
    at = abs(tau)
    lo, hi = 1e-4, 50.0
    for _ in range(n_bisect):
        mid = 0.5 * (lo + hi)
        if _frank_tau(mid) < at:
            lo = mid
        else:
            hi = mid
    return float(np.sign(tau)) * 0.5 * (lo + hi)


_H = {
    "gaussian": _gauss_h, "clayton": _clayton_h, "gumbel": _gumbel_h,
    "frank": _frank_h, "independent": lambda u, v, th: u,
}
_HINV = {
    "gaussian": _gauss_hinv, "clayton": _clayton_hinv,
    "gumbel": _gumbel_hinv, "frank": _frank_hinv,
    "independent": lambda w, v, th: w,
}
_LOGPDF = {
    "gaussian": _gauss_logpdf, "clayton": _clayton_logpdf,
    "gumbel": _gumbel_logpdf, "frank": _frank_logpdf,
    "independent": lambda u, v, th: torch.zeros_like(u),
}
# the base family's arguments for each rotation: (reflect u, reflect v)
_REFLECT = {0: (False, False), 90: (True, False), 180: (True, True),
            270: (False, True)}


def _reflect(u, flip: bool):
    return 1.0 - u if flip else u


def _install_rotations():
    """Derive the 90/180/270-degree rotated kernels from the base ones.

    With C_90(u,v) = v - C(1-u, v), C_180(u,v) = u + v - 1 + C(1-u, 1-v)
    (the survival copula) and C_270(u,v) = u - C(u, 1-v):

      h_90(u|v)  = 1 - h(1-u | v)        hinv_90(w|v)  = 1 - hinv(1-w | v)
      h_180(u|v) = 1 - h(1-u | 1-v)      hinv_180(w|v) = 1 - hinv(1-w | 1-v)
      h_270(u|v) = h(u | 1-v)            hinv_270(w|v) = hinv(w | 1-v)
      c_rot(u,v) = c(arguments reflected the same way)

    and tau_90 = tau_270 = -tau_base, tau_180 = tau_base.
    """
    for base in ("clayton", "gumbel"):
        h0, hinv0, lp0 = _H[base], _HINV[base], _LOGPDF[base]
        for rot, (fu, fv) in _REFLECT.items():
            if rot == 0:
                continue

            def h(u, v, th, h0=h0, fu=fu, fv=fv):
                out = h0(_reflect(u, fu), _reflect(v, fv), th)
                return 1.0 - out if fu else out

            def hinv(w, v, th, hinv0=hinv0, fu=fu, fv=fv):
                out = hinv0(_reflect(w, fu), _reflect(v, fv), th)
                return 1.0 - out if fu else out

            def lp(u, v, th, lp0=lp0, fu=fu, fv=fv):
                return lp0(_reflect(u, fu), _reflect(v, fv), th)

            name = f"{base}{rot}"
            _H[name], _HINV[name], _LOGPDF[name] = h, hinv, lp


_install_rotations()


def _install_t_families():
    """Register the Student-t grid families ("t3".."t15", theta = rho)."""
    for name, nu in _T_NU.items():
        _H[name] = lambda u, v, th, nu=nu: _t_h(u, v, th, nu)
        _HINV[name] = lambda w, v, th, nu=nu: _t_hinv(w, v, th, nu)
        _LOGPDF[name] = lambda u, v, th, nu=nu: _t_logpdf(u, v, th, nu)


_install_t_families()


def _split_rotation(family: str):
    """('clayton270') -> ('clayton', 270); base families -> (fam, 0)."""
    for rot in (90, 180, 270):
        s = str(rot)
        if family.endswith(s) and family[: -len(s)] in _H:
            return family[: -len(s)], rot
    return family, 0


def _theta_from_tau(family: str, tau: float):
    base, rot = _split_rotation(family)
    t = float(tau)
    if rot in (90, 270):
        t = -t  # the rotation's tau is the negated base tau
    if base == "gaussian" or base in _T_NU:
        # ellipticals share tau = (2/pi) arcsin(rho)
        return math.sin(math.pi * t / 2.0)
    if base == "clayton":
        # clayton models positive dependence; clamp away from 0
        return max(2.0 * t / max(1.0 - t, 1e-6), 1e-4)
    if base == "gumbel":
        return max(1.0 / max(1.0 - t, 1e-6), 1.0 + 1e-4)
    if base == "frank":
        return _frank_theta_from_tau(t)
    return 0.0


def _family_admissible(family: str, tau: float) -> bool:
    """Can ``family`` represent dependence of this sign at all?"""
    base, rot = _split_rotation(family)
    if base not in ("clayton", "gumbel"):
        return True
    if rot in (0, 180):
        return tau > 0.0
    return tau < 0.0


_GOLDEN = (math.sqrt(5.0) - 1.0) / 2.0
# the unconstrained parameterization z of each base family's theta: 0
# tanh (the ellipticals), 1 exp (clayton), 2 1 + exp (gumbel), 3 identity
# (frank), and the golden-section half-bracket around the tau-inversion
# start (frank's: max(2, 0.6 |z0|))
_TRANSFORM = {"gaussian": 0, "clayton": 1, "gumbel": 2, "frank": 3}
_SPAN = {0: 1.0, 1: 1.5, 2: 1.5}


def _transform_kind(family: str) -> int:
    base, _rot = _split_rotation(family)
    return 0 if base in _T_NU else _TRANSFORM[base]


def _from_theta(kind: int, th: float) -> float:
    if kind == 0:
        return float(np.arctanh(np.clip(th, -1 + 1e-7, 1 - 1e-7)))
    if kind == 1:
        return float(np.log(th))
    if kind == 2:
        return float(np.log(max(th - 1.0, 1e-8)))
    return float(th)


class _PairScorer:
    """Log-likelihood sums of one pair (u, v) under several families at
    once, for a (F,) tensor of parameters, without a synchronisation.

    The families are grouped: the t families share one quantile
    computation at the pair's setup (nu a (G, 1, 1) tensor, u and v
    stacked), and the rotations of one archimedean base one computation on
    the reflected arguments; gaussian and frank are groups of one."""

    def __init__(self, u, v, families):
        self.families = list(families)
        dev = u.device
        groups, where = {}, []
        for i, fam in enumerate(self.families):
            base, rot = _split_rotation(fam)
            key = "t" if base in _T_NU else base
            groups.setdefault(key, []).append((i, fam, rot))
        self._groups = []
        for key, members in groups.items():
            idx = torch.tensor([i for i, _f, _r in members], device=dev)
            where += [i for i, _f, _r in members]
            if key == "t":
                nu = torch.tensor([_T_NU[f] for _i, f, _r in members],
                                  dtype=u.dtype, device=dev)[:, None]
                xy = _t_ppf(torch.stack([u, v])[None], nu[:, :, None])
                data = (xy[:, 0], xy[:, 1], nu)
            else:
                data = (torch.stack([_reflect(u, _REFLECT[r][0])
                                     for _i, _f, r in members]),
                        torch.stack([_reflect(v, _REFLECT[r][1])
                                     for _i, _f, r in members]))
            self._groups.append((key, idx, data))
        self._order = torch.argsort(torch.tensor(where, device=dev))
        kinds = [_transform_kind(f) for f in self.families]
        self._kinds = torch.tensor(kinds, device=dev)

    def loglik(self, theta: torch.Tensor) -> torch.Tensor:
        """(F,) log-likelihood sums at parameters ``theta`` (F,)."""
        parts = []
        for key, idx, data in self._groups:
            th = theta[idx][:, None]
            if key == "t":
                lp = _t_logpdf_xy(data[0], data[1], th, data[2])
            else:
                lp = _LOGPDF[key](data[0], data[1], th)
            parts.append(lp.sum(dim=-1))
        return torch.cat(parts)[self._order]

    def to_theta(self, z: torch.Tensor) -> torch.Tensor:
        k = self._kinds
        ez = torch.exp(z)
        return torch.where(k == 0, torch.tanh(z),
                           torch.where(k == 1, ez,
                                       torch.where(k == 2, 1.0 + ez, z)))


def _mle_refine(scorer: _PairScorer, thetas0, n_steps: int = 40):
    """Maximize each family's pair log-likelihood over theta by
    golden-section search in the unconstrained z-space, bracketed around
    the tau-inversion start, every family in lockstep (``n_steps``
    halvings shrink a bracket by 0.618^40 ~ 4e-9). Returns (theta_hat,
    loglik_hat) as host lists."""
    kinds = [_transform_kind(f) for f in scorer.families]
    z0_host = [_from_theta(k, th) for k, th in zip(kinds, thetas0)]
    span_host = [_SPAN[k] if k != 3 else max(2.0, 0.6 * abs(z))
                 for k, z in zip(kinds, z0_host)]
    dev = scorer._kinds.device
    z0 = torch.tensor(z0_host, dtype=torch.float64, device=dev)
    span = torch.tensor(span_host, dtype=torch.float64, device=dev)

    def nll(z):
        return -scorer.loglik(scorer.to_theta(z))

    lo, hi = z0 - span, z0 + span
    for _ in range(n_steps):
        c = hi - _GOLDEN * (hi - lo)
        d = lo + _GOLDEN * (hi - lo)
        shrink_hi = nll(c) < nll(d)
        lo, hi = torch.where(shrink_hi, lo, c), torch.where(shrink_hi, d, hi)
    z_hat = 0.5 * (lo + hi)
    # keep the start if the search somehow did worse (bracket edge)
    z_hat = torch.where(nll(z_hat) < nll(z0), z_hat, z0)
    return (scorer.to_theta(z_hat).tolist(), (-nll(z_hat)).tolist())


def _fit_pair(u, v, families=FAMILIES, refine=False):
    """Fit each family by tau inversion; select by AIC (the one-parameter
    families pay a 1-nat penalty, the t grid 2). Rotated clayton/gumbel
    compete for their admissible tau sign (90/270: negative; base/180:
    positive).

    refine=True additionally maximizes each admissible family's
    log-likelihood over theta (golden-section MLE seeded by the tau
    inversion) and selects by the maximized AIC.

    Family selection is preceded by the Kendall-tau independence test
    (Dissmann et al. 2013): under independence tau is asymptotically
    N(0, 2(2n+5)/(9n(n-1))), and a noise-level tau is declared
    independent.
    """
    n = int(np.shape(u)[0])
    if n < 2:
        raise ValueError(
            f"pair-copula fitting needs at least 2 samples, got {n}"
        )
    tau = float(kendall_tau(u, v))
    tau_sd = math.sqrt(2.0 * (2 * n + 5) / (9.0 * n * (n - 1.0)))
    if abs(tau) < 1.96 * tau_sd:
        return "independent", 0.0, tau
    fams = [f for f in families
            if f != "independent" and _family_admissible(f, tau)]
    if not fams:
        return "independent", 0.0, tau
    u = as_tensor(u)
    v = as_tensor(v, device=u.device, dtype=u.dtype)
    thetas = [_theta_from_tau(f, tau) for f in fams]
    scorer = _PairScorer(u, v, fams)
    if refine:
        thetas, lls = _mle_refine(scorer, thetas)
    else:
        lls = scorer.loglik(torch.tensor(thetas, dtype=u.dtype,
                                         device=u.device)).tolist()
    best = ("independent", 0.0, 0.0)
    for fam, th, ll_raw in zip(fams, thetas, lls):
        # AIC penalty of k nats: 1 for the one-parameter families, 2 for
        # the Student-t grid (rho plus the df picked by the selection)
        k = 2.0 if _split_rotation(fam)[0] in _T_NU else 1.0
        ll = ll_raw - k
        if ll > best[1]:
            best = (fam, ll, th)
    return best[0], best[2], tau


class CVineCopula:
    """Canonical vine copula over empirical marginals.

    ``fit(samples)``: rank-transform each column to uniforms, order the
    variables by total |tau| (strongest-dependence root first), then fit
    tree after tree: tree t pairs the root-t variable with every later
    variable conditional on the first t-1 roots, conditioning via
    h-functions.

    ``sample(n, key)``: Aas et al. (2009) Algorithm 1 (independent
    uniforms pushed through inverse h-functions down the vine), then each
    uniform column is inverted through the stored empirical marginal.
    Everything stays on the samples' device.
    """

    def __init__(self, families=FAMILIES, refine=False):
        self.families = tuple(families)
        self.refine = bool(refine)

    def fit(self, samples, device=None):
        """Fit to (n, d) samples; numpy goes to ``device`` (default
        ``utils.device.default_device()``)."""
        x = as_tensor(samples, device=device)
        n, d = x.shape
        u = _pseudo_obs(x)

        # C-vine variable order: root = max sum |tau| against the rest
        taus = np.zeros((d, d))
        for i in range(d):
            for j in range(i + 1, d):
                taus[i, j] = taus[j, i] = float(
                    kendall_tau(u[:, i], u[:, j])
                )
        self.var_order = [int(i) for i in
                          np.argsort(-np.abs(taus).sum(axis=0))]
        v = u[:, self.var_order]

        # tree-by-tree pair fits; v[:, j] holds the pseudo-observations of
        # variable j conditional on roots 0..t-1
        self.pairs = []          # pairs[t][j] = (family, theta)
        for t in range(d - 1):
            row = []
            for j in range(t + 1, d):
                fam, th, _tau = _fit_pair(
                    v[:, j], v[:, t], families=self.families,
                    refine=self.refine,
                )
                row.append((fam, th))
            self.pairs.append(row)
            if t == d - 2:
                break
            # condition every later variable on the current root
            new_cols = [
                _H[row[j - t - 1][0]](v[:, j], v[:, t], row[j - t - 1][1])
                for j in range(t + 1, d)
            ]
            v = torch.cat([v[:, : t + 1], torch.stack(new_cols, dim=1)],
                          dim=1)
        self._marginals = torch.sort(x, dim=0).values
        self.n, self.d = n, d
        return self

    def sample_uniform(self, n_samples: int, key=0) -> torch.Tensor:
        """Uniform-scale samples (columns in the ORIGINAL variable order).

        Aas et al. (2009) Algorithm 1: keep cond[k] = F(x_k | x_0..x_{k-1});
        each new variable inverts the h-chain from its deepest tree up to
        tree 0, then its own conditional pseudo-observation is built by
        chaining h back down.
        """
        d = self.d
        w = _draw_uniform(key, (int(n_samples), d), torch.float64,
                          self._marginals.device)
        cols = [w[:, 0]]
        cond = [w[:, 0]]         # cond[k] = F(x_k | roots 0..k-1)
        for i in range(1, d):
            t_i = w[:, i]
            for k in range(i - 1, -1, -1):
                fam, th = self.pairs[k][i - k - 1]
                t_i = _HINV[fam](t_i, cond[k], th)
            cols.append(t_i)
            if i < d - 1:
                v = t_i
                for k in range(i):
                    fam, th = self.pairs[k][i - k - 1]
                    v = _H[fam](v, cond[k], th)
                cond.append(v)
        us = torch.stack(cols, dim=1)
        inv = np.argsort(self.var_order)
        return us[:, torch.as_tensor(inv, device=us.device)]

    def sample(self, n_samples: int, key=0) -> torch.Tensor:
        """Samples on the data scale via empirical-marginal inversion."""
        return _marginal_sample(self.sample_uniform(n_samples, key=key),
                                self.n, self._marginals)
