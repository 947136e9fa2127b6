"""Nonsymmetric eigendecomposition on the tensor's own device (real Schur QR).

Counterpart of ``corrla_rs_tpu/ops/eig_device.py``: the same algorithm in
plain PyTorch, complex-free (eigenvalues and eigenvectors come back as
separate real and imaginary parts), on whatever device the input lies on.

- ``hessenberg``: Householder reduction to upper Hessenberg form.
- ``schur``: real Schur form by the implicit Francis double-shift QR with
  bulge chasing, exceptional shifts every 10 stalled sweeps, 2x2 diagonal
  blocks left unstandardised (LAPACK dlahqr's family).
- ``eigvals_device``: eigenvalues of the quasi-triangular Schur factor, after
  exact power-of-two balancing; NaN where the iteration did not converge.
- ``eig_device``: eigenvalues and right eigenvectors; the vectors come from
  two rounds of inverse iteration on the real 2n x 2n embedding of the
  complex shifted system, one batched LU factorisation for both rounds, with
  a masked Gram-Schmidt among eigenvalue-cluster members between them.

Every function works on a (B, n, n) stack at once, where the JAX package
vmaps: each matrix keeps its own active window, sweep and stall counts as
(B,) tensors, and a matrix whose iteration has ended (all deflated, or
``max_iters`` reached) is frozen under a mask, so its result is the one it
would have on its own. How JAX's traced loops become eager PyTorch:

- ``lax.while_loop`` over sweeps is a host loop. Each round runs up to
  ``_DEFLATIONS`` deflation checks (cheap (B,) work) and then one sweep for
  the matrices whose window still holds three or more rows; every matrix
  thus goes through JAX's sequence of deflations and sweeps, with JAX's
  iteration count against ``max_iters``. The host reads "has every matrix
  ended" and the largest active row every ``_CHECK_EVERY`` rounds, one
  device sync each time, never one a chase step. A round updates the state
  in place, so on CUDA it is captured once as a CUDA graph (one for each
  bucket of chase steps) and replayed: its hundreds of small launches would
  otherwise be bound by their host cost.
- The chase's ``dynamic_slice`` updates: the chase step k runs over fixed
  bounds (a Python int, the same rows and columns for every matrix, so the
  3-row and 3-column updates are plain slices), with the steps outside a
  matrix's window [lo..p) masked to identity reflectors (beta = 0), as in
  JAX. Steps at or beyond the largest active row of the last read are
  masked for every matrix and are not run.
- Per-matrix scalar reads and writes (the shifts, the zeroed subdiagonal at
  the window's start) are gathers and scatters on index tensors.

Intended regime: the small dense matrices the library eigensolves (DMDc's
r x r operator, bagged DMD's members). The iteration is sequential: O(n)
sweeps of O(n) chase steps, each a handful of small launches on a GPU.
"""
from __future__ import annotations

import torch

from corrla_rs_tpu_torch.utils.device import as_tensor

__all__ = ["hessenberg", "schur", "eigvals_device", "eig_device"]

# deflation checks a round before its sweep (a sweep usually deflates one
# eigenvalue or a 2x2 block)
_DEFLATIONS = 2
# rounds between two reads of "has every matrix ended"
_CHECK_EVERY = 4
# chase steps a CUDA graph of a round is captured for: a round replays the
# graph of the next multiple at or above its steps
_GRAPH_STEPS = 16


def _eps(dtype) -> float:
    return float(torch.finfo(dtype).eps)


def _tiny(dtype) -> float:
    return float(torch.finfo(dtype).tiny)


def _stacked(a, device):
    """(B, n, n) tensor of ``a`` and whether ``a`` was a single matrix."""
    a = as_tensor(a, device=device)
    if a.ndim not in (2, 3) or a.shape[-1] != a.shape[-2]:
        raise ValueError(f"expected a square matrix or a stack of them, got "
                         f"shape {tuple(a.shape)}")
    return (a[None], True) if a.ndim == 2 else (a, False)


def _bmv(m, v):
    """Batched m @ v for m (B, r, c), v (B, c): (B, r)."""
    return torch.bmm(m, v[:, :, None])[:, :, 0]


def _bvm(v, m):
    """Batched v @ m for v (B, r), m (B, r, c): (B, c)."""
    return torch.bmm(v[:, None, :], m)[:, 0, :]


# ---------------------------------------------------------------------------
# Hessenberg reduction

def _hessenberg(a: torch.Tensor):
    """(h, q) of a (B, n, n) stack, n > 2."""
    bsz, n, _ = a.shape
    dtype = a.dtype
    tiny = _tiny(dtype)
    idx = torch.arange(n, device=a.device)
    h = a.clone()
    q = torch.eye(n, dtype=dtype, device=a.device).expand(bsz, n, n).clone()
    for k in range(n - 2):
        col = h[:, :, k]
        xm = torch.where(idx >= k + 1, col, 0.0)
        sigma = torch.linalg.vector_norm(xm, dim=1)
        alpha = torch.where(col[:, k + 1] >= 0, -sigma, sigma)
        v = xm.clone()
        v[:, k + 1] -= alpha
        vn = torch.linalg.vector_norm(v, dim=1, keepdim=True)
        v = torch.where(vn > tiny, v / torch.clamp_min(vn, tiny), 0.0)
        # P = I - 2 v v^T: similarity P H P and accumulation Q P
        v2 = 2.0 * v
        h.addcmul_(v2[:, :, None], _bvm(v, h)[:, None, :], value=-1.0)
        h.addcmul_(_bmv(h, v)[:, :, None], v2[:, None, :], value=-1.0)
        q.addcmul_(_bmv(q, v)[:, :, None], v2[:, None, :], value=-1.0)
    # exact Hessenberg structure (below the subdiagonal only the residue of
    # the reflectors' arithmetic is left)
    return h.masked_fill_(idx[:, None] > idx[None, :] + 1, 0.0), q


def hessenberg(a, device=None):
    """Reduce a real square matrix (or a (B, n, n) stack) to upper
    Hessenberg form. Returns ``(h, q)`` with ``q @ h @ q.T == a`` and ``q``
    orthogonal: one Householder reflector a column, applied as rank-1
    updates."""
    a, single = _stacked(a, device)
    n = a.shape[-1]
    if n <= 2:
        h = a.clone()
        q = torch.eye(n, dtype=a.dtype, device=a.device).expand_as(a).clone()
    else:
        h, q = _hessenberg(a)
    return (h[0], q[0]) if single else (h, q)


# ---------------------------------------------------------------------------
# Francis double-shift QR -> real Schur form

def _house3(xyz: torch.Tensor, live: torch.Tensor):
    """3-element Householder reflectors of the rows of ``xyz`` (B, 3):
    (v (B, 3), beta (B,)) with P = I - beta v v^T mapping [x, y, z] to
    [~, 0, 0]; beta = 0 (P = I) where ``live`` is False, and where x = y =
    z = 0. z == 0 gives v[2] == 0, so P leaves the third row alone."""
    tiny = _tiny(xyz.dtype)
    # scale to avoid overflow in the squares
    scale = torch.clamp_min(xyz.abs().sum(1, keepdim=True), tiny)
    xs = xyz / scale
    s = torch.sqrt((xs * xs).sum(1))
    v = xs.clone()
    v[:, 0] += torch.where(xs[:, 0] >= 0, s, -s)       # xs - alpha
    vn2 = (v * v).sum(1)
    beta = torch.where(live & (vn2 > tiny),
                       2.0 / torch.clamp_min(vn2, tiny), 0.0)
    return v, beta


def _window(h: torch.Tensor, hi: torch.Tensor, eps: float, i1: torch.Tensor):
    """lo, the start of the active window [lo..hi] of each matrix: the
    largest l <= hi whose subdiagonal h[l, l-1] is negligible (0 if none),
    with an Ahues-Tisseur-style test floored at eps (h is pre-scaled to
    about unit norm). ``i1`` is arange(1, n + 2)."""
    d = torch.diagonal(h, dim1=1, dim2=2).abs()
    sub = torch.diagonal(h, offset=-1, dim1=1, dim2=2).abs()
    neg = sub <= eps * torch.clamp_min(d[:, :-1] + d[:, 1:], 0.1)
    return torch.where((i1 <= hi[:, None]) & neg, i1, 0).amax(1)


def _zero_below_start(hf: torch.Tensor, lo: torch.Tensor, where: torch.Tensor,
                      n2: int) -> None:
    """h[lo, lo-1] = 0 for the matrices where ``where`` holds and lo >= 1
    (``hf`` is h flattened to (B, n2 * n2), a view)."""
    ix = (lo * n2 + torch.clamp_min(lo - 1, 0))[:, None]
    hf.scatter_(1, ix, torch.where((where & (lo >= 1))[:, None], 0.0,
                                   hf.gather(1, ix)))


class _Francis:
    """The Francis iteration's state on a (B, n, n) stack, n > 2, and one
    round of it, which updates the state in place.

    h (rows :n2) and q (rows n2:) live in one array, padded by 2 columns
    (and h by 2 rows) so the chase needs no boundary cases: the reads beyond
    the window are structural zeros and the reflector's third component
    degenerates to zero there; a right application updates both at once.
    hi (the window's end), it (rounds counted as JAX counts iterations) and
    stall (sweeps since the last deflation) are (B,) tensors.
    """

    def __init__(self, h0: torch.Tensor, q0: torch.Tensor, max_iters: int):
        bsz, n, _ = h0.shape
        dev = h0.device
        self.n, self.n2, self.max_iters = n, n + 2, max_iters
        self.eps = _eps(h0.dtype)
        self.hq = torch.zeros((bsz, 2 * n + 2, n + 2), dtype=h0.dtype,
                              device=dev)
        self.hq[:, :n, :n] = h0
        self.hq[:, n + 2:, :n] = q0
        self.h = self.hq[:, :n + 2]
        self.hf = self.h.view(bsz, (n + 2) ** 2)
        idx = torch.arange(n + 2, device=dev)
        self.below = idx[:, None] > idx[None, :] + 1
        self.i1 = idx[1:]
        self.ks = torch.arange(n - 1, device=dev)
        self.hi = torch.full((bsz,), n - 1, dtype=torch.long, device=dev)
        self.it = torch.zeros_like(self.hi)
        self.stall = torch.zeros_like(self.hi)

    def active(self) -> torch.Tensor:
        return (self.hi >= 1) & (self.it < self.max_iters)

    def round(self, steps: int) -> None:
        """Up to ``_DEFLATIONS`` deflations, then one double-shift sweep of
        the matrices whose window still holds three or more rows; the chase
        runs its first ``steps`` steps (at least the largest window's end)."""
        h, hf, n2, eps, hi = self.h, self.hf, self.n2, self.eps, self.hi
        for _ in range(_DEFLATIONS):
            lo = _window(h, hi, eps, self.i1)
            defl = self.active() & (hi - lo <= 1)
            _zero_below_start(hf, lo, defl, n2)
            hi.copy_(torch.where(defl, lo - 1, hi))
            self.stall.masked_fill_(defl, 0)
            self.it.add_(defl)
        p = hi
        lo = _window(h, p, eps, self.i1)
        sweep = self.active() & (p - lo >= 2)
        _zero_below_start(hf, lo, sweep, n2)
        # Francis shift from the trailing 2x2 of the window, and the first
        # column of the double-shift polynomial from its leading 3x2
        pc = torch.clamp_min(p, 1)           # a window's end, or any row
        r0, r1 = (pc - 1) * n2, pc * n2
        l0, l1, l2 = lo * n2, (lo + 1) * n2, (lo + 2) * n2
        g = hf.gather(1, torch.stack(
            [r0 + pc - 1, r0 + pc, r1 + pc - 1, r1 + pc, l0 + lo, l0 + lo + 1,
             l1 + lo, l1 + lo + 1, l2 + lo + 1], 1))
        h11, h12, h21, h22, a00, a01, a10, a11, a21 = g.unbind(1)
        s = h11 + h22
        t = h11 * h22 - h12 * h21
        # exceptional shift every 10 stalled sweeps (dlahqr-style)
        exc = (self.stall > 0) & (self.stall % 10 == 0)
        s1 = 0.75 * torch.abs(h21) + h22
        s = torch.where(exc, 2.0 * s1, s)
        t = torch.where(exc, s1 * s1, t)
        first = torch.stack([a00 * a00 + a01 * a10 - s * a00 + t,
                             a10 * (a00 + a11 - s), a10 * a21], 1)
        # the chase: step k is live for the matrices that sweep with
        # lo <= k < p; the steps at or past every active row do nothing
        ks = self.ks[:steps]
        at_lo = ks == lo[:, None]
        live = sweep[:, None] & (ks >= lo[:, None]) & (ks < p[:, None])
        hq = self.hq
        for k in range(steps):
            xyz = torch.where(at_lo[:, k, None], first, h[:, k:k + 3, k - 1])
            v, beta = _house3(xyz, live[:, k])
            bv = beta[:, None] * v
            rows = h[:, k:k + 3, :]
            rows.addcmul_(bv[:, :, None], _bvm(v, rows)[:, None, :],
                          value=-1.0)
            cols = hq[:, :, k:k + 3]
            cols.addcmul_(_bmv(cols, v)[:, :, None], bv[:, None, :],
                          value=-1.0)
        # the chase leaves O(eps) residue below the subdiagonal
        h.masked_fill_(self.below, 0.0)
        self.stall.add_(sweep)
        self.it.add_(sweep)


def _iterate(state: _Francis) -> None:
    """Rounds until every matrix has ended, read every ``_CHECK_EVERY``
    rounds. On CUDA the rounds replay CUDA graphs, one for each bucket of
    ``_GRAPH_STEPS`` chase steps (a round is hundreds of small launches, so
    their host cost would bound it); the first round runs eagerly on a side
    stream, as the warm-up before the first capture."""
    n = state.n
    cuda = state.hq.device.type == "cuda"
    graphs: dict = {}
    warm = False
    hi_max, rounds = n - 1, 0
    while True:
        if rounds % _CHECK_EVERY == 0:
            live_any, hi_max = torch.stack(
                [state.active().any().long(), state.hi.max()]).tolist()
            if not live_any:
                return
        rounds += 1
        steps = min(n - 1, hi_max)
        if not cuda:
            state.round(steps)
        elif not warm:
            side = torch.cuda.Stream(device=state.hq.device)
            side.wait_stream(torch.cuda.current_stream(state.hq.device))
            with torch.cuda.stream(side):
                state.round(steps)
            torch.cuda.current_stream(state.hq.device).wait_stream(side)
            warm = True
        else:
            bucket = min(n - 1, -(-steps // _GRAPH_STEPS) * _GRAPH_STEPS)
            graph = graphs.get(bucket)
            if graph is None:
                graph = graphs[bucket] = torch.cuda.CUDAGraph()
                with torch.cuda.graph(graph):
                    state.round(bucket)
            graph.replay()


def _schur(a: torch.Tensor, max_iters: int):
    """(t, q, converged) of a (B, n, n) stack, n > 2."""
    n = a.shape[-1]
    eps = _eps(a.dtype)
    # pre-scale so the squares in the shift and reflector arithmetic cannot
    # overflow
    safe = torch.clamp_min(a.abs().amax((1, 2)), _tiny(a.dtype))[:, None, None]
    state = _Francis(*_hessenberg(a / safe), max_iters)
    _iterate(state)
    t = state.h[:, :n, :n].clone()
    # zero any remaining negligible subdiagonal (deflation zeroes only the
    # entry it split at; others may hold O(eps) residue that
    # _eigvals_from_schur would read as 2x2 blocks)
    d = torch.diagonal(t, dim1=1, dim2=2).abs()
    sub = torch.diagonal(t, offset=-1, dim1=1, dim2=2)
    neg = sub.abs() <= eps * torch.clamp_min(d[:, :-1] + d[:, 1:], 0.1)
    sub.masked_fill_(neg, 0.0)
    return t * safe, state.hq[:, n + 2:, :n].clone(), state.hi < 1


def _schur_stack(a: torch.Tensor, max_iters):
    bsz, n, _ = a.shape
    if n == 1:
        return (a.clone(), torch.ones_like(a),
                torch.ones(bsz, dtype=torch.bool, device=a.device))
    if max_iters is None:
        max_iters = 40 * n
    if n == 2:
        safe = torch.clamp_min(a.abs().amax((1, 2)),
                               _tiny(a.dtype))[:, None, None]
        return (a / safe * safe, torch.eye(2, dtype=a.dtype, device=a.device)
                .expand_as(a).clone(),
                torch.ones(bsz, dtype=torch.bool, device=a.device))
    return _schur(a, int(max_iters))


def schur(a, max_iters: int | None = None, device=None):
    """Real Schur decomposition ``a = q @ t @ q.T`` (q orthogonal, t
    quasi-upper-triangular with 1x1 and 2x2 diagonal blocks) of a real
    square matrix or a (B, n, n) stack.

    Implicit Francis double-shift QR with bulge chasing on the Hessenberg
    form; exceptional shifts every 10 stalled sweeps break the rare cycles,
    as in LAPACK dlahqr. A terminal 2x2 window is accepted as a block
    whether its eigenvalues are real or complex (``eigvals_device`` resolves
    both), the only deviation from LAPACK's convention, which splits real
    pairs.

    Returns ``(t, q, converged)``; ``converged`` is a bool tensor (one a
    matrix for a stack), False only where ``max_iters`` rounds (default
    40 n) did not deflate every eigenvalue.
    """
    a, single = _stacked(a, device)
    t, q, ok = _schur_stack(a, max_iters)
    return (t[0], q[0], ok[0]) if single else (t, q, ok)


# ---------------------------------------------------------------------------
# Eigenvalues from the quasi-triangular factor

def _eigvals_from_schur(t: torch.Tensor):
    """(lam_re, lam_im) of a (B, n, n) quasi-upper-triangular stack: 1x1
    blocks directly, 2x2 blocks (a nonzero subdiagonal entry) by the
    quadratic formula (real roots where the discriminant is >= 0, a
    conjugate pair otherwise)."""
    n = t.shape[-1]
    d = torch.diagonal(t, dim1=1, dim2=2)
    if n == 1:
        return d.clone(), torch.zeros_like(d)
    sub = torch.diagonal(t, offset=-1, dim1=1, dim2=2)     # t[i+1, i]
    no = torch.zeros_like(d[:, :1], dtype=torch.bool)
    zero = torch.zeros_like(d[:, :1])
    is_start = torch.cat([sub != 0, no], 1)
    # a block start cannot immediately follow another block start
    is_start = is_start & ~torch.cat([no, is_start[:, :-1]], 1)
    is_second = torch.cat([no, is_start[:, :-1]], 1)

    up = torch.cat([torch.diagonal(t, offset=1, dim1=1, dim2=2), zero], 1)
    dn = torch.cat([d[:, 1:], zero], 1)
    sb = torch.cat([sub, zero], 1)
    # block at i: [[d_i, up_i], [sb_i, dn_i]]
    m = 0.5 * (d + dn)
    disc = 0.25 * (d - dn) ** 2 + up * sb
    root = torch.sqrt(torch.abs(disc))
    real_pair = disc >= 0
    re_start = torch.where(real_pair, m + root, m)
    im_start = torch.where(real_pair, 0.0, root)
    # the second root lands on index i + 1
    re_second = torch.cat([zero, torch.where(real_pair, m - root, m)[:, :-1]],
                          1)
    im_second = torch.cat([zero, torch.where(real_pair, 0.0, -root)[:, :-1]],
                          1)
    lam_re = torch.where(is_start, re_start,
                         torch.where(is_second, re_second, d))
    lam_im = torch.where(is_start, im_start,
                         torch.where(is_second, im_second, 0.0))
    return lam_re, lam_im


def _balance(a: torch.Tensor, n_sweeps: int = 5):
    """Diagonal balancing D^-1 A D of a (B, n, n) stack (LAPACK xGEBAL's
    diagonal stage, all rows at once): off-diagonal row and column 1-norms
    equalised by power-of-two factors, exact in binary floating point.
    Returns ``(a_balanced, d)`` with ``a = diag(d) a_b diag(1/d)``."""
    n = a.shape[-1]
    off = 1.0 - torch.eye(n, dtype=a.dtype, device=a.device)
    ab = a
    d = torch.ones(a.shape[:-1], dtype=a.dtype, device=a.device)
    for _ in range(n_sweeps):
        absa = torch.abs(ab) * off
        r = absa.sum(2)        # row norms
        c = absa.sum(1)        # column norms
        ok = (r > 0) & (c > 0)
        f = torch.where(ok, torch.sqrt(torch.where(
            ok, r / torch.clamp_min(c, 1e-300), 1.0)), 1.0)
        # the nearest power of two, clamped: exact rescaling only
        f = torch.exp2(torch.clamp(torch.round(torch.log2(f)), -32, 32))
        ab = ab / f[:, :, None] * f[:, None, :]
        d = d * f
    return ab, d


def _eigvals_stack(a: torch.Tensor, max_iters, balance: bool):
    if balance:
        a, _ = _balance(a)
    t, _, ok = _schur_stack(a, max_iters)
    lam_re, lam_im = _eigvals_from_schur(t)
    # non-convergence must not return plausible garbage: NaN instead
    ok = ok[:, None]
    return (torch.where(ok, lam_re, float("nan")),
            torch.where(ok, lam_im, float("nan")))


def eigvals_device(a, max_iters: int | None = None, balance: bool = True,
                   device=None):
    """Eigenvalues of a real square matrix as ``(lam_re, lam_im)`` real
    tensors on its device, complex-free; a (B, n, n) stack gives (B, n).
    Pair with ``eig_device`` when eigenvectors are needed.

    balance=True (default, like LAPACK xGEEV) applies exact power-of-two
    diagonal balancing before the QR iteration: essential for graded
    matrices (entries spanning orders of magnitude), free otherwise. A
    matrix whose iteration did not converge in ``max_iters`` rounds gets
    NaN eigenvalues.
    """
    a, single = _stacked(a, device)
    lam_re, lam_im = _eigvals_stack(a, max_iters, balance)
    return (lam_re[0], lam_im[0]) if single else (lam_re, lam_im)


# ---------------------------------------------------------------------------
# Eigenvectors by batched inverse iteration (real embedding of C^n)

def _cluster_orthogonalize(vr, vi, lam_re, lam_im, thr):
    """Masked modified Gram-Schmidt among eigenvalue-cluster members, for
    (B, n, n) stacks ``vr``/``vi`` holding eigenvector j in ROW j.

    For each j in turn, the complex projections onto every EARLIER vector
    whose eigenvalue lies within ``thr`` of lambda_j are subtracted. Inverse
    iteration returns nearly identical vectors for clustered eigenvalues;
    orthogonalising between solve rounds re-seeds each later member with
    the orthogonal complement, which the next solve amplifies back into the
    cluster's invariant subspace: an orthonormal basis of it for a
    semisimple cluster, the dominant invariant subspace for a defective
    one.
    """
    n = vr.shape[1]
    d2 = ((lam_re[:, :, None] - lam_re[:, None, :]) ** 2
          + (lam_im[:, :, None] - lam_im[:, None, :]) ** 2)
    close = (d2 <= thr * thr).to(vr.dtype)
    tiny = _tiny(vr.dtype)
    vr, vi = vr.clone(), vi.clone()
    for j in range(n):
        mask = close[:, :j, j]                            # (B, j)
        pr, pi = vr[:, :j], vi[:, :j]
        rj, ij = vr[:, j], vi[:, j]
        # complex coefficients c_i = <v_i, v_j> over the earlier rows
        cr = (_bmv(pr, rj) + _bmv(pi, ij)) * mask
        ci = (_bmv(pr, ij) - _bmv(pi, rj)) * mask
        new_r = rj - (_bvm(cr, pr) - _bvm(ci, pi))
        new_i = ij - (_bvm(cr, pi) + _bvm(ci, pr))
        nrm = torch.sqrt((new_r * new_r + new_i * new_i).sum(1, keepdim=True))
        scale = 1.0 / torch.clamp_min(nrm, tiny)
        vr[:, j] = new_r * scale
        vi[:, j] = new_i * scale
    return vr, vi


def _inverse_iteration(a, lam_re, lam_im):
    """Unit right eigenvectors (v_re, v_im), in columns, of a (B, n, n)
    stack for the given eigenvalues (B, n)."""
    bsz, n, _ = a.shape
    dtype, dev = a.dtype, a.device
    eps, tiny = _eps(dtype), _tiny(dtype)
    anorm = torch.clamp_min(a.abs().amax((1, 2)), 1.0)        # (B,)
    # the shift is perturbed off exact singularity (xHSEIN does the same):
    # an O(eps ||A||) relative shift changes the eigenvector by O(eps/gap).
    # The per-row jitter (2 + j % 7) keeps exact duplicate eigenvalues from
    # giving bit-identical singular systems
    j = torch.arange(n, dtype=dtype, device=dev)
    delta = eps * anorm[:, None] * (2.0 + j % 7.0)
    lr = lam_re + delta

    # (A - l I)(vr + i vi) = b  <=>  [[A - lr, li], [-li, A - lr]] [vr; vi]
    eye = torch.eye(n, dtype=dtype, device=dev)
    m11 = a[:, None] - lr[:, :, None, None] * eye
    m12 = lam_im[:, :, None, None] * eye
    ms = torch.cat([torch.cat([m11, m12], 3), torch.cat([-m12, m11], 3)], 2)
    lu, piv = torch.linalg.lu_factor(ms.reshape(bsz * n, 2 * n, 2 * n))

    # deterministic non-degenerate starts; the imaginary part is zero for
    # real eigenvalues so their eigenvectors come out real
    br = torch.sin(1.7 * j[None, :] + 0.9 * j[:, None] + 0.3)
    bi = torch.cos(1.3 * j[None, :] + 0.7 * j[:, None] + 0.1)
    bi = torch.where((lam_im == 0)[:, :, None], 0.0, bi)
    b = torch.cat([br.expand(bsz, n, n), bi], 2)             # (B, n, 2n)

    def normalize(v):
        vr, vi = v[..., :n], v[..., n:]
        nrm = torch.sqrt((vr * vr + vi * vi).sum(-1, keepdim=True))
        return v / torch.clamp_min(nrm, tiny)

    def solve_step(v):
        """One shifted solve; rows whose near-singular system overflowed to
        non-finite keep their previous iterate."""
        sol = torch.linalg.lu_solve(
            lu, piv, normalize(v).reshape(bsz * n, 2 * n, 1)).reshape(
                bsz, n, 2 * n)
        sol = sol / torch.clamp_min(sol.abs().amax(-1, keepdim=True), tiny)
        ok = torch.isfinite(sol).all(-1, keepdim=True)
        return torch.where(ok, sol, normalize(v))

    # cluster radius RELATIVE to the eigenvalue magnitudes (an absolute
    # ||A||-scaled radius would lump every small eigenvalue of a graded
    # spectrum into one cluster), floored near zero at the QR-split scale
    # of a multiple zero eigenvalue
    lam_mag = torch.sqrt(lam_re ** 2 + lam_im ** 2)
    scale_ij = torch.maximum(
        torch.maximum(lam_mag[:, :, None], lam_mag[:, None, :]),
        (eps ** 0.5 * anorm)[:, None, None])
    cluster_thr = 16.0 * eps ** 0.5 * scale_ij

    def orth(v):
        v = normalize(v)
        wr, wi = _cluster_orthogonalize(v[..., :n], v[..., n:], lam_re,
                                        lam_im, cluster_thr)
        return torch.cat([wr, wi], 2)

    def resid(v):
        """||A v_j - lambda_j v_j||_2 of each row vector."""
        vr, vi = v[..., :n], v[..., n:]
        lre, lim = lam_re[:, :, None], lam_im[:, :, None]
        ar = vr @ a.mT - (lre * vr - lim * vi)
        ai = vi @ a.mT - (lre * vi + lim * vr)
        return torch.sqrt((ar * ar + ai * ai).sum(-1))

    # a shared first solve; then a plain second round (xHSEIN's) and an
    # orthogonalised one. Orthogonalising is valid for SEMISIMPLE clusters
    # only (a defective eigenvalue has no eigenbasis), so each vector keeps
    # the orthogonalised version only where its residual stays small
    v1 = solve_step(b)
    v_plain = normalize(solve_step(v1))
    v_orth = normalize(orth(solve_step(orth(v1))))
    accept = resid(v_orth) <= torch.maximum(
        100.0 * resid(v_plain), (eps ** 0.5 * anorm)[:, None])
    v = torch.where(accept[:, :, None], v_orth, v_plain)
    vr, vi = v[..., :n], v[..., n:]

    # fix the phase: each vector rotated so its largest component is real
    # and positive (real eigenvectors stay real up to sign)
    k = torch.argmax(vr * vr + vi * vi, dim=-1, keepdim=True)
    pr, pi = vr.gather(-1, k), vi.gather(-1, k)
    pn = torch.clamp_min(torch.sqrt(pr * pr + pi * pi), tiny)
    cr, ci = pr / pn, -pi / pn                                # conj(phase)
    wr = cr * vr - ci * vi
    wi = cr * vi + ci * vr
    # columns are eigenvectors (numpy layout)
    return wr.mT, wi.mT


def eig_device(a, max_iters: int | None = None, balance: bool = True,
               device=None):
    """Eigenvalues and right eigenvectors of a real square matrix on its
    device, complex-free.

    Returns ``(lam_re, lam_im, v_re, v_im)`` with eigenvectors in columns
    (``v[:, j]`` belongs to ``lam[j]``, numpy layout), unit 2-norm, phase
    fixed so the largest component is real-positive. A (B, n, n) stack gives
    (B, n) and (B, n, n) results.

    The vectors come from two rounds of inverse iteration on the ORIGINAL A
    (balancing only sharpens the eigenvalues that feed it), each round a
    solve with one LU factorisation of the (n, 2n, 2n) real embeddings. For
    eigenvalue clusters tighter than about eps ||A|| / gap the vectors may
    be nearly dependent, the standard inverse-iteration caveat.
    """
    a, single = _stacked(a, device)
    lam_re, lam_im = _eigvals_stack(a, max_iters, balance)
    v_re, v_im = _inverse_iteration(a, lam_re, lam_im)
    out = (lam_re, lam_im, v_re, v_im)
    return tuple(x[0] for x in out) if single else out
