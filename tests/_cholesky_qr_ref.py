"""The CholeskyQR round with a triangular solve over the panel's rows: the
reference that ``random_svd._cholesky_qr2``, which applies R^-1 as one
product, is held to on the CPU (``test_torch_random_svd.py``) and on the
card (``test_torch_cuda.py``). Imports no JAX.
"""
import torch

from bench_torch import rsvd_matrix


def solve_round_qr2(y: torch.Tensor) -> torch.Tensor:
    """Three CholeskyQR rounds with the ridges, ``tiny`` and the ridge
    choice of ``_cholesky_qr2``, each Cholesky its own call and each round
    ended by ``solve_triangular(r, ys, left=False)`` over the whole panel."""
    if y.dtype == torch.float32:
        eps_small, eps_big, tiny = 1e-7, 1e-2, 1e-30
    else:
        eps_small, eps_big, tiny = 1e-15, 1e-8, 1e-290
    eye = torch.eye(y.shape[-1], dtype=y.dtype, device=y.device)
    for _ in range(3):
        cn = torch.linalg.vector_norm(y, dim=-2, keepdim=True).clamp_min(tiny)
        ys = y / cn
        g = ys.mT @ ys
        r_small, info = torch.linalg.cholesky_ex(g + eps_small * eye,
                                                 upper=True)
        ok = (info == 0) & torch.isfinite(r_small).all(dim=(-2, -1))
        r_big, _ = torch.linalg.cholesky_ex(g + eps_big * eye, upper=True)
        r = torch.where(ok[..., None, None], r_small, r_big)
        y = torch.linalg.solve_triangular(r, ys, upper=True, left=False)
    return y


def panels(n: int, m: int, k: int, device, seed: int) -> dict:
    """Float32 panels of an RSVD's range finder on A (n, m) of 200 known
    sigma ``logspace(0, -3)`` (``bench_torch.rsvd_matrix``): the sketch
    A Omega (Omega (m, k) standard normal), and the same panel after one
    power step, A (A^T Y) over its Frobenius norm."""
    a, _ = rsvd_matrix(n, m, 200, device, seed)
    gen = torch.Generator(device=device).manual_seed(seed + 1)
    y = a @ torch.randn(m, k, generator=gen, device=device)
    y1 = a @ (a.mT @ y)
    return {"sketch": y, "power_step": y1 / torch.linalg.vector_norm(y1)}


def gaps(q: torch.Tensor, y: torch.Tensor, ref: torch.Tensor) -> dict:
    """In float64: max|Q^T Q - I|, max|Q Q^T Y - Y| / max|Y|, max|Q - ref|
    and cond(Y), the 2-norm condition number of the panel."""
    q, y, ref = q.double(), y.double(), ref.double()
    eye = torch.eye(q.shape[-1], dtype=q.dtype, device=q.device)
    s = torch.linalg.svdvals(y)
    return {"orth": float((q.mT @ q - eye).abs().max()),
            "recon": float((q @ (q.mT @ y) - y).abs().max()
                           / y.abs().max()),
            "to_ref": float((q - ref).abs().max()),
            "cond": float(s[0] / s[-1])}
