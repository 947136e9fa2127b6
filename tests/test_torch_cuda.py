"""The port's CUDA kernels on the card, against their plain versions.

Marked ``cuda``: they need an NVIDIA Hopper GPU and nvcc, and skip without
one. This file imports no JAX, so on a machine without JAX it runs with the
repo's conftest left out:

    python -m pytest -p no:cacheprovider --noconftest -m cuda tests/test_torch_cuda.py
"""
import pytest
import torch

from corrla_rs_tpu_torch.ops import rbf_kernels as rk

pytestmark = pytest.mark.cuda

PHIS = ["linear", "multiquadric", "cubic", "gaussian"]
# f32: elementwise ~40 ulp; matvec error against sum_j |phi_ij c_j|
KMAT_RTOL = {torch.float32: 5e-6, torch.float64: 1e-12}
MATVEC_RTOL = {torch.float32: 1e-4, torch.float64: 1e-12}


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", 0)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("phi", PHIS)
@pytest.mark.parametrize("na,nb,d", [(7, 13, 2), (1000, 1537, 3),
                                     (65, 64, 17)])
def test_kernel_matrix_matches_plain(dev, phi, dtype, na, nb, d):
    gen = torch.Generator(device=dev).manual_seed(na + nb + d)
    xa = torch.randn(na, d, generator=gen, device=dev, dtype=dtype)
    xb = torch.randn(nb, d, generator=gen, device=dev, dtype=dtype)
    before = rk.pairwise_kernel_matrix.launches
    got = rk.pairwise_kernel_matrix(xa, xb, phi, 0.7)
    torch.cuda.synchronize()
    assert rk.pairwise_kernel_matrix.launches == before + 1
    want = rk.pairwise_kernel_matrix_ref(xa.double(), xb.double(), phi, 0.7)
    err = (got.double() - want).abs()
    assert bool((err <= KMAT_RTOL[dtype] * (want.abs() + want.abs().max()))
                .all())


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("phi", PHIS)
@pytest.mark.parametrize("m,n,d,c", [(7, 13, 2, 1), (1000, 1537, 3, 8),
                                     (300, 200, 1, 37), (129, 65, 20, 20)])
def test_matvec_matches_plain(dev, phi, dtype, m, n, d, c):
    gen = torch.Generator(device=dev).manual_seed(m + n + d + c)
    q = torch.randn(m, d, generator=gen, device=dev, dtype=dtype)
    x = torch.randn(n, d, generator=gen, device=dev, dtype=dtype)
    coef = torch.randn(n, c, generator=gen, device=dev, dtype=dtype)
    before = rk.rbf_matvec.launches
    got = rk.rbf_matvec(q, x, coef, phi, 0.7)
    torch.cuda.synchronize()
    assert rk.rbf_matvec.launches == before + 1
    qd, xd, cd = q.double(), x.double(), coef.double()
    want = rk.rbf_matvec_ref(qd, xd, cd, phi, 0.7)
    scale = rk.rbf_matvec_ref(qd, xd, cd.abs(), phi, 0.7)
    assert bool(((got.double() - want).abs() <= MATVEC_RTOL[dtype] * scale)
                .all())


def test_matvec_is_deterministic(dev):
    gen = torch.Generator(device=dev).manual_seed(0)
    q, x = (torch.rand(n, 3, generator=gen, device=dev) for n in (5000, 3000))
    c = torch.randn(3000, 4, generator=gen, device=dev)
    first = rk.rbf_matvec(q, x, c, "cubic", 1.0)
    assert torch.equal(first, rk.rbf_matvec(q, x, c, "cubic", 1.0))


def test_kernel_matrix_diagonal_is_exact_zero(dev):
    x = torch.rand(300, 3, device=dev)
    k = rk.pairwise_kernel_matrix(x, x, "linear", 1.0)
    assert bool((torch.diagonal(k) == 0).all())


def test_refused_launch_raises(dev):
    # sizes the kernels cannot take are refused by the C side, and the
    # wrapper raises with CUDA's message; nothing is counted
    before = (rk.pairwise_kernel_matrix.launches, rk.rbf_matvec.launches)
    wide = torch.rand(100, 200, device=dev, dtype=torch.float64)   # d=200
    with pytest.raises(RuntimeError, match="invalid argument"):
        rk.rbf_matvec(wide, wide, torch.ones(100, 1, device=dev,
                                             dtype=torch.float64))
    xb = torch.rand(64 * 65535 + 1, 1, device=dev)   # one column tile too many
    with pytest.raises(RuntimeError, match="invalid argument"):
        rk.pairwise_kernel_matrix(torch.rand(1, 1, device=dev), xb)
    assert (rk.pairwise_kernel_matrix.launches,
            rk.rbf_matvec.launches) == before


def test_wrappers_raise_instead_of_falling_back(dev):
    x = torch.rand(10, 2, device=dev)
    with pytest.raises(ValueError, match="differ in dtype or device"):
        rk.rbf_matvec(x, x.cpu(), torch.ones(10, 1))
    with pytest.raises(ValueError, match="contiguous"):
        rk.pairwise_kernel_matrix(x, torch.rand(2, 10, device=dev).mT)
