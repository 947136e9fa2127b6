"""The port's CUDA kernels on the card, against their plain versions.

Marked ``cuda``: they need an NVIDIA Hopper GPU and nvcc, and skip without
one. This file imports no JAX, so on a machine without JAX it runs with the
repo's conftest left out:

    python -m pytest -p no:cacheprovider --noconftest -m cuda tests/test_torch_cuda.py
"""
import pytest
import torch

from corrla_rs_tpu_torch.ops import rbf_kernels as rk
from corrla_rs_tpu_torch.ops._build import load_library

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


def _check_matvec(dev, phi, dtype, m, n, d, c):
    """One launch of the matvec against the plain version in f64; returns
    the launch plan."""
    gen = torch.Generator(device=dev).manual_seed(m + n + d + c)
    q = torch.randn(m, d, generator=gen, device=dev, dtype=dtype)
    x = torch.randn(n, d, generator=gen, device=dev, dtype=dtype)
    coef = torch.randn(n, c, generator=gen, device=dev, dtype=dtype)
    before = rk.rbf_matvec.launches
    got = rk.rbf_matvec(q, x, coef, phi, 0.7)
    torch.cuda.synchronize()
    assert rk.rbf_matvec.launches == before + 1
    assert got.shape == (m, c) and got.dtype == dtype
    qd, xd, cd = q.double(), x.double(), coef.double()
    want = rk.rbf_matvec_ref(qd, xd, cd, phi, 0.7)
    scale = rk.rbf_matvec_ref(qd, xd, cd.abs(), phi, 0.7)
    assert bool(((got.double() - want).abs() <= MATVEC_RTOL[dtype] * scale)
                .all())
    return rk._matvec_plan(m, n, c, rk._sm_count(q.device),
                           q.element_size())


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("phi", PHIS)
@pytest.mark.parametrize("m,n,d,c", [(7, 13, 2, 1), (1000, 1537, 3, 8),
                                     (300, 200, 1, 37), (129, 65, 20, 20)])
def test_matvec_matches_plain(dev, phi, dtype, m, n, d, c):
    _check_matvec(dev, phi, dtype, m, n, d, c)


# every instance: d = 1..4 templated, 5, 11 and 20 the runtime loop; each
# column chunk width, several chunks, and C past 32
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("phi", PHIS)
@pytest.mark.parametrize("d", [1, 2, 3, 4, 5, 11, 20])
@pytest.mark.parametrize("c", [1, 3, 8, 20, 33, 100])
def test_matvec_every_instance_matches_plain(dev, phi, dtype, d, c):
    _check_matvec(dev, phi, dtype, 600, 777, d, c)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("phi", PHIS)
@pytest.mark.parametrize("m,n,d,c,split", [
    (1, 13, 3, 1, True),            # one query, less than a tile
    (7, 1, 2, 4, False),            # one support point
    (7, 13, 1, 20, True),           # fewer queries than a thread holds
    (1, 100_000, 3, 1, True),       # one query, long support
    (512, 2000, 1, 20, True),       # PodI predict; 2000 not a multiple
    (70, 5000, 11, 3, True),        # runtime d, split
    (264 * 512, 100, 2, 1, False),  # the grid fills the card: no split
], ids=["1x13", "7x1", "7x13", "1x100k", "podi", "d11", "nosplit"])
def test_matvec_edge_shapes_match_plain(dev, phi, dtype, m, n, d, c, split):
    plan = _check_matvec(dev, phi, dtype, m, n, d, c)
    if rk._sm_count(dev) == 132:   # the split flags are for an H100 SXM
        assert (plan.splits > 1) == split


@pytest.mark.parametrize("m,n,d,c", [(5000, 3000, 3, 4), (512, 2000, 1, 20),
                                     (1, 100_000, 3, 1)],
                         ids=["whole", "podi-split", "one-query-split"])
def test_matvec_is_deterministic(dev, m, n, d, c):
    gen = torch.Generator(device=dev).manual_seed(0)
    q, x = (torch.rand(k, d, generator=gen, device=dev) for k in (m, n))
    coef = torch.randn(n, c, generator=gen, device=dev)
    first = rk.rbf_matvec(q, x, coef, "cubic", 1.0)
    for _ in range(3):
        assert torch.equal(first, rk.rbf_matvec(q, x, coef, "cubic", 1.0))


def _root_inputs(dev, m=1 << 20):
    """m f64 query coordinates whose squares span the exponent range: the
    first half in blocks of 512 (one block of the matvec's queries) inside
    the range where sqrt_n takes its fast path, the second half from 2^-1074
    to 2^1023 with exact zeros, subnormal squares, squares in the normals
    below the fast path and squares that overflow, mixed within a thread's
    four queries."""
    gen = torch.Generator(device=dev).manual_seed(24)
    sign = torch.where(torch.rand(m, generator=gen, device=dev) < 0.5, -1.0,
                       1.0).double()
    mant = 1 + torch.rand(m, generator=gen, device=dev, dtype=torch.float64)
    half = m // 2
    e_fast = torch.randint(-480, 510, (half,), generator=gen, device=dev)
    e_any = torch.randint(-1074, 1024, (m - half,), generator=gen, device=dev)
    special = torch.tensor([-538, -530, -520, -512, -511, -500, -486, 512,
                            600, 1023], device=dev)
    e_any[:special.numel() * 64] = special.repeat_interleave(64)
    q = torch.ldexp(mant, torch.cat([e_fast, e_any]).double()) * sign
    q[half::9] = 0.0
    q[half + 1::23] = 2.0 ** -1074
    return q[:, None].contiguous()


def test_f64_root_is_ieee_sqrt_bit_for_bit(dev):
    # sqrt_n<double> against the correctly rounded root, through the d = 1
    # linear matvec at one support point (x0 = 0, so r^2 is one rounded
    # product) and the d = 1 linear kernel matrix (direct and TMA stores);
    # and the multiquadric's one root, sqrt(1 + r^2) at eps = 1
    q = _root_inputs(dev)
    x0 = torch.zeros(1, 1, device=dev, dtype=torch.float64)
    diff = q - x0
    r2 = diff * diff
    assert bool((r2 == 0).any() and ((r2 > 0) & (r2 < 2.0 ** -1022)).any()
                and torch.isinf(r2).any())
    want = torch.sqrt(r2)
    one = torch.ones(1, 1, device=dev, dtype=torch.float64)
    assert torch.equal(rk.rbf_matvec(q, x0, one, "linear", 1.0), want)
    for xb in (x0, x0.expand(2, 1).contiguous()):   # 8- and 16-byte rows
        k = rk.pairwise_kernel_matrix(q, xb, "linear", 1.0)
        assert torch.equal(k, want.expand(-1, xb.shape[0]))
    mq = rk.rbf_matvec(q, x0, one, "multiquadric", 1.0)
    assert torch.equal(mq, torch.sqrt(1 + r2))


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("phi", ["multiquadric", "gaussian"])
@pytest.mark.parametrize("d", [3, 5], ids=["templated", "runtime-d"])
def test_matvec_phi_at_a_support_point_is_exact(dev, dtype, phi, d):
    # q = x_j with the one-hot coefficient e_j: y = phi(0) = 1 exactly, and
    # launches_by counts the call under its instance
    gen = torch.Generator(device=dev).manual_seed(d)
    x = torch.randn(64, d, generator=gen, device=dev, dtype=dtype)
    eye = torch.eye(64, device=dev, dtype=dtype)
    before = dict(rk.rbf_matvec.launches_by)
    y = rk.rbf_matvec(x, x, eye, phi, 0.7)
    torch.cuda.synchronize()
    assert bool((torch.diagonal(y) == 1).all())
    after = dict(rk.rbf_matvec.launches_by)
    assert after.pop((dtype, phi)) == before.pop((dtype, phi), 0) + 1
    assert after == before


def test_matvec_refuses_a_bad_plan(dev):
    # the C side checks the plan it is given: splits must cover the support
    # exactly, and more than one needs scratch
    lib = load_library()
    q = torch.rand(10, 1, device=dev)
    x = torch.rand(100, 1, device=dev)
    c = torch.rand(100, 1, device=dev)
    out = torch.empty(10, 1, device=dev)
    scratch = torch.empty(4, 10, 1, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    ptrs = (q.data_ptr(), x.data_ptr(), c.data_ptr(), out.data_ptr())
    invalid = 1   # cudaErrorInvalidValue
    for scr, cols, splits, split_len in [
            (scratch.data_ptr(), 1, 4, 10),     # covers 40 of 100
            (scratch.data_ptr(), 1, 4, 34),     # the last split is empty
            (None, 1, 4, 25),                   # no scratch
            (scratch.data_ptr(), 3, 4, 25),     # no such column instance
    ]:
        rc = lib.corrla_rbf_matvec_f32(*ptrs, scr, 10, 100, 1, 1, 1, 1.0,
                                       cols, splits, split_len, stream)
        assert rc == invalid
    rc = lib.corrla_rbf_matvec_f32(*ptrs, scratch.data_ptr(), 10, 100, 1, 1,
                                   1, 1.0, 1, 4, 25, stream)
    assert rc == 0
    torch.testing.assert_close(
        out, rk.rbf_matvec_ref(q.double(), x.double(), c.double()).float(),
        rtol=1e-5, atol=1e-5)


def test_kernel_matrix_diagonal_is_exact_zero(dev):
    x = torch.rand(300, 3, device=dev)
    k = rk.pairwise_kernel_matrix(x, x, "linear", 1.0)
    assert bool((torch.diagonal(k) == 0).all())


def test_refused_launch_raises(dev):
    # what the kernels cannot take is refused by the C side, and the wrapper
    # raises with CUDA's message; nothing is counted
    before = (rk.pairwise_kernel_matrix.launches, rk.rbf_matvec.launches)
    wide = torch.rand(100, 200, device=dev, dtype=torch.float64)   # d=200
    with pytest.raises(RuntimeError, match="invalid argument"):
        rk.rbf_matvec(wide, wide, torch.ones(100, 1, device=dev,
                                             dtype=torch.float64))
    # the kernel matrix's persistent grid takes any shape; a phi code the
    # kernel does not know is refused
    x = torch.rand(10, 3, device=dev)
    with pytest.raises(RuntimeError, match="invalid argument"):
        rk._launch_kernel_matrix(torch.empty(10, 10, device=dev), x, x, 9,
                                 1.0)
    assert (rk.pairwise_kernel_matrix.launches,
            rk.rbf_matvec.launches) == before


def test_wrappers_raise_instead_of_falling_back(dev):
    x = torch.rand(10, 2, device=dev)
    with pytest.raises(ValueError, match="differ in dtype or device"):
        rk.rbf_matvec(x, x.cpu(), torch.ones(10, 1))
    with pytest.raises(ValueError, match="contiguous"):
        rk.pairwise_kernel_matrix(x, torch.rand(2, 10, device=dev).mT)


# ---------------------------------------------------------------------------
# the kernel matrix: every d instance, both store paths, views of a larger
# matrix, and its bits


def _kmat_inputs(dev, dtype, na, nb, d, seed=0):
    gen = torch.Generator(device=dev).manual_seed(seed + na + nb + d)
    return (torch.randn(na, d, generator=gen, device=dev, dtype=dtype),
            torch.randn(nb, d, generator=gen, device=dev, dtype=dtype))


def _assert_matches_plain(got, xa, xb, phi, eps=0.7):
    want = rk.pairwise_kernel_matrix_ref(xa.double(), xb.double(), phi, eps)
    err = (got.double() - want).abs()
    assert bool((err <= KMAT_RTOL[got.dtype]
                 * (want.abs() + want.abs().max())).all()), err.max().item()


def _takes_tma(out):
    return rk._kmat_store_path(out) == "tma"


def _unaligned_like(na, nb, dtype, dev):
    """An (na, nb) view one element into a wider matrix: its base is not
    16-byte aligned, so the kernel stores directly."""
    out = torch.empty(na, nb + 1, dtype=dtype, device=dev)[:, 1:]
    assert not _takes_tma(out)
    return out


# d = 1..8 templated, 9 and 20 the runtime loop over feature slabs; 256
# columns take the TMA store, 1537 the direct stores
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("phi", PHIS)
@pytest.mark.parametrize("d", [1, 2, 3, 4, 5, 6, 7, 8, 9, 20])
@pytest.mark.parametrize("na,nb,tma", [(300, 256, True), (1000, 1537, False)],
                         ids=["tma", "direct"])
def test_kernel_matrix_every_d_matches_plain(dev, phi, dtype, d, na, nb,
                                             tma):
    xa, xb = _kmat_inputs(dev, dtype, na, nb, d)
    before = rk.pairwise_kernel_matrix.launches
    got = rk.pairwise_kernel_matrix(xa, xb, phi, 0.7)
    torch.cuda.synchronize()
    assert rk.pairwise_kernel_matrix.launches == before + 1
    assert _takes_tma(got) == tma
    _assert_matches_plain(got, xa, xb, phi)


# ragged shapes whose rows are not 16-byte multiples take the direct
# stores; aligned ones, down to fewer rows and columns than a tile, TMA.
# The direct stores into an unaligned view give the same bits.
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("na,nb,d", [(7, 13, 2), (1000, 1537, 3),
                                     (2001, 2003, 8), (3, 4, 1),
                                     (65, 132, 3), (2000, 2000, 1),
                                     (130, 256, 8), (64, 2, 5)])
def test_kernel_matrix_shapes_take_their_store_path(dev, dtype, na, nb, d):
    xa, xb = _kmat_inputs(dev, dtype, na, nb, d, seed=1)
    got = rk.pairwise_kernel_matrix(xa, xb, "cubic", 0.7)
    assert _takes_tma(got) == (nb * got.element_size() % 16 == 0)
    _assert_matches_plain(got, xa, xb, "cubic")
    direct = rk._pairwise_kernel_matrix_into(
        _unaligned_like(na, nb, dtype, dev), xa, xb, "cubic", 0.7)
    assert torch.equal(direct, got)


# f32 at 2,048 tiles: each CTA of the persistent grid walks at least four,
# so both output buffers are reused (TMA) and the coordinate stages turn
# over; compared in full on both store paths
@pytest.mark.parametrize("path", ["tma", "direct"])
def test_kernel_matrix_many_tiles_a_cta_matches_plain(dev, path):
    n = 4096
    xa, xb = _kmat_inputs(dev, torch.float32, n, n, 3, seed=6)
    out = (torch.empty(n, n, device=dev) if path == "tma"
           else _unaligned_like(n, n, torch.float32, dev))
    assert rk._kmat_store_path(out) == path
    rk._pairwise_kernel_matrix_into(out, xa, xb, "gaussian", 0.7)
    _assert_matches_plain(out, xa, xb, "gaussian")


# a block of a larger matrix: row strides and offsets that keep the TMA
# store (16-byte rows and base) and that do not; the guard cells around
# the block stay as they were
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("ld,off", [(2052, 0), (2064, 4), (2003, 0),
                                    (2052, 1), (2002, 2)])
def test_kernel_matrix_into_a_view(dev, dtype, ld, off):
    na, nb = 1000, 2000
    xa, xb = _kmat_inputs(dev, dtype, na, nb, 3, seed=2)
    big = torch.full((na + 2, ld), -7.5, dtype=dtype, device=dev)
    view = big[1:na + 1, off:off + nb]
    before = rk.pairwise_kernel_matrix.launches
    assert rk._pairwise_kernel_matrix_into(view, xa, xb, "multiquadric",
                                           0.7) is view
    torch.cuda.synchronize()
    assert rk.pairwise_kernel_matrix.launches == before + 1
    itemsize = big.element_size()
    assert _takes_tma(view) == ((ld + off) * itemsize % 16 == 0
                                and ld * itemsize % 16 == 0)
    _assert_matches_plain(view, xa, xb, "multiquadric")
    guard = torch.ones_like(big, dtype=torch.bool)
    guard[1:na + 1, off:off + nb] = False
    assert bool((big[guard] == -7.5).all())


def _output_on(path, na, nb, dtype, dev):
    """An (na, nb) output the kernel stores into by ``path``: a contiguous
    matrix with 16-byte rows, or an unaligned view."""
    if path == "direct":
        return _unaligned_like(na, nb, dtype, dev)
    out = torch.empty(na, nb, dtype=dtype, device=dev)
    assert _takes_tma(out)
    return out


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("tma", [True, False], ids=["tma", "direct"])
def test_kernel_matrix_diagonal_exact_on_both_paths(dev, dtype, tma):
    path = "tma" if tma else "direct"
    x = torch.rand(1000, 3, device=dev, dtype=dtype)
    k = _output_on(path, 1000, 1000, dtype, dev)
    rk._pairwise_kernel_matrix_into(k, x, x, "linear", 1.0)
    assert bool((torch.diagonal(k) == 0).all())
    assert torch.equal(k, k.mT)
    g = rk._pairwise_kernel_matrix_into(_output_on(path, 1000, 1000, dtype,
                                                   dev), x, x, "gaussian",
                                        1.0)
    assert bool((torch.diagonal(g) == 1).all())


@pytest.mark.parametrize("na,nb,d", [(2000, 2000, 1), (1000, 1537, 3),
                                     (700, 900, 20)])
def test_kernel_matrix_rerun_is_bit_identical(dev, na, nb, d):
    xa, xb = _kmat_inputs(dev, torch.float32, na, nb, d, seed=3)
    first = rk.pairwise_kernel_matrix(xa, xb, "multiquadric", 0.3)
    for _ in range(3):
        assert torch.equal(first, rk.pairwise_kernel_matrix(
            xa, xb, "multiquadric", 0.3))


@pytest.mark.parametrize("tma", [True, False], ids=["tma", "direct"])
def test_kernel_matrix_f32_bits_as_recorded(dev, tma):
    # the kernel before its redesign, recorded by tests/kmat_golden.py: the
    # same FMA chain in feature order and sqrtf's bits
    import os

    import numpy as np

    import kmat_golden

    rec = np.load(os.path.join(os.path.dirname(__file__), "data",
                               "kmat_f32_bits.npz"))
    for key, phi, d in kmat_golden.cases():
        xa = torch.from_numpy(rec[f"xa{d}"]).to(dev)
        xb = torch.from_numpy(rec[f"xb{d}"]).to(dev)
        got = _output_on("tma" if tma else "direct", xa.shape[0],
                         xb.shape[0], torch.float32, dev)
        rk._pairwise_kernel_matrix_into(got, xa, xb, phi, kmat_golden.EPS)
        assert torch.equal(got.cpu(), torch.from_numpy(rec[key])), key


def test_kernel_matrix_refuses_what_it_cannot_take(dev):
    lib = load_library()
    xa = torch.rand(10, 3, device=dev)
    out = torch.zeros(10, 20, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    invalid = 1   # cudaErrorInvalidValue
    p = xa.data_ptr()
    for d, ld, phi in [
            (3, 9, 1),      # row stride below n_b
            (0, 20, 1),     # no features
            (3, 20, 9),     # no such phi
    ]:
        rc = lib.corrla_kernel_matrix_f32(p, p, out.data_ptr(), 10, 10, d,
                                          ld, phi, 1.0, stream)
        assert rc == invalid
    assert bool((out == 0).all())
    # 52-byte rows: the direct stores
    assert lib.corrla_kernel_matrix_tma(out.data_ptr(), 10, 10, 13, 4) == 0
    rc = lib.corrla_kernel_matrix_f32(p, p, out.data_ptr(), 10, 10, 3, 13, 1,
                                      1.0, stream)
    assert rc == 0
    _assert_matches_plain(out.view(-1)[:130].view(10, 13)[:, :10], xa, xa,
                          "linear", 1.0)


@pytest.mark.parametrize("n", [300, 301])
def test_rbf_fit_on_cuda_matches_cpu_f64(dev, n):
    # K goes straight into the (n + 4)^2 saddle matrix, whose rows are
    # padded to 128 bytes (304 doubles stay 304, 305 become 320), so K's
    # block takes the TMA store
    from corrla_rs_tpu_torch.ops import interp

    saddle = interp._padded_square(n + 4, torch.float64, dev)
    assert saddle.stride(0) * 8 % 128 == 0
    assert rk._kmat_store_path(saddle[:n, :n]) == "tma"
    gen = torch.Generator().manual_seed(n)
    x = torch.rand(n, 3, generator=gen, dtype=torch.float64)
    y = torch.sin(3 * x[:, :1]) + x[:, 1:2] * x[:, 2:]
    before = rk.pairwise_kernel_matrix.launches
    cg = interp.rbf_fit(x.to(dev), y.to(dev), "linear", 1.0, 1)
    torch.cuda.synchronize()
    assert rk.pairwise_kernel_matrix.launches == before + 1
    cc = interp.rbf_fit(x, y, "linear", 1.0, 1)
    # two LU solves of one saddle system agree to eps * its condition number
    kp = torch.zeros(n + 4, n + 4, dtype=torch.float64)
    kp[:n, :n] = rk.pairwise_kernel_matrix_ref(x, x)
    kp[:n, n:] = torch.cat([x, torch.ones(n, 1, dtype=x.dtype)], 1)
    kp[n:, :n] = kp[:n, n:].mT
    tol = torch.finfo(torch.float64).eps * torch.linalg.cond(kp).item()
    assert tol < 1e-8
    assert ((cg.cpu() - cc).abs().max() / cc.abs().max()).item() <= tol


def test_small_dirichlet_mcmc_runs_on_the_card(dev):
    import numpy as np

    import corrla_rs_tpu_torch as port

    bounds = np.array([[0.0, 0.0026], [0.1955, 0.1995], [0.80, 0.825]])
    samples, ar = port.cs_mcmc_dirichlet_sample(
        bounds, 300, 8, 500, 20000, 1.0, np.ones(3), 0.8, 1e-12, seed=4,
        device=dev)
    assert isinstance(samples, torch.Tensor) and samples.device.type == "cuda"
    assert samples.shape == (2400, 3)
    assert float((samples.sum(1) - 1).abs().max()) <= 1e-6
    assert 0.0 < ar <= 1.0


# ---------------------------------------------------------------------------
# the kNN on the kernel-matrix kernel, and the slice's models on the card


def _knn_plain(xq, xs, k):
    d = rk.pairwise_kernel_matrix_ref(xq.double(), xs.double(), "linear")
    return torch.topk(d, k, dim=1, largest=False, sorted=True)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("kw", [{}, {"query_chunk": 100},
                                {"support_chunk": 256},
                                {"support_chunk": 300, "query_chunk": 77}],
                         ids=["dense", "query-chunks", "support-stream",
                              "both-ragged"])
def test_knn_on_the_kernel_matches_plain(dev, dtype, kw):
    from corrla_rs_tpu_torch.ops.knn import knn

    gen = torch.Generator(device=dev).manual_seed(5)
    xs = torch.randn(1000, 5, generator=gen, device=dev, dtype=dtype)
    xq = torch.randn(333, 5, generator=gen, device=dev, dtype=dtype)
    before = rk.pairwise_kernel_matrix.launches
    d, idx = knn(xq, xs, 16, **kw)
    torch.cuda.synchronize()
    assert rk.pairwise_kernel_matrix.launches > before
    d_ref, i_ref = _knn_plain(xq, xs, 16)
    # random normal data: no near-ties at this size, so the sets agree
    assert torch.equal(idx.sort(1).values, i_ref.sort(1).values)
    torch.testing.assert_close(d.double(), d_ref, rtol=KMAT_RTOL[dtype],
                               atol=0)


def test_dmdc_on_cuda_matches_cpu_f64(dev, monkeypatch):
    import numpy as np

    from corrla_rs_tpu_torch.models import dmd
    from corrla_rs_tpu_torch.ops import random_svd
    from corrla_rs_tpu_torch.utils.prng import as_generator, split_seed

    # both devices draw the same sketches: from CPU generators, moved over
    monkeypatch.setattr(dmd, "_split_seed",
                        lambda key, n, device: split_seed(key, n, "cpu"))
    monkeypatch.setattr(
        random_svd, "_draw_sketch",
        lambda key, shape, dtype, device: torch.randn(
            shape, generator=as_generator(key, "cpu"), dtype=dtype).to(device))
    rng = np.random.default_rng(0)
    x = np.cumsum(rng.standard_normal((300, 61)), axis=1)
    u = rng.standard_normal((2, 61))
    for backend in ("host", "device"):
        mc = dmd.DMDc(x, u, 6, 10, key=3, eig_backend=backend, device="cpu")
        mg = dmd.DMDc(x, u, 6, 10, key=3, eig_backend=backend, device=dev)
        assert mg.modes_re.device.type == "cuda"
        np.testing.assert_allclose(np.sort_complex(mg.lambdas),
                                   np.sort_complex(mc.lambdas), atol=1e-9)
        for method in ("dense", "modes", "reduced"):
            pc = mc.predict_multiple(x[:, :1], u, method)
            pg = mg.predict_multiple(x[:, :1], u, method).cpu()
            assert pg.dtype == torch.float64
            scale = float(pc.abs().max())
            assert float((pg - pc).abs().max()) <= 1e-8 * scale, method


def test_active_ss_on_cuda_matches_cpu_f64(dev):
    import numpy as np

    import corrla_rs_tpu_torch as port
    from corrla_rs_tpu_torch.ops import rbf_kernels

    # four well-separated eigenvalues of C, so every component is defined
    rng = np.random.default_rng(1)
    x = rng.uniform(-1, 1, (3000, 4))
    y = np.sin(2 * x[:, 0]) + 0.5 * x[:, 1] ** 2 + 0.3 * x[:, 2] * x[:, 3] \
        + 0.1 * x[:, 3]
    before = rbf_kernels.pairwise_kernel_matrix.launches
    cg, vg, sg = port.active_ss(x, y, 2, 40, 2, device=dev)
    torch.cuda.synchronize()
    assert rbf_kernels.pairwise_kernel_matrix.launches > before
    cc, vc, sc = port.active_ss(x, y, 2, 40, 2, device="cpu")
    sign = torch.sign((cg.cpu() * cc).sum(0))
    torch.testing.assert_close(cg.cpu() * sign, cc, rtol=0, atol=1e-8)
    torch.testing.assert_close(vg.cpu(), vc, rtol=1e-8, atol=1e-12)
    torch.testing.assert_close(sg.cpu(), sc, rtol=1e-8, atol=1e-12)


# ---------------------------------------------------------------------------
# the modules without a kernel of their own: each once on the card against
# itself on the CPU, in f64 at a small size, from the same random numbers

def _seed_of(key):
    return key.initial_seed() if isinstance(key, torch.Generator) else int(
        key or 0)


@pytest.fixture
def cpu_draws(monkeypatch):
    """Every sketch and probe is drawn by a CPU generator of the key's seed
    and moved to the device: a run on the card and one on the CPU see the
    same numbers (the two devices' generators give different ones)."""
    from corrla_rs_tpu_torch.ops import random_svd, trace_est

    def sketch(key, shape, dtype, device):
        gen = torch.Generator().manual_seed(_seed_of(key))
        return torch.randn(shape, generator=gen, dtype=dtype).to(device)

    def rademacher(key, shape, dtype, device):
        gen = torch.Generator().manual_seed(_seed_of(key))
        bits = torch.randint(0, 2, shape, generator=gen)
        return (2 * bits - 1).to(dtype).to(device)

    monkeypatch.setattr(random_svd, "_draw_sketch", sketch)
    monkeypatch.setattr(trace_est, "_rademacher", rademacher)

    # the samplers' and filters' seams: drawn by a CPU generator that
    # follows the run's generator (or key), then moved to where it is
    from corrla_rs_tpu_torch.ops import (enkf, ensemble_mcmc, hmc, nuts,
                                         particle, psis, smc)

    followers = {}

    def follower(key):
        """A CPU generator of the key's seed: a fresh one for an int seed,
        one that advances with the run for a generator."""
        fresh = torch.Generator().manual_seed(_seed_of(key))
        if not isinstance(key, torch.Generator):
            return fresh
        # the run's generator is kept alive beside its follower, so that
        # its id is not handed to a later run's generator
        return followers.setdefault(id(key), (key, fresh))[1]

    def moved(out, device):
        if isinstance(out, torch.Tensor):
            return out.to(device)
        if isinstance(out, tuple):
            parts = [moved(t, device) for t in out]
            return type(out)(*parts) if hasattr(out, "_fields") else tuple(
                parts)
        return out      # None, or a host list

    def from_generator(real):
        return lambda gen, *args: moved(real(follower(gen), *args),
                                        gen.device)

    for mod, name in ((ensemble_mcmc, "_draw_stretch"), (hmc, "_draw_hmc"),
                      (nuts, "_draw_nuts"), (smc, "_draw_smc"),
                      (particle, "_draw_offsets")):
        monkeypatch.setattr(mod, name, from_generator(getattr(mod, name)))
    real_normals = enkf._draw_normals
    monkeypatch.setattr(
        enkf, "_draw_normals",
        lambda key, *args: moved(real_normals(follower(key), *args[:-1],
                                              "cpu"), args[-1]))
    monkeypatch.setattr(
        psis, "_draw_categorical",
        lambda key, logw, n: torch.multinomial(
            torch.exp(logw.cpu()), n, replacement=True,
            generator=torch.Generator().manual_seed(_seed_of(key))
        ).to(logw.device))


def _np_rng():
    import numpy as np

    return np.random.default_rng(7)


def _decaying(n, m, rate=0.7):
    rng = _np_rng()
    return torch.tensor(rng.standard_normal((n, m))
                        * rate ** torch.arange(m).numpy())


def _spd(n, cond=20.0):
    import numpy as np

    q, _ = np.linalg.qr(_np_rng().standard_normal((n, n)))
    return torch.tensor((q * np.linspace(1.0, cond, n)) @ q.T)


def _proj(u):
    return u @ u.mT


def _case_krylov_single_pass(d):
    from corrla_rs_tpu_torch.ops import random_svd as m

    a = _decaying(90, 30).to(d)
    out = []
    for u, s, vt in (m.block_krylov_svd(a, 5, 2, 4, key=1),
                     m.single_pass_svd(a, 5, 4, key=2),
                     m.single_pass_svd(a.mT, 5, 4, key=2)):
        out += [s, _proj(u), _proj(vt.mT)]
    return out


def _case_nystrom_cg(d):
    from corrla_rs_tpu_torch.ops import cg, nystrom

    a = _spd(60, 500.0).to(d)
    b = torch.tensor(_np_rng().standard_normal((60, 2))).to(d)
    lam, vec = nystrom.nystrom_eigh(a, 8, key=3)
    pre = cg.nystrom_preconditioner(a, 10, 0.5, key=4)
    res = cg.cg_solve(a, b, n_iters=150, tol=1e-10, preconditioner=pre)
    jac = cg.cg_solve(a, b[:, 0], n_iters=150, tol=1e-10,
                      preconditioner=cg.jacobi_preconditioner(a))
    return [lam, _proj(vec), res.x, res.residual_norms, jac.x,
            res.converged.double()]


def _case_rank_select_trace_slq(d):
    from corrla_rs_tpu_torch.ops import rank_select, slq, trace_est

    a = _decaying(80, 40).to(d)
    u, s, vt, r, err = rank_select.adaptive_random_svd(a, 3.0, rank0=2, key=5)
    w = _spd(70).to(d)
    v0 = torch.linalg.qr(torch.tensor(_np_rng().standard_normal((70, 3)))
                         ).Q.to(d)
    al, be = slq.lanczos_tridiag(w, v0, 10)
    return [s, torch.tensor([float(r), err,
                             trace_est.hutchinson_trace(w, 16, key=1),
                             trace_est.hutchpp_trace(w, 30, key=2),
                             slq.slq_logdet(w, 6, 20, key=3)], device=d),
            al, be, slq.lanczos_fn_apply(w / 10, v0, torch.exp, 20)]


def _case_lstsq_id_cur(d):
    from corrla_rs_tpu_torch.ops import id_cur, sketch_solve

    rng = _np_rng()
    a = torch.tensor(rng.standard_normal((300, 12))).to(d)
    b = torch.tensor(rng.standard_normal((300, 2))).to(d)
    x, hist = sketch_solve.sketched_lstsq(a, b, key=6)
    m = torch.tensor(rng.standard_normal((70, 6))
                     @ rng.standard_normal((6, 40))).to(d)
    cols, xi = id_cur.column_id(m, 6, key=7)
    rows, cols2, u = id_cur.cur(m, 6, key=8)
    return [x, hist[:, :15], cols.double(), xi, rows.double(),
            cols2.double(), m[:, cols2] @ u @ m[rows]]


def _case_hosvd_incremental_rpca(d):
    from corrla_rs_tpu_torch.ops import hosvd, incremental, robust_pca

    rng = _np_rng()
    t = torch.tensor(rng.standard_normal((9, 8, 7))).to(d)
    core, factors = hosvd.hooi(t, (3, 3, 2), n_sweeps=2, key=9)
    a = _decaying(50, 36, 0.8).to(d)
    inc = incremental.IncrementalSvd(5)
    pca = incremental.IncrementalPca(4)
    for blk in torch.chunk(a, 3, dim=1):
        inc.update(blk)
        pca.partial_fit(blk.mT)
    low = torch.tensor(rng.standard_normal((40, 3))
                       @ rng.standard_normal((3, 30))).to(d)
    spikes = (torch.tensor(rng.random((40, 30))) < 0.05).double().to(d) * 8.0
    l_hat, s_hat, info = robust_pca.robust_pca(low + spikes)
    return [hosvd.tucker_reconstruct(core, factors), inc.s,
            inc.reconstruct(), pca.singular_values_, pca.mean_,
            _proj(pca.components_.mT), l_hat, s_hat,
            torch.tensor([float(info["iterations"]), float(info["rank"])],
                         device=d)]


def _case_mle_diagnostics(d):
    from corrla_rs_tpu_torch.ops import diagnostics, univariate_rv as rv

    rng = _np_rng()
    x = torch.tensor(rng.normal(2.0, 3.0, 3000)).to(d)
    xb = torch.tensor(rng.beta(2.0, 5.0, 3000)).to(d)
    nrm = rv.NormalRv(0.0, 1.0).mlfit(x)
    beta = rv.BetaRv(1.0, 1.0).mlfit(xb, method=2)
    expo = rv.ExponentialRv(1.0).mlfit(x.abs())
    kde = rv.KdeRv(0.3, x[:200])
    h = torch.tensor(rng.standard_normal((120, 6, 2))).cumsum(0).to(d)
    grid = torch.linspace(0.01, 0.99, 25, dtype=torch.float64, device=d)
    return [torch.tensor([nrm.mu, nrm.std, beta.alpha, beta.beta, expo.lam,
                          kde.est_bandwidth(x[200:400])], device=d),
            rv.betainc(2.5, 0.7, grid), beta.cdf(grid), kde.pdf(x[:50]),
            diagnostics.gelman_rubin(h),
            diagnostics.effective_sample_size(h),
            diagnostics.rank_normalized_rhat(h)]


def _case_dream(d):
    from corrla_rs_tpu_torch.ops import dream

    # the same pre-drawn tensors on both devices, through the seam
    n, dim, gens = 32, 3, 25
    rand = dream._draw_dream(torch.Generator().manual_seed(11), gens, n, dim,
                             3, 0.05, 1e-6, torch.float64)
    heads = torch.tensor(_np_rng().standard_normal((n, dim)) * 2).to(d)
    real, dream._draw_dream = dream._draw_dream, (
        lambda gen, n_gens, *a: dream._GenRand(*(r.to(d) for r in rand)))
    real_chunk, dream._chunk_for = dream._chunk_for, lambda n_chains: gens
    try:
        hist, st = dream.dream_run(
            heads, lambda x: -0.5 * torch.sum(x * x) - 0.1 * x[0] * x[1],
            gens, key=0, n_adapt=10)
    finally:
        dream._draw_dream, dream._chunk_for = real, real_chunk
    assert hist.device.type == d.type and st.n_accept.device.type == d.type
    return [hist, st.head_lnp, st.p_cr, st.jump_dist, st.n_id,
            st.n_accept.double(), st.t.double()]


def _case_tensor_factorize(d):
    from corrla_rs_tpu_torch.ops import completion, cp, nmf, tt

    rng = _np_rng()
    g = [rng.standard_normal(s) for s in ((1, 6, 3), (3, 5, 4), (4, 7, 2),
                                          (2, 4, 1))]
    t = torch.tensor(g[0])
    for core in g[1:]:
        t = torch.tensordot(t, torch.tensor(core), dims=([-1], [0]))
    t = t.reshape(6, 5, 7, 4).to(d)
    cores = tt.tt_round(tt.tt_svd(t, (5, 8, 3), key=1), (3, 4, 2), key=2)
    fs = [rng.standard_normal((n, 3)) for n in (9, 8, 7)]
    t3 = torch.tensor(np_einsum("ir,jr,kr->ijk", *fs)).to(d)
    w, factors, fits = cp.cp_als(t3, 3, n_sweeps=20, key=3)
    x = torch.tensor(rng.random((40, 4)) @ rng.random((4, 30))).to(d)
    nw, nh, errs = nmf.nmf(x, 4, n_sweeps=30, key=4)
    truth = rng.standard_normal((50, 3)) @ rng.standard_normal((3, 40))
    mask = rng.random((50, 40)) < 0.5
    m_hat, _, _, hist = completion.matrix_complete(
        torch.tensor(truth).to(d), torch.tensor(mask).to(d), 3, n_sweeps=15,
        key=5)
    return [tt.tt_reconstruct(cores), tt.tt_norm(cores)[None],
            cp.cp_reconstruct(w, factors), w, fits, nw @ nh, errs, m_hat,
            hist]


def np_einsum(*args):
    import numpy as np

    return np.einsum(*args)


def _lnp_gauss(x):
    prec = torch.tensor([[1.5, 0.4, 0.0], [0.4, 1.0, -0.3],
                         [0.0, -0.3, 2.0]], dtype=x.dtype, device=x.device)
    return -0.5 * x @ prec @ x


def _case_samplers(d):
    from corrla_rs_tpu_torch.ops import ensemble_mcmc, hmc, nuts, smc

    x0 = torch.tensor(_np_rng().standard_normal((8, 3))).to(d)
    hist, st = ensemble_mcmc.stretch_run(x0, _lnp_gauss, 30, key=1)
    h = hmc.hmc_run(x0, _lnp_gauss, 6, n_warmup=5, n_leapfrog=5, key=2,
                    jitter_steps=True)
    n = nuts.nuts_run(x0, _lnp_gauss, 5, n_warmup=5, max_depth=4, key=3)
    parts = torch.tensor(_np_rng().standard_normal((128, 3)) * 2).to(d)
    s = smc.smc_sample(_lnp_gauss, lambda x: -0.125 * torch.sum(x * x),
                       parts, n_mcmc=2, key=4)
    assert st.n_accept.device.type == d.type
    return [hist, st.lnp, st.n_accept.double()[None], h.history, h.inv_mass,
            torch.tensor([h.step_size, h.accept_ratio], device=d), n.history,
            torch.tensor([n.step_size, n.accept_ratio, n.mean_tree_depth],
                         device=d), s.particles, s.betas, s.ess,
            torch.tensor([s.log_evidence], device=d)]


def _case_filters(d):
    from corrla_rs_tpu_torch.ops import enkf, kalman, particle

    rng = _np_rng()
    a = rng.standard_normal((5, 5))
    a = torch.tensor(a * 0.9 / abs(torch.linalg.eigvals(
        torch.tensor(a))).max().item()).to(d)
    b = torch.tensor(rng.standard_normal((5, 2))).to(d)
    c = torch.tensor(rng.standard_normal((2, 5))).to(d)
    u = torch.tensor(rng.standard_normal((2, 30))).to(d)
    y = torch.tensor(rng.standard_normal((2, 30))).to(d)
    ks = kalman.kalman_smooth(a, b, c, None, 0.01, 0.1, u, y)
    k_gain, _ = kalman.dlqr(a, b, 1.0, 0.5)
    ens = torch.tensor(rng.standard_normal((12, 5))).to(d)
    step = lambda v: torch.tanh(a @ v)
    out = [ks["x_filt"], ks["x_smooth"], ks["gain"],
           torch.tensor([ks["loglik"]], device=d), k_gain,
           enkf.enkf_analysis(ens, y[:, 0], c, 0.1, 1),
           enkf.etkf_analysis(ens, y[:, 0], c, [0.1, 0.2])]
    for method in ("etkf", "stochastic"):
        f = enkf.enkf_filter(ens, y.mT, step, c, 0.1, 2, method=method,
                             q=0.01)
        out += [f["means"], f["ensemble"], f["spread"]]
    es = enkf.esmda(ens, lambda th: c @ th, y[:, 0], 0.1, 3, n_mda=3)
    pf = particle.particle_filter(
        torch.tensor(rng.standard_normal((64, 5))).to(d), y.mT,
        lambda gen, cloud: 0.9 * cloud + 0.1 * torch.sin(3.0 * cloud),
        lambda x, obs: -0.5 * torch.sum((obs - c @ x) ** 2), 4)
    uk = particle.ukf_filter(torch.zeros(5, dtype=torch.float64, device=d),
                             1.0, y.mT, step, lambda v: c @ v, 0.01, 0.1)
    return out + [es["ensemble"], es["predicted"], pf["means"], pf["ess"],
                  pf["log_weights"], uk["means"], uk["covs"],
                  torch.tensor([pf["loglik"], uk["loglik"]], device=d)]


def _case_evidence(d):
    from corrla_rs_tpu_torch.ops import bridge, laplace, psis

    rng = _np_rng()
    draws = torch.tensor(rng.standard_normal((400, 3)) * 0.7).to(d)
    lap = laplace.laplace_approx(
        lambda x: _lnp_gauss(x - 1.0),
        torch.zeros(3, dtype=torch.float64, device=d), n_restarts=3, key=1)
    br = bridge.bridge_sampling_evidence(_lnp_gauss, draws, key=2)
    lw = torch.tensor(rng.standard_normal(500) ** 2 * 0.3).to(d)
    smp, res = psis.importance_resample(draws[:, :1].repeat(2, 1)[:500], lw,
                                        50, key=3)
    assert res.log_weights.device.type == d.type
    return [lap.x_map, lap.cov, lap.chol_cov, laplace.laplace_sample(lap, 5, 4),
            torch.tensor([lap.log_evidence, br.log_evidence, res.k_hat,
                          res.ess], device=d), br.proposal_chol,
            res.log_weights, smp]


SLICE_CASES = {
    "tensor_factorize": _case_tensor_factorize,
    "samplers_beyond_demc": _case_samplers,
    "filters": _case_filters,
    "evidence": _case_evidence,
    "krylov_single_pass": _case_krylov_single_pass,
    "nystrom_cg": _case_nystrom_cg,
    "rank_select_trace_slq": _case_rank_select_trace_slq,
    "lstsq_id_cur": _case_lstsq_id_cur,
    "hosvd_incremental_rpca": _case_hosvd_incremental_rpca,
    "mle_diagnostics": _case_mle_diagnostics,
    "dream": _case_dream,
}


@pytest.mark.parametrize("case", sorted(SLICE_CASES))
def test_slice_module_on_cuda_matches_cpu_f64(dev, cpu_draws, case):
    # f64 on both: cuBLAS/cuSOLVER against the CPU's LAPACK, 1e-8 of each
    # result's largest entry (the fits stop at a gradient of 1e-5, so 1e-6)
    on_card = SLICE_CASES[case](dev)
    on_cpu = SLICE_CASES[case](torch.device("cpu"))
    tol = 1e-6 if case in ("mle_diagnostics", "evidence") else 1e-8
    assert len(on_card) == len(on_cpu)
    for i, (got, want) in enumerate(zip(on_card, on_cpu)):
        assert got.device.type == "cuda" and want.device.type == "cpu", i
        scale = max(float(want.abs().max()), 1e-30)
        err = float((got.cpu() - want).abs().max())
        assert err <= tol * scale, (case, i, err, scale)


def test_slice_entry_points_put_numpy_on_the_card(dev):
    import numpy as np

    import corrla_rs_tpu_torch as port
    from corrla_rs_tpu_torch.ops import dream, optimize, univariate_rv

    rng = np.random.default_rng(3)
    a = rng.standard_normal((60, 20)) * 0.7 ** np.arange(20)
    g = rng.standard_normal((30, 30))
    w = g @ g.T / 30 + np.eye(30)
    b = rng.standard_normal(30)
    x = rng.normal(1.0, 2.0, 500)
    f = lambda v: -0.5 * torch.sum(v * v)
    heads = rng.standard_normal((10, 2))
    inc = port.IncrementalSvd(3).update(a[:, :10]).update(a[:, 10:])
    pca = port.IncrementalPca(3).partial_fit(a[:30]).partial_fit(a[30:])
    results = {
        "random_svd": port.random_svd(a, 4, 1, 2),
        "single_pass_svd": port.single_pass_svd(a, 4),
        "block_krylov_svd": port.block_krylov_svd(a, 4, 1),
        "betainc": univariate_rv.betainc(2.0, 5.0,
                                         np.linspace(0.1, 0.9, 5)),
        "nystrom_eigh": port.nystrom_eigh(w, 4),
        "nystrom_approx": port.nystrom_approx(w, 4),
        "adaptive_random_svd": port.adaptive_random_svd(a, 0.5)[:3],
        "sketched_lstsq": port.sketched_lstsq(a, a[:, 0]),
        "cg_solve": port.cg_solve(w, b)[:3],
        "jacobi_preconditioner": port.jacobi_preconditioner(w)(
            torch.ones(30, 1, dtype=torch.float64, device=dev)),
        "lanczos_tridiag": port.lanczos_tridiag(w, b[:, None] / np.linalg.norm(b), 5),
        "lanczos_fn_apply": port.lanczos_fn_apply(w, b, torch.exp, 10),
        "column_id": port.column_id(a, 4),
        "row_id": port.row_id(a, 4),
        "cur": port.cur(a, 4),
        "hosvd": port.hosvd(rng.standard_normal((6, 5, 4)), (2, 2, 2)),
        "hooi": port.hooi(rng.standard_normal((6, 5, 4)), (2, 2, 2)),
        "IncrementalSvd": (inc.u, inc.s, inc.v, inc.reconstruct()),
        "IncrementalPca": (pca.components_, pca.mean_, pca.transform(a)),
        "robust_pca": port.robust_pca(a)[:2],
        "gelman_rubin": port.gelman_rubin(rng.standard_normal((40, 4, 2))),
        "effective_sample_size": port.effective_sample_size(
            rng.standard_normal((40, 4, 2))),
        "rank_normalized_rhat": port.rank_normalized_rhat(
            rng.standard_normal((40, 4, 2))),
        "make_dream_state": dream.make_dream_state(heads, f)[:2],
        "dream_run": port.dream_run(heads, f, 4)[0],
        "DreamSampler": port.DreamSampler(f, heads).sample_mcmc(3)
        .chain_history,
        "NormalRv.pdf": port.NormalRv(0.0, 1.0).pdf(x),
        "NormalRv.sample": port.NormalRv(0.0, 1.0).sample(5),
        "BetaRv.cdf": port.BetaRv(2.0, 3.0).cdf(np.linspace(0.1, 0.9, 5)),
        "BetaRv.sample": port.BetaRv(2.0, 3.0).sample(5),
        "ExponentialRv.sample": port.ExponentialRv(2.0).sample(5),
        "KdeRv": port.KdeRv(0.5, x).pdf(x[:5]),
        "build_kde": port.build_kde(0.5, x[:100], n_iter=2).supports,
        "mlefit": optimize.mlefit(lambda p: torch.sum((p - 1.0) ** 2),
                                  [0.0, 0.0], [[-5.0, -5.0], [5.0, 5.0]]),
        "particle_swarm": optimize.particle_swarm(
            lambda p: torch.sum((p - 1.0) ** 2), [[-5.0, -5.0], [5.0, 5.0]],
            0, n_particles=8, n_iters=5),
    }
    for name, res in results.items():
        tensors = [t for t in (res if isinstance(res, (tuple, list)) else
                               [res]) for t in (t if isinstance(t, list)
                                                else [t])]
        assert tensors and all(isinstance(t, torch.Tensor) and t.is_cuda
                               for t in tensors), name
    # the scalar estimators read their result back; their work is on the
    # card all the same, which the fits' samples show
    assert isinstance(port.hutchpp_trace(w, 9), float)
    assert isinstance(port.slq_logdet(w, 4, 10), float)
    assert isinstance(port.range_error_estimate(a, np.eye(60)[:, :5]), float)
    assert port.NormalRv(0.0, 1.0).mlfit(x).std > 0


def test_slice_inference_entry_points_put_numpy_on_the_card(dev):
    # the inference layer and the tensor factorizations: numpy (or a list)
    # in, tensors on the card out, whatever the size
    import numpy as np

    import corrla_rs_tpu_torch as port

    rng = np.random.default_rng(5)
    f = lambda v: -0.5 * torch.sum(v * v)
    t3 = rng.standard_normal((6, 5, 4))
    cores = port.tt_svd(t3, (2, 2))
    w, factors, fits = port.cp_als(t3, 2, n_sweeps=3)
    x_pos = rng.random((12, 9))
    mask = rng.random((12, 9)) < 0.7
    heads = rng.standard_normal((8, 2))
    a = 0.8 * np.eye(3)
    c = rng.standard_normal((2, 3))
    u, y = rng.standard_normal((1, 10)), rng.standard_normal((2, 10))
    b = np.ones((3, 1))
    kf = port.kalman_smooth(a, b, c, None, 0.01, 0.1, u, y)
    ens = rng.standard_normal((6, 3))
    step = lambda v: 0.9 * v
    flt = port.enkf_filter(ens, y.T, step, c, 0.1, 0, method="stochastic")
    es = port.esmda(ens, lambda th: th[:2], y[:, 0], 0.1, 0, n_mda=2)
    pf = port.particle_filter(
        rng.standard_normal((16, 3)), y.T,
        lambda gen, cloud: 0.9 * cloud + 0.1 * torch.randn(
            cloud.shape, generator=gen, device=cloud.device,
            dtype=cloud.dtype),
        lambda x, obs: -0.5 * torch.sum((obs - x[:2]) ** 2), 0)
    uk = port.ukf_filter(np.zeros(3), 1.0, y.T, step, lambda v: v[:2], 0.01,
                         0.1)
    lap = port.laplace_approx(f, [0.3, -0.2])
    draws = rng.standard_normal((200, 2))
    br = port.bridge_sampling_evidence(f, draws)
    smc = port.smc_sample(f, f, rng.standard_normal((64, 2)), n_mcmc=1)
    hmc = port.hmc_run(heads, f, 3, n_warmup=2, n_leapfrog=3)
    nuts = port.nuts_run(heads, f, 3, n_warmup=2, max_depth=3)
    results = {
        "tt_svd": cores, "tt_round": port.tt_round(cores, (1, 1)),
        "tt_reconstruct": port.tt_reconstruct([np.asarray(g.cpu())
                                               for g in cores]),
        "tt_dot": port.tt_dot(cores, cores), "tt_norm": port.tt_norm(cores),
        "cp_als": [w, fits] + factors,
        "cp_reconstruct": port.cp_reconstruct(
            w.cpu().numpy(), [g.cpu().numpy() for g in factors]),
        "nmf": port.nmf(x_pos, 2, n_sweeps=3),
        "matrix_complete": port.matrix_complete(x_pos, mask, 2, n_sweeps=3),
        "stretch_run": port.stretch_run(heads, f, 3)[0],
        "EnsembleSampler": port.EnsembleSampler(f, heads).sample_mcmc(16)
        .chain_history,
        "hmc_run": [hmc.history, hmc.final, hmc.inv_mass],
        "nuts_run": [nuts.history, nuts.final, nuts.inv_mass],
        "smc_sample": [smc.particles, smc.betas, smc.ess, smc.accept_ratios],
        "dare": port.dare(a, c, 0.01 * np.eye(3), 0.1 * np.eye(2)),
        "dlqr": port.dlqr(a, b, 1.0, 1.0),
        "kalman_smooth": [kf[k] for k in ("x_filt", "innovations", "gain",
                                          "innovation_cov", "state_cov",
                                          "x_smooth")],
        "enkf_analysis": port.enkf_analysis(ens, y[:, 0], c, 0.1, 0),
        "etkf_analysis": port.etkf_analysis(ens, y[:, 0], c, [0.1, 0.2]),
        "enkf_filter": [flt["means"], flt["ensemble"], flt["spread"]],
        "esmda": [es["ensemble"], es["mean"], es["predicted"]],
        "particle_filter": [pf["means"], pf["ess"], pf["particles"],
                            pf["log_weights"]],
        "ukf_filter": [uk["means"], uk["covs"]],
        "laplace_approx": [lap.x_map, lap.cov, lap.chol_cov, lap.x_map_all],
        "laplace_sample": port.laplace_sample(lap, 4),
        "bridge_sampling_evidence": [br.proposal_mean, br.proposal_chol],
        "psis": port.psis(rng.standard_normal(50)).log_weights,
        "importance_resample": port.importance_resample(
            draws, rng.standard_normal(200), 10)[0],
    }
    for name, res in results.items():
        tensors = list(res) if isinstance(res, (tuple, list)) else [res]
        assert tensors and all(isinstance(t, torch.Tensor) and t.is_cuda
                               for t in tensors), name
    # the scalars are read back once, at the end of their run
    assert isinstance(smc.log_evidence, float) and isinstance(pf["loglik"],
                                                              float)
    assert isinstance(hmc.accept_ratio, float) and isinstance(nuts.n_divergent,
                                                              int)


def test_slice_psis_keeps_the_weights_on_the_card(dev, monkeypatch):
    # every copy of a CUDA tensor to the host is counted (``.cpu()``,
    # ``.to``, ``.tolist()``): psis may bring the tail and the cutoff for the
    # Pareto fit, never the n weights
    from corrla_rs_tpu_torch.ops import psis as psis_mod

    gen = torch.Generator(device=dev).manual_seed(5)
    n = 200_000
    lw = torch.randn(n, generator=gen, device=dev, dtype=torch.float64) ** 2 \
        * 0.4
    copied = []

    def counted(how):
        real = getattr(torch.Tensor, how)

        def call(self, *args, **kwargs):
            out = real(self, *args, **kwargs)
            if self.is_cuda and not (isinstance(out, torch.Tensor)
                                     and out.is_cuda):
                copied.append(self.numel())
            return out
        return call

    for how in ("cpu", "to", "tolist", "numpy", "__array__"):
        monkeypatch.setattr(torch.Tensor, how, counted(how))
    res = psis_mod.psis(lw)
    smp, _ = psis_mod.importance_resample(lw[:, None], lw, 1000, key=1)
    monkeypatch.undo()
    assert res.n_tail == 1342 and copied
    assert max(copied) <= res.n_tail + 1, copied
    assert res.log_weights.is_cuda and smp.is_cuda
    want = psis_mod.psis(lw.cpu())
    assert res.k_hat == pytest.approx(want.k_hat, abs=1e-10)
    assert float((res.log_weights.cpu() - want.log_weights).abs().max()) \
        <= 1e-10


def test_slice_polynomial_fits_take_the_batched_pinv_on_the_card(
        dev, monkeypatch):
    from corrla_rs_tpu_torch.ops import mat_utils, stats_corr

    calls = []
    real = mat_utils.pinv_batched
    monkeypatch.setattr(mat_utils, "pinv_batched",
                        lambda a, eps=1e-14: calls.append(tuple(a.shape))
                        or real(a, eps))
    gen = torch.Generator(device=dev).manual_seed(7)
    x = torch.randn(1024, 40, 3, generator=gen, device=dev,
                    dtype=torch.float64)
    y = torch.randn(1024, 40, 1, generator=gen, device=dev,
                    dtype=torch.float64)
    coeffs = stats_corr.quad_fit(x, y)
    assert calls == [(1024, 40, 10)] and coeffs.is_cuda
    # a small batch keeps torch.linalg.svd, and both agree with the CPU
    few = stats_corr.quad_fit(x[:16], y[:16])
    assert calls == [(1024, 40, 10)]
    want = stats_corr.quad_fit(x.cpu(), y.cpu())
    scale = float(want.abs().max())
    assert float((coeffs.cpu() - want).abs().max()) <= 1e-9 * scale
    assert float((few.cpu() - want[:16]).abs().max()) <= 1e-9 * scale


# ---------------------------------------------------------------------------
# Gaussian processes, Bayesian optimisation, Grassmann interpolation and the
# ROM models on the card

@pytest.mark.parametrize("dtype,cols", [(torch.float32, 20),
                                        (torch.float64, 16)])
@pytest.mark.parametrize("m", [1, 3])
def test_slice_matvec_past_65535_column_chunks(dev, dtype, cols, m):
    # 65,535 chunks of the widest instance and 7 columns more: one launch,
    # every column against the plain version, and a bit-identical rerun
    n, c = 16, 65535 * cols + 7
    gen = torch.Generator(device=dev).manual_seed(m)
    q = torch.randn(m, 2, generator=gen, device=dev, dtype=dtype)
    x = torch.randn(n, 2, generator=gen, device=dev, dtype=dtype)
    coef = torch.randn(n, c, generator=gen, device=dev, dtype=dtype)
    plan = rk._matvec_plan(m, n, c, rk._sm_count(dev), coef.element_size())
    assert plan.col_chunks > rk._MV_MAX_GRID_YZ and plan.splits == 1
    before = rk.rbf_matvec.launches
    got = rk.rbf_matvec(q, x, coef, "linear", 1.0)
    torch.cuda.synchronize()
    assert rk.rbf_matvec.launches == before + 1
    qd, xd, cd = q.double(), x.double(), coef.double()
    want = rk.rbf_matvec_ref(qd, xd, cd, "linear", 1.0)
    scale = rk.rbf_matvec_ref(qd, xd, cd.abs(), "linear", 1.0)
    assert bool(((got.double() - want).abs() <= MATVEC_RTOL[dtype] * scale)
                .all())
    assert torch.equal(got, rk.rbf_matvec(q, x, coef, "linear", 1.0))


def _plain_dists_grads(xa, xb, g):
    """(dxa, dxb) of sum(g * ||xa_i - xb_j||) by autograd through the plain
    distances, zero where the distance is 0."""
    xa = xa.detach().requires_grad_(True)
    xb = xb.detach().requires_grad_(True)
    diff = xa[:, None, :] - xb[None, :, :]
    sq = torch.sum(diff * diff, dim=-1)
    live = sq > 0
    r = torch.where(live, torch.sqrt(torch.where(live, sq, 1.0)), 0.0)
    return torch.autograd.grad(torch.sum(g * r), (xa, xb))


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_slice_pairwise_dists_function_on_the_card(dev, dtype):
    # forward: the kernel matrix with phi = linear, one counted launch;
    # backward: plain PyTorch, equal to autograd through the plain distances
    # (rows of xa repeated in xb: R = 0 there, and the gradient 0)
    from corrla_rs_tpu_torch.ops import interp

    gen = torch.Generator(device=dev).manual_seed(7)
    xa = torch.randn(37, 5, generator=gen, device=dev, dtype=dtype)
    xb = torch.cat([xa[:4], torch.randn(50, 5, generator=gen, device=dev,
                                        dtype=dtype)])
    g = torch.randn(37, 54, generator=gen, device=dev, dtype=dtype)
    a, b = xa.clone().requires_grad_(True), xb.clone().requires_grad_(True)
    before = rk.pairwise_kernel_matrix.launches
    r = interp.pairwise_dists(a, b)
    assert rk.pairwise_kernel_matrix.launches == before + 1
    want = rk.pairwise_dists(xa.double(), xb.double())
    assert bool(((r.double() - want).abs()
                 <= KMAT_RTOL[dtype] * want.abs().max()).all())
    assert bool((torch.diagonal(r[:4, :4]) == 0).all())
    da, db = torch.autograd.grad(torch.sum(g * r), (a, b))
    wa, wb = _plain_dists_grads(xa.double(), xb.double(), g.double())
    tol = 1e-12 if dtype == torch.float64 else 1e-4
    for got, ref in ((da, wa), (db, wb)):
        assert float((got.double() - ref).abs().max()) <= tol * float(
            ref.abs().max())
    # torch.func takes the Function too, as the GPs' MLE and BayesOpt use it
    fa = torch.func.grad(lambda t: torch.sum(g * interp.pairwise_dists(
        t, xb)))(xa)
    assert torch.equal(fa, da)


def test_slice_pairwise_dists_gradcheck_on_the_card(dev):
    from corrla_rs_tpu_torch.ops import interp

    gen = torch.Generator(device=dev).manual_seed(8)
    xa = torch.randn(6, 3, generator=gen, device=dev, dtype=torch.float64,
                     requires_grad=True)
    xb = torch.randn(9, 3, generator=gen, device=dev, dtype=torch.float64,
                     requires_grad=True)
    before = rk.pairwise_kernel_matrix.launches
    assert torch.autograd.gradcheck(interp.pairwise_dists, (xa, xb))
    assert rk.pairwise_kernel_matrix.launches > before


def test_slice_gp_and_grassmann_launch_their_kernels(dev):
    # the GPs' distances launch the kernel matrix; Grassmann interpolation
    # launches it in its fit and the matvec in its predict; each equal to
    # the same computation on the CPU in f64
    import numpy as np

    from corrla_rs_tpu_torch.ops import gp, grassmann

    rng = np.random.default_rng(9)
    x = rng.uniform(-1, 1, (40, 3))
    y = np.sin(2 * x[:, 0]) + 0.1 * x[:, 1]
    xq = rng.uniform(-1, 1, (25, 3))
    hyp = ("matern52", 0.7, 1.3, 1e-3)
    before = rk.pairwise_kernel_matrix.launches
    card = gp.GpRegressor(*hyp, device=dev).fit(x, y, optimize_hypers=False)
    mc, vc = card.predict(xq)
    assert rk.pairwise_kernel_matrix.launches >= before + 2 and mc.is_cuda
    cpu = gp.GpRegressor(*hyp, device="cpu").fit(x, y, optimize_hypers=False)
    mp, vp = cpu.predict(xq)
    assert float((mc.cpu() - mp).abs().max()) <= 1e-10 * float(
        mp.abs().max())
    assert float((vc.cpu() - vp).abs().max()) <= 1e-10 * float(
        vp.abs().max())
    fitted = gp.GpRegressor("rbf", device=dev).fit(x, y)
    assert fitted.x_train.is_cuda and np.isfinite(fitted.noise_var)

    q = np.linalg.qr(rng.standard_normal((3, 300, 4)))[0]
    bases = np.linalg.qr(q[0] + 0.2 * np.arange(9)[:, None, None] / 9
                         * q[1] + 0.1 * (np.arange(9) % 3)[:, None, None]
                         * q[2])[0]
    params = np.stack([np.arange(9) / 9, np.arange(9) % 3], 1)
    before = (rk.pairwise_kernel_matrix.launches, rk.rbf_matvec.launches)
    gi = grassmann.GrassmannInterp(bases, params, ref=4, device=dev)
    theta = np.array([[0.3, 1.2], [0.5, 0.4]])
    yc = gi(theta)
    after = (rk.pairwise_kernel_matrix.launches, rk.rbf_matvec.launches)
    assert after[0] > before[0] and after[1] > before[1] and yc.is_cuda
    yp = grassmann.GrassmannInterp(bases, params, ref=4, device="cpu")(theta)
    assert float((yc.cpu() @ yc.cpu().mT - yp @ yp.mT).abs().max()) <= 1e-10


def test_slice_gp_rom_entry_points_put_numpy_on_the_card(dev):
    # numpy in, tensors on the card out, whatever the size; okid and spdmd
    # return host numpy by design, as the JAX package's do
    import numpy as np

    import corrla_rs_tpu_torch as port

    rng = np.random.default_rng(11)
    x = rng.uniform(-1, 1, (20, 2))
    y = np.sin(3 * x[:, 0])
    sig = np.sin(0.4 * np.arange(60)) + 0.5 * np.cos(0.9 * np.arange(60))
    field = np.outer(rng.standard_normal(12), np.cos(0.1 * np.arange(40)))
    q = np.linalg.qr(rng.standard_normal((3, 30, 2)))[0]
    u = np.linalg.qr(rng.standard_normal((50, 4)))[0]
    a_sys = 0.5 * np.eye(3)
    u_in = rng.standard_normal((1, 200))
    y_out = np.stack([np.convolve(u_in[0], 0.5 ** np.arange(30))[:200]])
    gpr = port.GpRegressor("rbf", 0.5, 1.0, 1e-3).fit(x, y,
                                                      optimize_hypers=False)
    sgp = port.SparseGpRegressor(inducing=8).fit(x, y, optimize_hypers=False)
    bo = port.BayesOpt([[0.0, 1.0], [0.0, 1.0]], n_candidates=64,
                       n_grad_steps=2).tell(x[:4] / 2 + 0.5, y[:4])
    hd = port.HankelDmd(sig, n_delays=6, n_modes=4)
    mr = port.mrdmd(field, n_modes=2, max_levels=2)
    pid = port.PiDmd(field, 2, family="orthogonal")
    er = port.era(np.stack([a_sys[:1, :1] ** k for k in range(10)]), 1)
    eo = port.era_okid(u_in, y_out, 1)
    od = port.OnlineDmd(3).fit_stream(rng.standard_normal((3, 20)))
    pts, proj = port.deim_points(u)
    results = {
        "GpRegressor": list(gpr.predict(x[:5])) + [gpr.predict_cov(x[:3]),
                                                  gpr.sample_posterior(
                                                      x[:3], 2)],
        "SparseGpRegressor": list(sgp.predict(x[:5])),
        "latin_hypercube": port.latin_hypercube([[0, 1], [0, 2]], 5),
        "sobol_sample": port.sobol_sample([[0, 1], [0, 2]], 8),
        "halton_sample": port.halton_sample([[0, 1], [0, 2]], 5),
        "BayesOpt.ask": bo.ask(),
        "bayes_opt_minimize": [port.bayes_opt_minimize(
            lambda p: float(torch.sum(p * p)), [[-1.0, 1.0]], n_init=3,
            n_iters=1, n_candidates=32, n_grad_steps=2)[i] for i in (0, 2)],
        "GrassmannInterp": port.GrassmannInterp(q, [[0.0], [0.5], [1.0]])(
            np.array([0.25])),
        "grassmann_log": port.grassmann_log(q[0], q[1]),
        "grassmann_exp": port.grassmann_exp(q[0], q[1] * 0.1),
        "subspace_angles": port.subspace_angles(q[0], q[1]),
        "grassmann_distance": port.grassmann_distance(q[0], q[1]),
        "HankelDmd": [hd.forecast(5), hd.modes_re],
        "hankel_embed": port.hankel_embed(field, 3),
        "mrdmd": mr.reconstruct(),
        "PiDmd": pid.predict_multiple(field[:, 0], 3),
        "era": [er.a, er.predict(np.ones((1, 4)))],
        "era_okid": eo.predict(u_in[:, :10]),
        "OnlineDmd": [od.a, od.predict(np.ones(3), n_steps=3)],
        "deim_points": [pts, proj],
        "deim_reconstruct": port.deim_reconstruct(u, proj.cpu().numpy(),
                                                  u[pts.cpu().numpy()]),
        "gappy_reconstruct": list(port.gappy_reconstruct(
            u, pts.cpu().numpy(), u[pts.cpu().numpy()])),
        "gappy_pod_fill": list(port.gappy_pod_fill(
            field, rng.random(field.shape) < 0.8, 1, n_sweeps=2)),
        "oversample_points": port.oversample_points(u, pts.cpu().numpy(), 2),
    }
    for name, res in results.items():
        tensors = res if isinstance(res, list) else [res]
        assert tensors and all(isinstance(t, torch.Tensor) and t.is_cuda
                               for t in tensors), name
    markov, d = port.okid(u_in, y_out, 5)
    assert isinstance(markov, np.ndarray) and markov.shape == (5, 1, 1)
    sp = port.spdmd(port.DMD(field, 2), field, [0.0, 1.0])
    assert sp["nnz"].shape == (2,)


def test_slice_edmd_rbf_lift_launches_the_kernel_matrix(dev):
    # Edmd's RBF dictionary is the kernel matrix (gaussian, eps =
    # sqrt(gamma)) written into its rows of the lifted matrix; the fit on
    # the card equals the CPU fit in f64
    import numpy as np

    from corrla_rs_tpu_torch.models import edmd

    rng = np.random.default_rng(12)
    x = rng.uniform(-1, 1, (2, 3000))
    y = np.stack([0.9 * x[0], 0.8 * x[1] + 0.2 * x[0] ** 2])
    # 12 centres, gamma 2: a Gram of condition ~1e6, so the two fits' K
    # agree to 1e-8 (40 centres at gamma 3 reach 7e9)
    centers = rng.uniform(-1, 1, (12, 2))
    kw = dict(dictionary="rbf", centers=centers, gamma=2.0, y_data=y)
    before = rk.pairwise_kernel_matrix.launches
    card = edmd.Edmd(x, device=dev, **kw)
    assert rk.pairwise_kernel_matrix.launches == before + 2
    cpu = edmd.Edmd(x, device="cpu", **kw)
    lc, lp = card.lift(x[:, :100]), cpu.lift(x[:, :100])
    assert lc.is_cuda and float((lc.cpu() - lp).abs().max()) <= 1e-13
    assert float((card.koopman.cpu() - cpu.koopman).abs().max()) <= 1e-8 \
        * float(cpu.koopman.abs().max())
    out = torch.empty(12, 3000, dtype=torch.float64, device=dev)
    xt = torch.as_tensor(x, device=dev)
    ct = torch.as_tensor(centers, device=dev)
    edmd._rbf_features_into(out, xt, ct, 2.0)
    gram = edmd._rbf_features_gram(xt, ct, 2.0)
    assert float((out - gram).abs().max()) <= 1e-13


def test_slice_koopman_uq_entry_points_put_numpy_on_the_card(dev):
    # numpy in, tensors on the card out; what the JAX package returns as
    # host numpy (KernelDmd's and the bagged fits' forecasts, the
    # quadrature rules, the closed-form Shapley effects, the Monte-Carlo
    # estimators' floats) stays host numpy here
    import numpy as np

    import corrla_rs_tpu_torch as port

    rng = np.random.default_rng(13)
    traj = np.cumsum(rng.standard_normal((3, 80)), axis=1) * 0.1
    lor = np.stack([np.sin(0.05 * np.arange(400)),
                    np.cos(0.07 * np.arange(400)),
                    np.sin(0.03 * np.arange(400))], axis=1)
    snaps = rng.standard_normal((30, 3)) @ rng.standard_normal((3, 60))
    bounds = [[0.0, 1.0]] * 3

    def f(v):
        return v[:, 0] + v[:, 1] * v[:, 2]

    ed = port.Edmd(traj, degree=2)
    kd = port.KernelDmd(traj, 4)
    sp = port.spod(snaps, n_fft=16)
    oi = port.OpInf(2).fit(snaps.T[:, :20], dt=0.1)
    sy = port.Sindy(degree=2, threshold=0.01).fit(lor, dt=0.1)
    od = port.OptDmd(snaps, 3)
    pce = port.PolynomialChaos(2, bounds=bounds).fit(
        rng.uniform(0, 1, (40, 3)), rng.standard_normal(40))
    results = {
        "Edmd": [ed.koopman, ed.predict(traj[:, 0], 3), ed.lift(traj)],
        "KernelDmd": [kd._x_train],
        "spod": [sp.energies, sp.modes_re, sp.modes_im],
        "OpInf": [oi.basis_, oi.predict(snaps.T[0, :20], 3, 0.1)],
        "kron2_compressed": port.kron2_compressed(np.ones(3)),
        "Sindy": [sy.coefficients_, sy.predict(lor[:3]),
                  sy.simulate(lor[0], 3, 0.1)],
        "OptDmd": [od.modes_re, od.predict(np.arange(4.0))],
        "bop_dmd": port.bop_dmd(snaps, 3, n_members=2).modes_re,
        "bagged_dmd": port.bagged_dmd(snaps, 3, n_members=2).modes_ref_re,
        "PolynomialChaos": [pce.coeffs, pce.predict(np.ones((2, 3)))]
        + list(pce.sobol_indices().values()),
        "saltelli_plan": list(port.saltelli_plan(bounds, 8)),
        "sobol_indices": list(port.sobol_indices(f, bounds, 64,
                                                 n_boot=4).values()),
        "morris_trajectories": list(port.morris_trajectories(bounds, 4)),
        "morris_screening": list(port.morris_screening(f, bounds,
                                                       8).values()),
        "shapley_effects": port.shapley_effects(
            lambda v: v.sum(dim=1), np.zeros(2), np.eye(2), n_outer=8,
            n_inner=4),
    }
    for name, res in results.items():
        tensors = res if isinstance(res, list) else [res]
        assert tensors and all(isinstance(t, torch.Tensor) and t.is_cuda
                               for t in tensors), name
    assert isinstance(kd.predict(traj[:, 0], 3), np.ndarray)
    rule = port.smolyak_quadrature(2, 2)
    assert isinstance(rule.nodes, np.ndarray)
    assert abs(port.integrate(lambda v: v.sum() ** 2, rule)
               - 8.0 / 3.0) < 1e-12
    assert isinstance(port.shapley_effects_linear([1.0, 2.0], np.eye(2)),
                      np.ndarray)
    q = port.shapley_effects_quadrature(lambda v: v[:, 0] * v[:, 1],
                                        mean=np.zeros(2), std=np.ones(2))
    assert isinstance(q["shapley"], np.ndarray)

    def draw(g, n):
        assert g.device.type == "cuda"
        return torch.randn(n, 1, generator=g, device=dev,
                           dtype=torch.float64)

    ml = port.mlmc_estimate([lambda v: v[:, 0] ** 2] * 2, draw, [1.0, 2.0],
                            n_pilot=16, n_max=256)
    mf = port.mfmc_estimate([lambda v: v[:, 0] ** 2,
                             lambda v: v[:, 0] ** 2 + 0.5 * v[:, 0]],
                            draw, [1.0, 0.01], 50.0, n_pilot=20)
    assert np.isfinite(ml.mean) and np.isfinite(mf.mean)
    assert np.isfinite(port.control_variate_estimate(
        np.arange(5.0), np.arange(5.0) ** 1.5, 2.0)[0])


# ---------------------------------------------------------------------------
# out-of-core streaming and the statistics layer
# ---------------------------------------------------------------------------


@pytest.fixture
def stats_cpu_draws(cpu_draws, monkeypatch):
    """The statistics layer's seams drawn by a CPU generator of the key's
    seed and moved to the device, as ``cpu_draws`` does for the sketch."""
    from corrla_rs_tpu_torch.ops import cma, gmm, vine

    def moved(real, n_lead):
        def draw(key, *args):
            lead, dev = args[:n_lead], args[n_lead]
            out = real(_seed_of(key), *lead, "cpu", *args[n_lead + 1:])
            if isinstance(out, tuple):
                return tuple(t.to(dev) for t in out)
            return out.to(dev)
        return draw

    monkeypatch.setattr(gmm, "_draw_kmeanspp", moved(gmm._draw_kmeanspp, 3))
    monkeypatch.setattr(gmm, "_draw_sample", moved(gmm._draw_sample, 4))
    monkeypatch.setattr(cma, "_draw_normals", moved(cma._draw_normals, 4))
    monkeypatch.setattr(vine, "_draw_uniform", moved(vine._draw_uniform, 2))


def _stream_source(n=3001, m=24):
    import numpy as np

    rng = _np_rng()
    u, _ = np.linalg.qr(rng.standard_normal((n, m)))
    v, _ = np.linalg.qr(rng.standard_normal((m, m)))
    return (u * np.arange(1.0, m + 1) ** -2.0) @ v.T + 0.1


def _case_streaming(d):
    import numpy as np

    from corrla_rs_tpu_torch.ops import streaming as st

    a = _stream_source()
    out = [st.streamed_cov(a, block_rows=512, devices=d),
           st.streamed_pearson_corr(a, block_rows=512, devices=d)]
    for method, center in (("gram", False), ("gram", True),
                           ("power", False)):
        u, s, vt = st.streamed_random_svd(
            a, 6, 4, 6, key=3, block_rows=512, method=method, center=center,
            devices=d if method == "gram" else None)
        out += [s, _proj(u), _proj(vt.mT)]
    rng = _np_rng()
    t = np.einsum("abc,ia,jb,kc->ijk", rng.standard_normal((3, 2, 2)),
                  np.linalg.qr(rng.standard_normal((700, 3)))[0],
                  np.linalg.qr(rng.standard_normal((6, 2)))[0],
                  np.linalg.qr(rng.standard_normal((5, 2)))[0])
    core, factors = st.streamed_hosvd(t, (3, 2, 2), block_slabs=128,
                                      device=d)
    out += [core.abs()] + [_proj(f) for f in factors]
    xg = np.linspace(0, 10, 5000)
    tg = np.linspace(1, 9, 24)[:, None]
    pod = st.streamed_pod((0.5 * tg) * np.exp(-(xg[None] - tg) ** 2 / 4.0),
                          tg, 4, block_cols=1500, device=d)
    out += [_proj(pod.modes), pod.predict(np.array([[2.5], [7.7]]))]
    x = np.sin(np.linspace(0, 10, 3000)[:, None]
               + 0.2 * np.linspace(0, 10, 30)[None, :])
    dmdc = st.streamed_dmdc(x, np.exp(0.02 * np.arange(30.0))[None, :], 6,
                            block_rows=700, device=d)
    out += [dmdc.predict_multiple(x[:, :1], np.ones((1, 10)),
                                  method="modes")]
    return out


def _case_stats(d):
    import numpy as np

    import corrla_rs_tpu_torch as port

    rng = _np_rng()
    x = np.concatenate([rng.normal(m, 0.5, (200, 3)) for m in (-3, 0, 3)])
    fit = port.gmm_fit(x, 3, key=1, device=d)
    out = [fit.means, fit.covs, fit.log_likelihood,
           port.gmm_logpdf(fit, x[:20]), port.gmm_sample(fit, 2, 50)]
    xa = rng.standard_normal((400, 4))
    ya = xa[:, :2] @ rng.standard_normal((2, 3)) + rng.standard_normal(
        (400, 3))
    cc = port.cca(xa, ya, device=d)
    out += [torch.as_tensor(cc.corrs, device=d),
            cc.x_weights.abs(), cc.y_weights.abs()]
    pls = port.pls_fit(xa, ya, 3, device=d)
    out += [pls.coef, pls.predict(xa[:10])]
    z = rng.standard_normal((600, 3)) @ np.linalg.cholesky(
        np.array([[1, .6, .3], [.6, 1, .4], [.3, .4, 1]])).T
    gc = port.GaussianCopula().fit(z, device=d)
    out += [gc.corr, gc.sample(100, key=2)]
    bc = port.BivariateCopula().fit(z[:, :2], device=d)
    cv = port.CVineCopula().fit(z, device=d)
    rv = port.RVineCopula().fit(z, device=d)
    out += [torch.tensor([bc.theta] + [th for row in cv.pairs
                                       for _f, th in row]).to(d),
            cv.sample(100, key=3), rv.logpdf_uniform(rng.uniform(
                0.05, 0.95, (50, 3)))]
    return out


def _with_default(device, fn):
    """fn(device) with numpy inputs going to ``device`` (the streamed
    power method takes no device argument, as in the JAX package)."""
    from corrla_rs_tpu_torch.utils.device import (default_device,
                                                  set_default_device)

    prev = default_device()
    set_default_device(device)
    try:
        return fn(device)
    finally:
        set_default_device(prev)


@pytest.mark.parametrize("case", ["streaming", "stats"])
def test_slice_stream_stats_on_cuda_match_cpu_f64(dev, stats_cpu_draws,
                                                  case):
    # f64 on both, 1e-8 of each result's largest entry (cuBLAS/cuSOLVER
    # against LAPACK; the EM loop carries its rounding along). CMA-ES is
    # not compared: its candidates follow the signs of the covariance's
    # eigenvectors, which cuSOLVER and LAPACK choose apart
    fn = _case_streaming if case == "streaming" else _case_stats
    on_card = _with_default(dev, fn)
    on_cpu = _with_default(torch.device("cpu"), fn)
    assert len(on_card) == len(on_cpu)
    for i, (got, want) in enumerate(zip(on_card, on_cpu)):
        assert got.device.type == "cuda" and want.device.type == "cpu", i
        scale = max(float(want.abs().max()), 1e-30)
        err = float((got.cpu() - want).abs().max())
        assert err <= 1e-8 * scale, (case, i, err, scale)


def test_slice_streamed_single_pass_on_the_card(dev):
    # not compared with the CPU run: a block's Psi key folds from a child
    # generator on the data's device, whose draws differ from the CPU's
    import numpy as np

    from corrla_rs_tpu_torch.ops import streaming as st

    rng = _np_rng()
    low = rng.standard_normal((3001, 5)) @ rng.standard_normal((5, 24))
    u, s, vt = st.streamed_single_pass_svd(low, 5, 6, key=2, block_rows=512,
                                           device=dev)
    rec = (u * s) @ vt
    assert rec.is_cuda
    assert float(torch.linalg.matrix_norm(rec.cpu() - torch.as_tensor(low))
                 / np.linalg.norm(low)) < 1e-9


def test_slice_streamed_pod_launches_both_kernels(dev):
    # the streamed POD's weight fit writes K into its saddle matrix, its
    # predict goes through the matvec
    import numpy as np

    from corrla_rs_tpu_torch.ops import streaming as st

    xg = np.linspace(0, 10, 4000, dtype=np.float32)
    tg = np.linspace(1, 9, 30, dtype=np.float32)[:, None]
    snaps = (0.5 * tg) * np.exp(-(xg[None] - tg) ** 2 / 4.0)
    k0, m0 = rk.pairwise_kernel_matrix.launches, rk.rbf_matvec.launches
    pod = st.streamed_pod(snaps, tg, 5, block_cols=1000)
    assert rk.pairwise_kernel_matrix.launches == k0 + 1
    pred = pod.predict(np.array([[2.5], [7.7]], np.float32))
    assert rk.rbf_matvec.launches == m0 + 1
    assert pred.is_cuda and pred.shape == (4000, 2)


def test_slice_streamed_fit_peak_memory_stays_below_the_source(dev):
    # 65,536 x 1,024 f32 (268 MB) streamed in 8 MB blocks: the device never
    # holds the source
    import numpy as np

    from corrla_rs_tpu_torch.ops import streaming as st

    a = np.random.default_rng(0).standard_normal((65536, 1024)).astype(
        np.float32)
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats(dev)
    base = torch.cuda.memory_allocated(dev)
    u, s, vt = st.streamed_random_svd(a, 10, 2, 10, block_rows=2048,
                                      devices=dev)
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated(dev) - base
    assert u.is_cuda and s.shape == (10,)
    assert peak < a.nbytes / 4, (peak, a.nbytes)
    assert bool(torch.isfinite(s).all())


def test_slice_stream_stats_entry_points_put_numpy_on_the_card(dev):
    # numpy in, tensors on the card out, for every new entry point
    import numpy as np

    import corrla_rs_tpu_torch as port
    from corrla_rs_tpu_torch.ops import streaming, vine

    rng = np.random.default_rng(14)
    a = rng.standard_normal((700, 12)).astype(np.float32)
    z = rng.standard_normal((400, 3)) @ np.array(
        [[1.0, 0.5, 0.2], [0, 1.0, 0.4], [0, 0, 1.0]])
    src = port.RowBlockSource(lambda lo, hi: a[lo:hi], a.shape)
    snaps = rng.standard_normal((20, 900)).astype(np.float32)
    x = rng.standard_normal((300, 12))
    fit = port.gmm_fit(x[:, :2], 2, n_iter=5)
    cc = port.cca(x[:, :4], x[:, 4:8] + x[:, :4])
    pls = port.pls_fit(x, x[:, 0] + 0.1 * x[:, 1], 2)
    gc = port.GaussianCopula().fit(z)
    bc = port.BivariateCopula().fit(z[:, :2])
    cv = port.CVineCopula().fit(z)
    rv = port.RVineCopula().fit(z)
    results = {
        "streamed_gram": list(streaming.streamed_gram(src, 128)[:2]),
        "streamed_cov": port.streamed_cov(a, 128),
        "streamed_pearson_corr": port.streamed_pearson_corr(a, 128),
        "streamed_random_svd": list(port.streamed_random_svd(a, 3, 2)),
        "streamed_single_pass_svd": list(port.streamed_single_pass_svd(a,
                                                                       3)),
        "streamed_pca": list(port.streamed_pca(a, 3)),
        "streamed_hosvd": [port.streamed_hosvd(
            a.reshape(700, 3, 4), (2, 2, 2))[0]],
        "streamed_pod": [port.streamed_pod(snaps, np.arange(20.0)[:, None],
                                           3).modes],
        "streamed_dmdc": [port.streamed_dmdc(snaps.T, np.ones((1, 20)),
                                             3)._A],
        "gmm_fit": [fit.means, fit.n_iter],
        "gmm_logpdf": port.gmm_logpdf(fit, x[:5, :2]),
        "gmm_sample": port.gmm_sample(fit, 0, 5),
        "gmm_select": [port.gmm_select(x[:, :2], [1, 2], n_iter=5)[0].means],
        "cma_es": [port.cma_es(lambda v: (v ** 2).sum(), np.ones(3),
                               n_gens=5).x_best],
        "cca": [cc.x_weights, cc.transform(x[:3, :4])[0]],
        "pls_fit": [pls.coef, pls.predict(x[:3]), pls.transform(x[:3])],
        "GaussianCopula": [gc.corr, gc.sample(5)],
        "BivariateCopula": [bc.sample(5), bc.logpdf_uniform(
            np.array([0.3]), np.array([0.6]))],
        "CVineCopula": [cv.sample(5), cv.sample_uniform(5)],
        "RVineCopula": [rv.sample(5), rv.logpdf_uniform(
            rng.uniform(0.1, 0.9, (4, 3)))],
        "kendall_tau": vine.kendall_tau(z[:, 0], z[:, 1]),
    }
    for name, res in results.items():
        tensors = res if isinstance(res, list) else [res]
        assert tensors and all(isinstance(t, torch.Tensor) and t.is_cuda
                               for t in tensors), name
    assert isinstance(cc.corrs, np.ndarray)


def test_slice_gmm_logpdf_at_a_million_points_matches_the_cpu(dev):
    # 1,048,576 points x 32 components in 16-D f64: the triangular solves
    # go 65,536 points at a time (one solve of every point came back wrong
    # on the card)
    from corrla_rs_tpu_torch.ops import gmm

    gen = torch.Generator().manual_seed(3)
    f64 = torch.float64
    x = 30.0 * torch.randn(1 << 20, 16, generator=gen, dtype=f64)
    means = 30.0 * torch.randn(32, 16, generator=gen, dtype=f64)
    a = torch.randn(32, 16, 16, generator=gen, dtype=f64)
    chols = torch.linalg.cholesky(a @ a.mT + 16 * torch.eye(16, dtype=f64))
    want = gmm._component_logpdf(x, means, chols)
    got = gmm._component_logpdf(x.to(dev), means.to(dev), chols.to(dev))
    assert float((got.cpu() - want).abs().max()) <= 1e-10 * float(
        want.abs().max())


def test_slice_cma_es_converges_on_the_card(dev):
    import numpy as np

    import corrla_rs_tpu_torch as port

    res = port.cma_es(lambda v: torch.sum((v - 1.5) ** 2), np.zeros(6),
                      sigma0=0.5, n_gens=250, key=0, device=dev)
    assert res.x_best.is_cuda and res.history.is_cuda
    assert res.f_best < 1e-10
    assert float((res.x_best - 1.5).abs().max()) < 1e-5


# ---------------------------------------------------------------------------
# the multi-device layer on the card: a world of one rank under NCCL


@pytest.fixture(scope="module")
def nccl_world(tmp_path_factory):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from _torch_dist import World

    world = World(1, str(tmp_path_factory.mktemp("nccl")), backend="nccl",
                  device="cuda")
    yield world
    world.close()


def _spectrum_matrix(n, m, n_sig, seed):
    import numpy as np

    rng = np.random.default_rng(seed)
    s = np.logspace(0, -3, n_sig)
    u = np.linalg.qr(rng.standard_normal((n, n_sig)))[0]
    v = np.linalg.qr(rng.standard_normal((m, n_sig)))[0]
    return ((u * s) @ v.T).astype(np.float32), s, rng


def test_slice_sharded_rsvd_nccl_matches_random_svd(nccl_world):
    import numpy as np

    a, s_true, rng = _spectrum_matrix(20_000, 1000, 120, 1)
    omega = rng.standard_normal((1000, 60)).astype(np.float32)
    r = nccl_world.run("rsvd", a, 50, 6, 10, {0: omega}, "always")[0]
    u, s, vt = r["usv"]
    assert r["placements"] == ["S(0)"] and r["local"] == (20_000, 50)
    assert float(np.max(np.abs(s - s_true[:50]) / s_true[:50])) <= 1e-3
    # the single-device random_svd on the card, same sketch
    single = r["single"][1]
    assert float(np.max(np.abs(s - single) / single)) <= 1e-5


def test_slice_sharded_podi_on_the_card_matches_cpu_f64(nccl_world,
                                                        monkeypatch):
    import numpy as np

    from corrla_rs_tpu_torch.models.pod import PodI
    from corrla_rs_tpu_torch.ops import random_svd

    t = np.linspace(0.0, 1.0, 40)[:, None]
    s = np.linspace(0.0, 1.0, 4000)[None, :]
    p = np.exp(-t * s) + 0.3 * np.sin(2 * np.pi * s * t)
    tq = np.array([[0.13], [0.5], [0.77]])
    omega = np.random.default_rng(2).standard_normal((40, 16))
    r = nccl_world.run("pod", p, t, 6, {0: omega}, tq)[0]
    # both kernels ran on the card: the fit's kernel matrix, the matvec
    assert all(n >= 1 for n in r["launches"]), r["launches"]
    assert r["pred_placements"] == ["S(0)"]
    monkeypatch.setattr(random_svd, "_draw_sketch",
                        lambda seed, shape, dtype, device: torch.as_tensor(
                            omega, dtype=dtype, device=device))
    want = PodI(p, t, 6, device="cpu").predict(
        torch.as_tensor(tq)).numpy()
    assert float(np.max(np.abs(r["pred"] - want))) <= 1e-8 * float(
        np.max(np.abs(want)))


@pytest.mark.parametrize("dtype,rtol", [(torch.float32, 1e-6),
                                        (torch.float64, 1e-12)])
def test_slice_export_serves_kernels_on_the_card(dev, tmp_path, dtype, rtol):
    # PodI.predict exports with its matvec as a corrla::rbf_matvec node; the
    # loaded program launches the kernel once a call and gives the eager
    # predict; a fresh process that imports torch and the operators' module
    # (no JAX) serves it
    import os
    import subprocess
    import sys

    from corrla_rs_tpu_torch.models.pca import PcaRsvd
    from corrla_rs_tpu_torch.models.pod import PodI
    from corrla_rs_tpu_torch.utils.export import (
        export_model_call,
        load_exported,
    )

    gen = torch.Generator(device=dev).manual_seed(5)
    x = torch.randn(64, 400, generator=gen, device=dev, dtype=dtype)
    t = torch.linspace(0, 1, 64, device=dev, dtype=dtype)[:, None]
    pod = PodI(x, t, 4)
    tq = torch.rand(9, 1, generator=gen, device=dev, dtype=dtype)
    path = str(tmp_path / "p.pt2")
    program = export_model_call(pod, "predict", (tq,), path)
    targets = [str(n.target) for n in program.graph.nodes
               if n.op == "call_function"]
    assert targets.count("corrla.rbf_matvec.default") == 1
    assert not any("sqrt" in t for t in targets)
    want = pod.predict(tq)
    before = rk.rbf_matvec.launches
    got = load_exported(path)(tq)
    torch.cuda.synchronize()
    assert rk.rbf_matvec.launches == before + 1
    scale = float(want.abs().max())
    assert float((got - want).abs().max()) <= rtol * scale
    torch.save((tq,), str(tmp_path / "args.pt"))
    serve = ("import sys\nimport torch\n"
             "import corrla_rs_tpu_torch.ops.rbf_kernels\n"
             "call = torch.export.load(sys.argv[1]).module()\n"
             "torch.save(call(*torch.load(sys.argv[2])), sys.argv[3])\n"
             "assert 'jax' not in sys.modules\n")
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    res = subprocess.run(
        [sys.executable, "-c", serve, path, str(tmp_path / "args.pt"),
         str(tmp_path / "out.pt")], capture_output=True, text=True,
        timeout=600, env=dict(os.environ, PYTHONPATH=root))
    assert res.returncode == 0, res.stderr[-2000:]
    served = torch.load(str(tmp_path / "out.pt"))
    assert served.is_cuda
    assert float((served - want).abs().max()) <= rtol * scale
    # a method that reaches no kernel exports on the card as before
    pca = PcaRsvd(x, 4)
    export_model_call(pca, "apply_tr", (x[:5],), str(tmp_path / "a.pt2"))
    got = load_exported(str(tmp_path / "a.pt2"))(x[:5])
    want = pca.apply_tr(x[:5])
    assert got.is_cuda
    assert float((got - want).abs().max()) <= rtol * float(want.abs().max())


@pytest.mark.parametrize("dtype,tol", [(torch.float64, 1e-10),
                                       (torch.float32, 1e-4)])
@pytest.mark.parametrize("shape", [(12, 12), (40, 40), (6, 8, 8)])
def test_slice_eig_device_on_the_card_matches_cpu(dev, dtype, tol, shape):
    # the Francis QR on the card (its rounds replay CUDA graphs) against the
    # CPU port (eager rounds) on the same matrix
    from corrla_rs_tpu_torch.ops.eig_device import eig_device, schur

    gen = torch.Generator(device="cpu").manual_seed(sum(shape))
    a = torch.randn(shape, generator=gen, dtype=dtype)
    got = eig_device(a.to(dev))
    want = eig_device(a)
    lam = torch.complex(got[0], got[1]).cpu().reshape(-1, shape[-1])
    lam0 = torch.complex(want[0], want[1]).reshape(-1, shape[-1])
    scale = float(lam0.abs().max())
    for x, y in zip(lam, lam0):
        d = (x[:, None] - y[None, :]).abs()
        assert float(d.min(1).values.max()) <= tol * scale
    _, q, ok = schur(a.to(dev))
    assert bool(ok.all())
    eye = torch.eye(shape[-1], dtype=dtype, device=dev)
    assert float((q.mT @ q - eye).abs().max()) <= 100 * tol


@pytest.mark.parametrize("panel", ["sketch", "power_step"])
@pytest.mark.parametrize("n,k", [(100_000, 110), (200_000, 30)],
                         ids=["rsvd100k", "pod2k"])
def test_cholesky_qr2_on_the_cells_panels(dev, n, k, panel):
    # the RSVD cells' thin-QR shapes in f32 with TF32 off: Q orthonormal
    # and spanning Y to 100 eps, and within eps * cond(Y) of the rounds
    # that solve over the panel's rows, computed in f64
    import _cholesky_qr_ref as qr_ref
    from corrla_rs_tpu_torch.ops import random_svd

    assert not torch.backends.cuda.matmul.allow_tf32
    y = qr_ref.panels(n, 2_000, k, dev, seed=n + k)[panel]
    got = qr_ref.gaps(random_svd._cholesky_qr2(y), y,
                      qr_ref.solve_round_qr2(y.double()))
    eps = torch.finfo(torch.float32).eps
    assert got["orth"] <= 100 * eps, got
    assert got["recon"] <= 100 * eps, got
    assert got["to_ref"] <= eps * got["cond"], got
