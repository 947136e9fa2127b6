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
