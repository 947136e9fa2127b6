"""Port parity: the plain versions of the two RBF kernels.

``pairwise_kernel_matrix_ref`` / ``rbf_matvec_ref`` (what the wrappers run
for CPU tensors) are held against

- the JAX package's Pallas kernels in interpret mode, at the tolerance of
  tests/test_pallas_kernels.py: the Pallas side computes distances through
  a bf16x3 split Gram expansion, which sets rtol 2e-3 / atol 2e-4 (1e-3 for
  the matvec);
- the JAX XLA path ``rbf_kernel_eval(pairwise_dists(...))`` in f64, to
  1e-12: both compute direct differences, so only summation order differs.

The CUDA kernels themselves are checked on the card (tests/test_torch_cuda.py
and chip_smoke.py).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import cpu_device  # noqa: F401 (fixture)
from corrla_rs_tpu.ops import interp as jax_interp
from corrla_rs_tpu.ops.pallas_kernels import (
    pairwise_kernel_matrix as pallas_kernel_matrix,
    rbf_matvec_streaming as pallas_matvec,
)
from corrla_rs_tpu_torch.ops import _build, rbf_kernels
from corrla_rs_tpu_torch.ops.rbf_kernels import (
    pairwise_kernel_matrix,
    pairwise_kernel_matrix_ref,
    rbf_matvec,
    rbf_matvec_ref,
)

torch.set_num_threads(1)

KERNELS = ["linear", "multiquadric", "gaussian", "cubic"]


def _t(a):
    return torch.from_numpy(np.array(a))


@pytest.mark.parametrize("kernel", KERNELS)
def test_kernel_matrix_ref_matches_pallas_interpret(rng, kernel):
    xa = rng.standard_normal((70, 3)).astype(np.float32)
    xb = rng.standard_normal((50, 3)).astype(np.float32)
    want = pallas_kernel_matrix(jnp.asarray(xa), jnp.asarray(xb),
                                kernel=kernel, eps=0.7, tile_m=32, tile_n=32,
                                interpret=True)
    got = pairwise_kernel_matrix_ref(_t(xa), _t(xb), kernel, 0.7)
    assert got.dtype == torch.float32 and got.shape == (70, 50)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=2e-3,
                               atol=2e-4)


@pytest.mark.parametrize("shape,kernel,eps,tiles", [
    (((45, 4), (130, 4), (130, 2)), "multiquadric", 1.0, (16, 64)),
    (((7, 2), (13, 2), (13, 1)), "gaussian", 0.5, (8, 8)),   # odd shapes
    (((33, 1), (77, 1), (77, 5)), "linear", 1.0, (16, 32)),
], ids=["tiled", "odd", "pod-like"])
def test_matvec_ref_matches_pallas_interpret(rng, shape, kernel, eps, tiles):
    q, s, c = (rng.standard_normal(sh).astype(np.float32) for sh in shape)
    want = pallas_matvec(jnp.asarray(q), jnp.asarray(s), jnp.asarray(c),
                         kernel=kernel, eps=eps, tile_m=tiles[0],
                         tile_n=tiles[1], interpret=True)
    got = rbf_matvec_ref(_t(q), _t(s), _t(c), kernel, eps)
    assert got.shape == (shape[0][0], shape[2][1])
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=2e-3,
                               atol=1e-3)


@pytest.mark.parametrize("kernel", KERNELS)
@pytest.mark.parametrize("shapes", [((7, 2), (13, 2)), ((64, 3), (100, 3))],
                         ids=["odd", "even"])
def test_kernel_refs_match_xla_f64(rng, kernel, shapes):
    xa = rng.standard_normal(shapes[0])
    xb = rng.standard_normal(shapes[1])
    c = rng.standard_normal((shapes[1][0], 3))
    k_jax = np.asarray(jax_interp.rbf_kernel_eval(
        jax_interp.pairwise_dists(jnp.asarray(xa), jnp.asarray(xb)),
        kernel, 0.8))
    k_port = pairwise_kernel_matrix_ref(_t(xa), _t(xb), kernel, 0.8)
    np.testing.assert_allclose(k_port.numpy(), k_jax, rtol=1e-12, atol=1e-12)
    y_port = rbf_matvec_ref(_t(xa), _t(xb), _t(c), kernel, 0.8)
    np.testing.assert_allclose(y_port.numpy(), k_jax @ c, rtol=1e-12,
                               atol=1e-12)


def test_matvec_ref_chunks_agree(rng, monkeypatch):
    # the plain matvec forms the kernel matrix a block of query rows at a
    # time; the blocking must not change the result
    q, s = rng.standard_normal((37, 2)), rng.standard_normal((11, 2))
    c = rng.standard_normal((11, 4))
    whole = rbf_matvec_ref(_t(q), _t(s), _t(c), "cubic", 1.0)
    monkeypatch.setattr(rbf_kernels, "_REF_CHUNK_ELEMS", 50)   # 4 rows
    blocked = rbf_matvec_ref(_t(q), _t(s), _t(c), "cubic", 1.0)
    torch.testing.assert_close(blocked, whole, rtol=0, atol=0)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_direct_differences_zero_diagonal(rng, dtype):
    # direct differences give K_ii = phi(0) exactly (the Pallas Gram
    # expansion leaves ~1e-3 on the linear kernel's diagonal in f32)
    x = _t(rng.standard_normal((40, 3))).to(dtype)
    k = pairwise_kernel_matrix(x, x, "linear")
    assert torch.all(torch.diagonal(k) == 0)
    torch.testing.assert_close(k, k.mT, rtol=0, atol=0)


def test_cpu_tensors_take_the_plain_version(rng):
    xa, xb = _t(rng.standard_normal((9, 2))), _t(rng.standard_normal((5, 2)))
    c = _t(rng.standard_normal((5, 2)))
    before = (pairwise_kernel_matrix.launches, rbf_matvec.launches,
              dict(rbf_matvec.launches_by))
    torch.testing.assert_close(pairwise_kernel_matrix(xa, xb, "gaussian", 2.0),
                               pairwise_kernel_matrix_ref(xa, xb, "gaussian",
                                                          2.0),
                               rtol=0, atol=0)
    torch.testing.assert_close(rbf_matvec(xa, xb, c, "multiquadric", 0.3),
                               rbf_matvec_ref(xa, xb, c, "multiquadric", 0.3),
                               rtol=0, atol=0)
    # the launch counts count CUDA launches only
    assert (pairwise_kernel_matrix.launches, rbf_matvec.launches,
            rbf_matvec.launches_by) == before


def test_wrappers_reject_bad_operands(rng):
    x = _t(rng.standard_normal((6, 3)))
    c = _t(rng.standard_normal((6, 1)))
    with pytest.raises(ValueError, match="unknown RBF kernel"):
        pairwise_kernel_matrix(x, x, "thin_plate")
    with pytest.raises(ValueError, match="differ in dtype"):
        pairwise_kernel_matrix(x, x.float())
    with pytest.raises(ValueError, match="contiguous"):
        pairwise_kernel_matrix(x, x.mT.contiguous().mT)
    with pytest.raises(ValueError, match="2-D"):
        rbf_matvec(x[:, 0], x, c)
    with pytest.raises(TypeError, match="float32 or float64"):
        rbf_matvec(x.half(), x.half(), c.half())
    with pytest.raises(ValueError, match="do not match"):
        rbf_matvec(x, x[:4], c)
    with pytest.raises(ValueError, match="feature dims"):
        pairwise_kernel_matrix(x, x[:, :2].contiguous())
    empty = rbf_matvec(x[:0], x, c)
    assert empty.shape == (0, 1)


@pytest.mark.parametrize("kernel", KERNELS)
# a wider matrix, an odd stride at an offset, a padded one; the saddle
# matrices of a 1-D fit (n + 2 wide) and of a 3-D fit (n + 4), and a view
# one column in
@pytest.mark.parametrize("ld,off", [(50, 0), (53, 3), (64, 14), (52, 0),
                                    (54, 0), (52, 1)])
def test_kernel_matrix_into_fills_only_its_view(rng, kernel, ld, off):
    # the strided entry point writes K into a block of a larger matrix and
    # nothing around it; K against the Pallas kernel in interpret mode (f32)
    # and the XLA path in f64
    xa = rng.standard_normal((30, 3)).astype(np.float32)
    xb = rng.standard_normal((50, 3)).astype(np.float32)
    for dtype, want, tol in [
        (torch.float32, pallas_kernel_matrix(
            jnp.asarray(xa), jnp.asarray(xb), kernel=kernel, eps=0.7,
            tile_m=16, tile_n=32, interpret=True), (2e-3, 2e-4)),
        (torch.float64, jax_interp.rbf_kernel_eval(jax_interp.pairwise_dists(
            jnp.asarray(xa, jnp.float64), jnp.asarray(xb, jnp.float64)),
            kernel, 0.7), (1e-12, 1e-12)),
    ]:
        big = torch.full((32, ld), -7.5, dtype=dtype)
        view = big[1:31, off:off + 50]
        got = rbf_kernels._pairwise_kernel_matrix_into(
            view, _t(xa).to(dtype), _t(xb).to(dtype), kernel, 0.7)
        assert got is view
        np.testing.assert_allclose(view.numpy(), np.asarray(want),
                                   rtol=tol[0], atol=tol[1])
        guard = torch.ones_like(big, dtype=torch.bool)
        guard[1:31, off:off + 50] = False
        assert bool((big[guard] == -7.5).all())


def test_kernel_matrix_into_rejects_bad_outputs(rng):
    x = _t(rng.standard_normal((6, 3)))
    into = rbf_kernels._pairwise_kernel_matrix_into
    before = pairwise_kernel_matrix.launches
    with pytest.raises(TypeError, match="out must be a tensor"):
        into(np.zeros((6, 6)), x, x)
    with pytest.raises(ValueError, match="expected torch.float64"):
        into(torch.zeros((6, 6), dtype=torch.float32), x, x)
    with pytest.raises(ValueError, match="expected \\(6, 6\\)"):
        into(torch.zeros((6, 7), dtype=x.dtype), x, x)
    with pytest.raises(ValueError, match="unit column stride"):
        into(torch.zeros((6, 6), dtype=x.dtype).mT, x, x)
    with pytest.raises(ValueError, match="unit column stride"):
        into(torch.zeros((6, 12), dtype=x.dtype)[:, ::2], x, x)
    with pytest.raises(ValueError, match="feature dims"):
        into(torch.zeros((6, 6), dtype=x.dtype), x, x[:, :2].contiguous())
    assert pairwise_kernel_matrix.launches == before


# the launch plan of the CUDA matvec: a pure function of the shape and the
# SM count, checked here because the kernel itself runs only on the card
H100_SMS = 132


@pytest.mark.parametrize("m,n,c,split", [
    (1 << 20, 16384, 1, False),      # RbfInterp predict fills the card
    (264 * 512, 100, 1, False),      # exactly two blocks an SM
    (512, 2000, 20, True),           # PodI predict: one query block
    (1, 100_000, 1, True),           # one query
    (7, 13, 3, True),                # smaller than a block and a tile
], ids=["interp-1M", "two-per-sm", "podi-512", "one-query", "tiny"])
def test_matvec_plan_splits_only_grids_that_underfill(m, n, c, split):
    plan = rbf_kernels._matvec_plan(m, n, c, H100_SMS)
    if split:
        assert plan.splits > 1
        assert plan.blocks >= min(2 * H100_SMS,
                                  plan.q_blocks * plan.col_chunks * n)
    else:
        assert (plan.splits, plan.split_len) == (1, n)
        assert plan.blocks >= 2 * H100_SMS


def test_matvec_plan_podi_shape():
    # more than one split and at least two blocks an SM; 2000 is not a
    # multiple of the split, so the last split is short
    plan = rbf_kernels._matvec_plan(512, 2000, 20, H100_SMS)
    assert plan.splits > 1 and plan.blocks >= 2 * H100_SMS
    assert 2000 % plan.split_len != 0
    assert plan.cols < 32


@pytest.mark.parametrize("n", [1, 13, 2000, 16384])
@pytest.mark.parametrize("m,c", [(1, 1), (512, 20), (1 << 20, 1)],
                         ids=["one-query", "podi", "interp-1M"])
def test_matvec_plan_splits_cover_the_support(m, c, n):
    # every split non-empty, in order, covering [0, n) exactly
    plan = rbf_kernels._matvec_plan(m, n, c, H100_SMS)
    bounds = [(z * plan.split_len, min((z + 1) * plan.split_len, n))
              for z in range(plan.splits)]
    assert all(lo < hi for lo, hi in bounds)
    assert bounds[0][0] == 0 and bounds[-1][1] == n
    assert all(a[1] == b[0] for a, b in zip(bounds, bounds[1:]))
    assert plan.splits <= 65535


@pytest.mark.parametrize("itemsize,c,cols,chunks", [
    (4, 1, 1, 1), (4, 2, 2, 1), (4, 3, 4, 1), (4, 8, 8, 1), (4, 16, 16, 1),
    (4, 20, 20, 1), (4, 33, 20, 2), (4, 100, 20, 5),
    (8, 1, 1, 1), (8, 20, 16, 2), (8, 100, 16, 7),   # f64: no 20-wide
])
def test_matvec_plan_column_chunks_fit(itemsize, c, cols, chunks):
    plan = rbf_kernels._matvec_plan(512, 2000, c, H100_SMS, itemsize)
    assert (plan.cols, plan.col_chunks) == (cols, chunks)
    assert (chunks - 1) * cols < c <= chunks * cols


def test_matvec_plan_is_the_same_for_the_same_inputs():
    shapes = [(512, 2000, 20, 132), (1, 100_000, 1, 114), (1 << 20, 16384, 1,
                                                           132),
              (3000, 50_000, 4, 78)]
    first = [rbf_kernels._matvec_plan(*s) for s in shapes]
    assert first == [rbf_kernels._matvec_plan(*s) for s in shapes]
    # a card with more SMs splits more, never fewer
    assert (rbf_kernels._matvec_plan(512, 2000, 20, 264).splits
            >= first[0].splits)


@pytest.mark.parametrize("m,n,c", [(512, 2000, 20), (3, 1001, 2)])
def test_matvec_split_sums_match_the_whole(rng, m, n, c):
    # the splits' partial sums, added in split order as the second kernel
    # does, give the whole matvec
    q, x = rng.standard_normal((m, 1)), rng.standard_normal((n, 1))
    coef = rng.standard_normal((n, c))
    plan = rbf_kernels._matvec_plan(m, n, c, H100_SMS)
    total = torch.zeros((m, c), dtype=torch.float64)
    for z in range(plan.splits):
        lo, hi = z * plan.split_len, min((z + 1) * plan.split_len, n)
        total += rbf_matvec_ref(_t(q), _t(x[lo:hi]), _t(coef[lo:hi]),
                                "cubic", 1.0)
    torch.testing.assert_close(total, rbf_matvec_ref(_t(q), _t(x), _t(coef),
                                                     "cubic", 1.0),
                               rtol=1e-12, atol=1e-12)


def test_build_without_nvcc_raises(monkeypatch, tmp_path):
    # the kernels are built from source on first CUDA use; with no nvcc the
    # build raises instead of falling back
    monkeypatch.delenv("CUDA_HOME", raising=False)
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setattr(_build, "_DEFAULT_NVCC", tmp_path / "nvcc")
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(_build, "_lib", None)
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _build.load_library()
    assert not (tmp_path / "build").exists()


def test_library_name_follows_sources(tmp_path, monkeypatch):
    src = tmp_path / "k.cu"
    src.write_text("// v1\n")
    first = _build._library_path([src])
    assert first == _build._library_path([src])
    assert first.parent == _build.BUILD_DIR
    src.write_text("// v2\n")
    assert _build._library_path([src]) != first
    assert [p.name for p in _build._sources()] == [
        "rbf_kernels.cu", "rbf_matvec_f32.cu", "rbf_matvec_f64.cu"]


def test_library_name_follows_headers(tmp_path, monkeypatch):
    # the kernels include csrc/*.cuh, so an edited header builds anew too
    monkeypatch.setattr(_build, "_CSRC", tmp_path)
    src, header = tmp_path / "k.cu", tmp_path / "k.cuh"
    src.write_text('#include "k.cuh"\n')
    header.write_text("// v1\n")
    first = _build._library_path([src])
    header.write_text("// v2\n")
    assert _build._library_path([src]) != first
