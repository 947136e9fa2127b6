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
    before = (pairwise_kernel_matrix.launches, rbf_matvec.launches)
    torch.testing.assert_close(pairwise_kernel_matrix(xa, xb, "gaussian", 2.0),
                               pairwise_kernel_matrix_ref(xa, xb, "gaussian",
                                                          2.0),
                               rtol=0, atol=0)
    torch.testing.assert_close(rbf_matvec(xa, xb, c, "multiquadric", 0.3),
                               rbf_matvec_ref(xa, xb, c, "multiquadric", 0.3),
                               rtol=0, atol=0)
    # the launch counts count CUDA launches only
    assert (pairwise_kernel_matrix.launches, rbf_matvec.launches) == before


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
    assert [p.name for p in _build._sources()] == ["rbf_kernels.cu"]
