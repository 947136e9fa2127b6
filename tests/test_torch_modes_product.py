"""The modes product of ``PodI.predict`` (``ops.rbf_kernels.modes_product``)
on the CPU: the wrapper, its operator's CPU kernel and the plain version are
``modes @ w.mT`` bit for bit, in both layouts of the modes; the route by k
and the number of queries, and the counters, with a stand-in for the CUDA
launch; and ``PodI.predict``
on the CPU is the plain product. The kernel itself runs in
``tests/test_torch_cuda.py``.
"""
import pytest
import torch

from _torch_parity import cpu_device  # noqa: F401 (fixture)
from corrla_rs_tpu_torch.ops import rbf_kernels as rk

torch.set_num_threads(1)


def _operands(n_pts, n_q, k, dtype, layout, seed=0):
    """modes (n_pts, k) row-major or column-major (as ``vt.mT``, the layout
    ``PodI.fit`` leaves), weights (n_q, k) row-major."""
    gen = torch.Generator().manual_seed(seed + n_pts + n_q + k)
    if layout == "col":
        modes = torch.randn(k, n_pts, generator=gen, dtype=dtype).mT
        assert modes.stride() == (1, n_pts)
    else:
        modes = torch.randn(n_pts, k, generator=gen, dtype=dtype)
    w = torch.randn(n_q, k, generator=gen, dtype=dtype)
    return modes, w


@pytest.mark.parametrize("layout", ["row", "col"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("k", [1, 3, 20, 32])
def test_cpu_kernel_plain_version_and_matmul_agree(k, dtype, layout):
    # ragged on both axes: neither is a multiple of a tile
    modes, w = _operands(131, 37, k, dtype, layout)
    want = modes @ w.mT
    for got in (rk.modes_product(modes, w), rk.modes_product_ref(modes, w),
                torch.ops.corrla.modes_product(modes, w)):
        assert got.shape == (131, 37) and got.dtype == dtype
        assert torch.equal(got, want)


@pytest.fixture
def stand_in_launch(monkeypatch):
    """The kernel's launch replaced by the plain product into ``out``, so
    the CUDA route runs on CPU tensors; returns the calls it took."""
    calls = []

    def launch(out, modes, w):
        calls.append((tuple(out.shape), modes.stride()))
        out.copy_(modes @ w.mT)

    monkeypatch.setattr(rk, "_launch_modes_product", launch)
    monkeypatch.setattr(rk.modes_product, "launches", 0)
    monkeypatch.setattr(rk.modes_product, "launches_by", {})
    return calls


# the fewest queries on the kernel's route
Q = rk._MODES_MIN_Q


@pytest.mark.parametrize("layout", ["row", "col"])
def test_k_up_to_32_takes_the_kernel_and_past_it_matmul(stand_in_launch,
                                                        layout):
    f32 = torch.float32
    strides = []
    for k in (1, 20, 32, 33, 64):
        modes, w = _operands(70, Q + 9, k, f32, layout)
        got = rk._modes_product_cuda(modes, w)
        assert torch.equal(got, modes @ w.mT)
        strides.append(modes.stride())
    # the kernel takes the modes as they are, in either layout: no copy
    assert stand_in_launch == [((70, Q + 9), s) for s in strides[:3]]
    assert rk.modes_product.launches == 3
    assert rk.modes_product.launches_by == {
        ("kernel", f32, 1): 1, ("kernel", f32, 20): 1, ("kernel", f32, 32): 1,
        ("matmul", f32, 33): 1, ("matmul", f32, 64): 1}


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_fewer_queries_than_the_crossover_take_matmul(stand_in_launch,
                                                      dtype):
    # one query and the crossover's two sides: below it cuBLAS wins
    for n_q in (1, Q - 1, Q, 512):
        modes, w = _operands(300, n_q, 20, dtype, "col")
        assert torch.equal(rk._modes_product_cuda(modes, w), modes @ w.mT)
    assert stand_in_launch == [((300, Q), (1, 300)), ((300, 512), (1, 300))]
    assert rk.modes_product.launches == 2
    assert rk.modes_product.launches_by == {("matmul", dtype, 20): 2,
                                            ("kernel", dtype, 20): 2}


def test_launches_by_counts_each_route_by_dtype_and_k(stand_in_launch):
    for dtype in (torch.float32, torch.float64):
        for k, calls in ((20, 3), (40, 2)):
            modes, w = _operands(10, Q, k, dtype, "col")
            for _ in range(calls):
                rk._modes_product_cuda(modes, w)
    # an empty output takes the kernel's route without a launch
    rk._modes_product_cuda(*_operands(0, Q, 20, torch.float32, "row"))
    assert rk.modes_product.launches_by == {
        ("kernel", torch.float32, 20): 4, ("matmul", torch.float32, 40): 2,
        ("kernel", torch.float64, 20): 3, ("matmul", torch.float64, 40): 2}
    assert rk.modes_product.launches == 6 == len(stand_in_launch)


def test_cpu_calls_launch_nothing_and_count_nothing(stand_in_launch):
    modes, w = _operands(50, 6, 20, torch.float32, "col")
    rk.modes_product(modes, w)
    assert stand_in_launch == []
    assert rk.modes_product.launches == 0
    assert rk.modes_product.launches_by == {}


@pytest.mark.parametrize("modes,w,err,match", [
    (torch.ones(5, 3), torch.ones(4, 2), ValueError, "one k >= 1"),
    (torch.ones(5, 0), torch.ones(4, 0), ValueError, "one k >= 1"),
    (torch.ones(5, 3), torch.ones(4, 3, dtype=torch.float64), ValueError,
     "differ in dtype"),
    (torch.ones(5, 3, dtype=torch.int64), torch.ones(4, 3, dtype=torch.int64),
     TypeError, "float32 or float64"),
    (torch.ones(5), torch.ones(4, 1), ValueError, "2-D"),
], ids=["k-differs", "k-zero", "dtypes", "ints", "1-d"])
def test_bad_operands_are_refused(modes, w, err, match):
    with pytest.raises(err, match=match):
        rk.modes_product(modes, w)
    with pytest.raises(err, match=match):
        torch.ops.corrla.modes_product(modes, w)


def test_the_gradient_is_the_two_plain_products(rng):
    # through the operator, as a CUDA call that records a gradient takes it
    modes = torch.tensor(rng.standard_normal((40, 5)), requires_grad=True)
    w = torch.tensor(rng.standard_normal((7, 5)), requires_grad=True)
    g = torch.as_tensor(rng.standard_normal((40, 7)))
    dm, dw = torch.autograd.grad(torch.ops.corrla.modes_product(modes, w),
                                 (modes, w), g)
    assert torch.allclose(dm, g @ w, rtol=1e-14, atol=0)
    assert torch.allclose(dw, g.mT @ modes, rtol=1e-14, atol=0)
    assert torch.autograd.gradcheck(torch.ops.corrla.modes_product,
                                     (modes, w))


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_pod_predict_on_the_cpu_is_the_plain_product(cpu_device, dtype):
    # bit for bit what predict returned before the operator: modes @ w.mT
    from corrla_rs_tpu_torch.models.pod import PodI
    from corrla_rs_tpu_torch.ops.interp import rbf_predict

    t = torch.linspace(1.0, 9.0, 30, dtype=dtype)[:, None]
    x = 0.5 * t * torch.exp(-(torch.linspace(0.0, 10.0, 400, dtype=dtype)
                              - t) ** 2 / 4.0)
    pod = PodI(x, t, 6, key=3)
    tq = torch.linspace(1.5, 8.5, 11, dtype=dtype)[:, None]
    w = rbf_predict(pod.t_abscissa, pod._rbf_coeffs, tq, "linear", 1.0, 1)
    got = pod.predict(tq)
    assert got.dtype == dtype and got.shape == (400, 11)
    assert torch.equal(got, pod.modes @ w.mT)
