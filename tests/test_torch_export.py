"""The port's utils/export on torch.export: mirrors tests/test_export.py.

A function or a fitted model's method is exported, saved, loaded back, and
served from a fresh process that imports only torch; every result is held
to the model's own call (f64: 1e-12) and, on the JAX package's sketches, to
the JAX package's exported artifact.
"""
import os
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import cpu_device, same_sketch  # noqa: F401 (fixtures)
from corrla_rs_tpu.utils import export as jax_export
from corrla_rs_tpu_torch.ops import rbf_kernels
from corrla_rs_tpu_torch.utils.export import (
    _Call,
    export_fn,
    export_model_call,
    load_exported,
)

torch.set_num_threads(1)

# the serving side: only torch, never this package
SERVE = (
    "import sys\n"
    "import torch\n"
    "torch.set_num_threads(1)\n"
    "call = torch.export.load(sys.argv[1]).module()\n"
    "args = torch.load(sys.argv[2])\n"
    "torch.save(call(*args), sys.argv[3])\n"
    "assert not any(m.startswith(('corrla', 'jax')) for m in sys.modules)\n"
    "print('SERVE_OK')\n"
)


def serve(program, args, tmp_path):
    """Run ``program`` on ``args`` in a fresh process that imports only
    torch; returns its output."""
    args_file, out_file = str(tmp_path / "args.pt"), str(tmp_path / "out.pt")
    torch.save(tuple(args), args_file)
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    res = subprocess.run(
        [sys.executable, "-c", SERVE, program, args_file, out_file],
        capture_output=True, text=True, timeout=600, cwd=str(tmp_path),
        env=env)
    assert res.returncode == 0, res.stderr[-2000:]
    assert "SERVE_OK" in res.stdout
    return torch.load(out_file)


def _signed(a, b):
    s = np.sign(np.sum(a * b, axis=0))
    return a * np.where(s == 0, 1.0, s)


def test_export_roundtrip_function(cpu_device, rng, tmp_path):
    from corrla_rs_tpu_torch.ops.random_svd import random_svd

    a = torch.as_tensor(rng.standard_normal((64, 16)))
    path = str(tmp_path / "rsvd.pt2")

    def fn(a):
        return random_svd(a, 4, 6, 4, key=1)

    u0, s0, vt0 = fn(a)
    program = export_fn(fn, (a,), path)
    assert isinstance(program, torch.export.ExportedProgram)
    call = load_exported(path)
    u1, s1, vt1 = call(a)
    np.testing.assert_allclose(s1.numpy(), s0.numpy(), rtol=1e-12)
    np.testing.assert_allclose(u1.numpy(), u0.numpy(), atol=1e-12)
    np.testing.assert_allclose(vt1.numpy(), vt0.numpy(), atol=1e-12)


def test_export_roundtrip_matches_the_jax_artifact(same_sketch, rng,
                                                   tmp_path):
    from corrla_rs_tpu.ops.random_svd import random_svd as jax_rsvd
    from corrla_rs_tpu_torch.ops.random_svd import random_svd

    a = rng.standard_normal((64, 16))
    jax_export.export_fn(lambda a: jax_rsvd(a, 4, 6, 4, key=1),
                         (jnp.asarray(a),), str(tmp_path / "rsvd.stablehlo"))
    u_j, s_j, vt_j = (np.asarray(v) for v in jax_export.load_exported(
        str(tmp_path / "rsvd.stablehlo"))(jnp.asarray(a)))
    path = str(tmp_path / "rsvd.pt2")
    export_fn(lambda a: random_svd(a, 4, 6, 4, key=1), (torch.as_tensor(a),),
              path)
    u, s, vt = (v.numpy() for v in load_exported(path)(torch.as_tensor(a)))
    np.testing.assert_allclose(s, s_j, rtol=1e-10)
    np.testing.assert_allclose(_signed(u, u_j), u_j, atol=1e-10)
    np.testing.assert_allclose(_signed(vt.T, vt_j.T), vt_j.T, atol=1e-10)


def test_export_model_transform_self_contained(same_sketch, rng, tmp_path):
    from corrla_rs_tpu.models.pca import PcaRsvd as JaxPcaRsvd
    from corrla_rs_tpu_torch.models.pca import PcaRsvd

    x = rng.standard_normal((200, 12))
    pca = PcaRsvd(x, 4)
    path = str(tmp_path / "pca_tr.pt2")
    xq = torch.as_tensor(rng.standard_normal((7, 12)))
    ref = pca.apply_tr(xq).numpy()
    export_model_call(pca, "apply_tr", (xq,), path)
    out = serve(path, (xq,), tmp_path)
    np.testing.assert_allclose(out.numpy(), ref, rtol=1e-12, atol=1e-14)
    # the JAX package's served transform, up to the components' signs
    want = np.asarray(JaxPcaRsvd(jnp.asarray(x), 4).apply_tr(
        jnp.asarray(xq.numpy())))
    np.testing.assert_allclose(_signed(out.numpy(), want), want, atol=1e-10)


def _dmdc_data():
    x = np.linspace(0.0, 10.0, 20)
    t = np.linspace(0.0, 10.0, 40)
    u = np.exp(0.2 * t)[None, :]
    return np.sin(x[:, None] + 0.2 * t[None, :]) * u, u


def test_export_dmdc_rollout(same_sketch, tmp_path):
    from corrla_rs_tpu_torch.models.dmd import DMDc

    p, u = _dmdc_data()
    model = DMDc(p, u, n_modes=6, n_iters=40, eig_backend="device")
    path = str(tmp_path / "dmdc_roll.pt2")
    x0, u_seq = torch.as_tensor(p[:, 0:1]), torch.as_tensor(u)
    ref = model.predict_multiple(x0, u_seq, method="reduced").numpy()

    def roll(x0, u_seq):
        return model.predict_multiple(x0, u_seq, method="reduced")

    export_fn(roll, (x0, u_seq), path)
    call = load_exported(path)
    np.testing.assert_allclose(call(x0, u_seq).numpy(), ref, rtol=1e-10)
    out = serve(path, (x0, u_seq), tmp_path)
    np.testing.assert_allclose(out.numpy(), ref, rtol=1e-12, atol=1e-14)
    # and the JAX package's exported rollout (the reduced rollout is
    # basis-invariant: U^ A~ U^T)
    from corrla_rs_tpu.models.dmd import DMDc as JaxDMDc

    jm = JaxDMDc(jnp.asarray(p), jnp.asarray(u), n_modes=6, n_iters=40,
                 eig_backend="device")
    jpath = str(tmp_path / "dmdc_roll.stablehlo")
    jax_export.export_fn(
        lambda x0, u_seq: jm.predict_multiple(x0, u_seq, method="reduced"),
        (jnp.asarray(p[:, 0:1]), jnp.asarray(u)), jpath)
    want = np.asarray(jax_export.load_exported(jpath)(
        jnp.asarray(p[:, 0:1]), jnp.asarray(u)))
    np.testing.assert_allclose(out.numpy(), want, rtol=1e-8, atol=1e-10)


def test_export_pod_predict_on_the_cpu_traces_the_plain_version(
        cpu_device, rng, tmp_path):
    # on the CPU the RBF steps are the plain versions, which export
    from corrla_rs_tpu_torch.models.pod import PodI

    pod = PodI(rng.standard_normal((12, 50)),
               np.linspace(0.0, 1.0, 12)[:, None], 3)
    tq = torch.tensor([[0.3], [0.7]], dtype=torch.float64)
    path = str(tmp_path / "pod.pt2")
    export_model_call(pod, "predict", (tq,), path)
    np.testing.assert_allclose(serve(path, (tq,), tmp_path).numpy(),
                               pod.predict(tq).numpy(), rtol=1e-12,
                               atol=1e-14)


# ---------------------------------------------------------------------------
# the kernels as torch.library custom operators (ops.rbf_kernels)

# the serving side of a program with corrla:: nodes: torch and the port
# module that registers the operators, never JAX or the JAX package
SERVE_OPS = (
    "import sys\n"
    "import torch\n"
    "torch.set_num_threads(1)\n"
    "import corrla_rs_tpu_torch.ops.rbf_kernels\n"
    "call = torch.export.load(sys.argv[1]).module()\n"
    "args = torch.load(sys.argv[2])\n"
    "torch.save(call(*args), sys.argv[3])\n"
    "assert 'jax' not in sys.modules\n"
    "assert not any(m == 'corrla_rs_tpu' or m.startswith('corrla_rs_tpu.')\n"
    "               for m in sys.modules)\n"
    "print('SERVE_OK')\n"
)
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
OPS = {
    "pairwise_kernel_matrix": torch.ops.corrla.pairwise_kernel_matrix,
    "pairwise_kernel_matrix_into": torch.ops.corrla.pairwise_kernel_matrix_into,
    "rbf_matvec": torch.ops.corrla.rbf_matvec,
    "modes_product": torch.ops.corrla.modes_product,
}


def serve_ops(program, args, tmp_path):
    """``serve`` for a program with corrla:: nodes: the fresh process
    imports torch and ``corrla_rs_tpu_torch.ops.rbf_kernels`` only."""
    args_file, out_file = str(tmp_path / "args.pt"), str(tmp_path / "out.pt")
    torch.save(tuple(args), args_file)
    env = dict(os.environ, PYTHONPATH=ROOT)
    res = subprocess.run(
        [sys.executable, "-c", SERVE_OPS, program, args_file, out_file],
        capture_output=True, text=True, timeout=600, cwd=str(tmp_path),
        env=env)
    assert res.returncode == 0, res.stderr[-2000:]
    assert "SERVE_OK" in res.stdout
    return torch.load(out_file)


def _op_args(name, dtype, rng, n_a=7, n_b=5, d=3, c=2, requires_grad=False):
    xa, xb = (torch.as_tensor(rng.standard_normal(s), dtype=dtype)
              for s in ((n_a, d), (n_b, d)))
    if name == "pairwise_kernel_matrix":
        return (xa.requires_grad_(requires_grad),
                xb.requires_grad_(requires_grad), "linear", 1.0)
    if name == "pairwise_kernel_matrix_into":
        # a block of a wider matrix, as rbf_fit hands it
        return (torch.zeros(n_a, n_b + 3, dtype=dtype)[:, :n_b], xa, xb,
                "cubic", 1.0)
    if name == "modes_product":
        # (n_a, d) modes and (n_b, d) weights: an (n_a, n_b) field
        return (xa.requires_grad_(requires_grad),
                xb.requires_grad_(requires_grad))
    coeffs = torch.as_tensor(rng.standard_normal((n_b, c)), dtype=dtype)
    return xa, xb, coeffs, "gaussian", 0.7


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("name", sorted(OPS))
def test_op_passes_opcheck_on_the_cpu(name, dtype, rng):
    # schema, fake implementation, autograd registration (the distance
    # gradient of the kernel matrix with phi = linear, the modes product's
    # two plain products) and the traced dispatch, on the CPU
    # implementation (the plain version)
    args = _op_args(name, dtype, rng, requires_grad=True)
    torch.library.opcheck(OPS[name].default, args)


@pytest.mark.parametrize("n_a,n_b", [(7, 5), (0, 5), (7, 0)],
                         ids=["full", "no-queries", "no-support"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_op_fake_shapes(dtype, n_a, n_b, rng):
    # what a trace sees: shapes and dtypes, the empty cases included,
    # without a data pointer
    from torch._subclasses.fake_tensor import FakeTensor, FakeTensorMode

    with FakeTensorMode(allow_non_fake_inputs=True):
        xa, xb, coeffs = (torch.empty(s, dtype=dtype, device="cuda")
                          for s in ((n_a, 3), (n_b, 3), (n_b, 4)))
        k = OPS["pairwise_kernel_matrix"](xa, xb, "linear", 1.0)
        y = OPS["rbf_matvec"](xa, xb, coeffs, "linear", 1.0)
        f = OPS["modes_product"](xa, xb)
        # the mutating operator on fake CPU tensors: called outside a trace,
        # fake mode's check of a mutated argument makes a real tensor of its
        # device (a trace takes it on CUDA: the next test)
        out = torch.empty((n_a, n_b + 2), dtype=dtype)[:, :n_b]
        OPS["pairwise_kernel_matrix_into"](out, xa.to("cpu"), xb.to("cpu"),
                                           "linear", 1.0)
    assert isinstance(out, FakeTensor)
    assert (k.shape, k.dtype, k.device.type) == ((n_a, n_b), dtype, "cuda")
    assert (y.shape, y.dtype, y.device.type) == ((n_a, 4), dtype, "cuda")
    assert (f.shape, f.dtype, f.device.type) == ((n_a, n_b), dtype, "cuda")
    # a refused shape is refused while tracing too
    with FakeTensorMode(allow_non_fake_inputs=True):
        bad = torch.empty((n_b, 2), dtype=dtype, device="cuda")
        with pytest.raises(ValueError, match="feature dims"):
            OPS["pairwise_kernel_matrix"](torch.empty((n_a, 3), dtype=dtype,
                                                      device="cuda"), bad,
                                          "linear", 1.0)
        with pytest.raises(ValueError, match="one k >= 1"):
            OPS["modes_product"](torch.empty((n_a, 3), dtype=dtype,
                                             device="cuda"), bad)


def _targets(program):
    return [str(n.target) for n in program.graph.nodes
            if n.op == "call_function"]


def test_cuda_wrappers_trace_to_the_ops(cpu_device):
    # a CUDA tensor under torch.export reaches the operator, never the
    # plain version: traced here with fake CUDA tensors (no card needed)
    from torch._subclasses.fake_tensor import FakeTensorMode

    from corrla_rs_tpu_torch.ops import interp

    with FakeTensorMode(allow_non_fake_inputs=True):
        q, x = (torch.empty(s, dtype=torch.float64, device="cuda")
                for s in ((9, 2), (6, 2)))
        coeffs = torch.empty((6, 3), dtype=torch.float64, device="cuda")
        # a block of a wider matrix (slicing a fake CUDA tensor needs CUDA)
        out = torch.empty_strided((9, 6), (8, 1), dtype=torch.float64,
                                  device="cuda")
        # column-major modes, as PodI.fit may leave them
        modes = torch.empty_strided((40, 3), (1, 40), dtype=torch.float64,
                                    device="cuda")

    def fn(q, x, coeffs, out, modes):
        rbf_kernels._pairwise_kernel_matrix_into(out, q, x, "cubic")
        return (rbf_kernels.pairwise_kernel_matrix(q, x, "gaussian", 0.5),
                interp.pairwise_dists(q, x), out,
                rbf_kernels.rbf_matvec(q, x, coeffs, "linear"),
                rbf_kernels.modes_product(modes, coeffs))

    program = torch.export.export(_Call(fn), (q, x, coeffs, out, modes))
    targets = _targets(program)
    assert targets.count("corrla.pairwise_kernel_matrix.default") == 2
    assert targets.count("corrla.rbf_matvec.default") == 1
    assert targets.count("corrla.pairwise_kernel_matrix_into.default") == 1
    assert targets.count("corrla.modes_product.default") == 1
    # nothing of the plain product
    assert not any("aten.mm" in t or "matmul" in t for t in targets), targets
    # nothing of the plain versions (their sqrt of the summed squares)
    assert not any("sqrt" in t for t in targets), targets


def test_export_serves_the_ops_from_a_fresh_process(cpu_device, rng,
                                                    tmp_path):
    # a CPU program of the three operators, served by a process that
    # imports torch and ops.rbf_kernels only; held to the JAX package's
    # Pallas kernels in interpret mode (f32)
    from corrla_rs_tpu.ops import interp as jax_interp
    from corrla_rs_tpu.ops.pallas_kernels import (
        pairwise_kernel_matrix as pallas_kernel_matrix,
        rbf_matvec_streaming as pallas_matvec,
    )

    q = rng.standard_normal((70, 3)).astype(np.float32)
    x = rng.standard_normal((50, 3)).astype(np.float32)
    c = rng.standard_normal((50, 2)).astype(np.float32)

    def fn(q, x, c):
        out = torch.zeros((70, 56), dtype=q.dtype)[:, :50]
        OPS["pairwise_kernel_matrix_into"](out, q, x, "multiquadric", 0.7)
        return (OPS["pairwise_kernel_matrix"](q, x, "gaussian", 0.7),
                OPS["rbf_matvec"](q, x, c, "gaussian", 0.7), out)

    path = str(tmp_path / "ops.pt2")
    args = tuple(torch.from_numpy(a) for a in (q, x, c))
    program = export_fn(fn, args, path)
    targets = _targets(program)
    assert "corrla.pairwise_kernel_matrix.default" in targets
    assert "corrla.rbf_matvec.default" in targets
    k, y, kin = serve_ops(path, args, tmp_path)
    for got, want in zip((k, y, kin), fn(*args)):
        np.testing.assert_array_equal(got.numpy(), want.numpy())
    jq, jx, jc = (jnp.asarray(a) for a in (q, x, c))
    pallas = (pallas_kernel_matrix(jq, jx, kernel="gaussian", eps=0.7,
                                   tile_m=32, tile_n=32, interpret=True),
              pallas_matvec(jq, jx, jc, kernel="gaussian", eps=0.7,
                            tile_m=32, tile_n=32, interpret=True),
              pallas_kernel_matrix(jq, jx, kernel="multiquadric", eps=0.7,
                                   tile_m=32, tile_n=32, interpret=True))
    # the Pallas bodies take distances through a bf16x3-split Gram
    # expansion: tests/test_pallas_kernels.py's tolerances
    for got, want, atol in zip((k, y, kin), pallas, (2e-4, 1e-3, 2e-4)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=2e-3,
                                   atol=atol)
    # the JAX package's XLA path in f32 takes direct differences, as the
    # port does: 1e-5 of the largest entry
    xla = jax_interp.rbf_kernel_eval(jax_interp.pairwise_dists(jq, jx),
                                     "gaussian", 0.7)
    for got, want in ((k, xla), (y, xla @ jc)):
        want = np.asarray(want)
        assert np.abs(got.numpy() - want).max() <= 1e-5 * np.abs(want).max()


def test_export_pod_predict_through_the_op_matches_jax_f64(
        cpu_device, rng, tmp_path, monkeypatch):
    # PodI.predict with its RBF step on the operator (what a CUDA export
    # traces), from the JAX package's fitted state: served from a fresh
    # process, equal to JAX's predict to 1e-12
    import corrla_rs_tpu as crt
    from corrla_rs_tpu_torch.ops import interp
    from corrla_rs_tpu_torch.utils.convert import from_jax_state

    t = np.linspace(0.0, 1.0, 24)[:, None]
    s = np.linspace(0.0, 1.0, 150)[None, :]
    x = np.exp(-t * s) + 0.3 * np.sin(2 * np.pi * s * t)
    tq = np.array([[0.13], [0.5], [0.77], [0.91]])
    jpod = crt.PodI(jnp.asarray(x), jnp.asarray(t), 6, key=5)
    state = {k: (np.asarray(v) if isinstance(v, jnp.ndarray) else v)
             for k, v in vars(jpod).items()}
    pod = from_jax_state("PodI", state, device="cpu")
    monkeypatch.setattr(interp, "rbf_matvec", OPS["rbf_matvec"])
    path = str(tmp_path / "pod_op.pt2")
    tq_t = torch.as_tensor(tq)
    program = export_model_call(pod, "predict", (tq_t,), path)
    assert _targets(program).count("corrla.rbf_matvec.default") == 1
    served = serve_ops(path, (tq_t,), tmp_path).numpy()
    np.testing.assert_array_equal(load_exported(path)(tq_t).numpy(), served)
    want = np.asarray(jpod.predict(jnp.asarray(tq)))
    np.testing.assert_allclose(served, want, rtol=1e-12,
                               atol=1e-12 * np.abs(want).max())


def test_export_stores_strided_constants_dense(tmp_path):
    # a fitted model keeps views (an SVD's Vt rows are column-major); the
    # saved program holds each constant dense, so it loads back on any device
    big = torch.randn(14, 40, dtype=torch.float64).mT.contiguous().mT
    comps = big[:4]                              # strides (1, 14)
    assert not comps.is_contiguous()
    path = str(tmp_path / "strided.pt2")
    program = export_fn(lambda x: x @ comps.mT,
                        (torch.randn(5, 40, dtype=torch.float64),), path)
    consts = [v for v in program.constants.values()
              if isinstance(v, torch.Tensor)]
    assert consts and all(v.is_contiguous() for v in consts)
    x = torch.randn(5, 40, dtype=torch.float64)
    np.testing.assert_array_equal(load_exported(path)(x).numpy(),
                                  (x @ comps.mT).numpy())
