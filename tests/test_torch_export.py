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


@pytest.mark.parametrize("name", ["pairwise_kernel_matrix", "rbf_matvec"])
def test_kernel_launch_refuses_export(name, tmp_path):
    # what a CUDA wrapper does before it launches: under torch.export it
    # raises, naming the kernel and the ROADMAP item, and traces nothing
    def fn(z):
        rbf_kernels._refuse_export(name)
        return z * 2.0

    z = torch.ones(3, 2)
    fn(z)       # outside an export it lets the launch through
    with pytest.raises(NotImplementedError, match=f"{name}.*item 19"):
        export_fn(fn, (z,), str(tmp_path / "k.pt2"))


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
