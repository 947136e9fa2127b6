"""The port's package boundary: no JAX, public names, device defaults, and
chip_smoke.py's refusal to run without a CUDA device."""
import os
import re
import shutil
import subprocess
import sys

import torch

import corrla_rs_tpu as crt
import corrla_rs_tpu_torch as port
from corrla_rs_tpu_torch.utils.device import describe_device

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _run(code_or_args, cwd=ROOT):
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = ROOT
    args = code_or_args if isinstance(code_or_args, list) else [
        "-c", code_or_args]
    return subprocess.run([sys.executable, *args], cwd=cwd, env=env,
                          capture_output=True, text=True, timeout=120)


def test_port_never_imports_jax():
    proc = _run(
        "import sys, pkgutil, importlib, corrla_rs_tpu_torch as p\n"
        "import corrla_rs_torch\n"
        "for m in pkgutil.walk_packages(p.__path__, 'corrla_rs_tpu_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        "bad = sorted(m for m in sys.modules if m == 'jax' or "
        "m.startswith(('jax.', 'jaxlib', 'corrla_rs_tpu.')) or "
        "m == 'corrla_rs_tpu')\n"
        "print('LOADED', ' '.join(sorted(m for m in sys.modules if "
        "m.startswith('corrla_rs_tpu_torch'))))\n"
        "assert not bad, bad\n"
    )
    assert proc.returncode == 0, proc.stderr
    loaded = set(proc.stdout.split("LOADED")[1].split())
    assert len(loaded) >= 50
    # the modules of the inference layer and the tensor factorizations,
    # those of the GPs, Grassmann interpolation and the ROM models, those
    # of the Koopman/DMD-family models and the UQ estimators, and those of
    # out-of-core streaming, the statistics layer and the test helpers (the
    # drop-in shim corrla_rs_torch is imported above), and those of the
    # multi-device layer and the export
    for name in ("ops.tt", "ops.cp", "ops.nmf", "ops.completion",
                 "ops.ensemble_mcmc", "ops.hmc", "ops.nuts", "ops.smc",
                 "ops.kalman", "ops.enkf", "ops.particle", "ops.laplace",
                 "ops.bridge", "ops.psis", "ops.gp", "ops.design",
                 "ops.bayes_opt", "ops.grassmann", "ops.deim", "ops.gappy",
                 "ops.spdmd", "models.hankel_dmd", "models.mrdmd",
                 "models.pidmd", "models.era", "models.online_dmd",
                 "utils.checkpoint", "models.edmd", "models.kernel_dmd",
                 "models.spod", "models.opinf", "models.sindy",
                 "models.optdmd", "models.bop_dmd", "ops.quadrature",
                 "ops.pce", "ops.sobol", "ops.morris", "ops.shapley",
                 "ops.mlmc", "ops.multifidelity", "ops.streaming",
                 "ops.gmm", "ops.cma", "ops.cca", "ops.pls", "ops.copula",
                 "ops.vine", "ops.rvine", "utils.testing", "parallel.mesh",
                 "parallel.sharded_rsvd", "parallel.sharded_hosvd",
                 "parallel.sharded_samplers", "utils.export"):
        assert f"corrla_rs_tpu_torch.{name}" in loaded, name


def test_no_source_of_the_port_names_jax():
    # by the text as well: no import statement of the port's package or of
    # chip_smoke.py names jax or the JAX package, inside a function either
    pattern = re.compile(
        r"^\s*(?:import|from)\s+(?:jax|jaxlib|corrla_rs_tpu)(?![\w])", re.M)
    sources = [os.path.join(ROOT, "chip_smoke.py"),
               os.path.join(ROOT, "corrla_rs_torch.py")]
    for folder, _, files in os.walk(os.path.join(ROOT, "corrla_rs_tpu_torch")):
        sources += [os.path.join(folder, f) for f in files
                    if f.endswith(".py")]
    assert len(sources) >= 50
    for path in sources:
        with open(path) as f:
            hits = pattern.findall(f.read())
        assert not hits, (path, hits)


def test_public_names_mirror_the_jax_package():
    assert set(port.__all__) <= set(crt.__all__)
    for name in port.__all__:
        assert hasattr(port, name), name
    assert port.PyRbfInterp is port.RbfInterp
    assert port.PyPodI is port.PodI


def test_tf32_off_and_default_device():
    assert torch.backends.cuda.matmul.allow_tf32 is False
    assert torch.backends.cudnn.allow_tf32 is False
    proc = _run("from corrla_rs_tpu_torch.utils.device import "
                "default_device; print(default_device())")
    assert proc.stdout.strip() == "cuda"   # no silent CPU default
    info = describe_device("cpu")
    assert info["device"] == "cpu" and info["allow_tf32_matmul"] is False


def test_default_device_refuses_numpy_without_gpu():
    # numpy data goes to the default device (cuda): with no GPU that raises
    # instead of quietly running on the CPU
    if torch.cuda.is_available():
        return
    proc = _run("import numpy as np, corrla_rs_tpu_torch as p\n"
                "p.rsvd(np.ones((8, 4)), 2, 1, 1)\n")
    assert proc.returncode != 0
    assert "CUDA" in proc.stderr or "cuda" in proc.stderr


def test_chip_smoke_fails_without_cuda(tmp_path):
    # without a GPU: non-zero exit and no result line, both from
    # the checkout and from a directory holding chip_smoke.py alone
    if torch.cuda.is_available():
        return
    proc = _run([os.path.join(ROOT, "chip_smoke.py")])
    assert proc.returncode != 0 and '"ok"' not in proc.stdout
    shutil.copy(os.path.join(ROOT, "chip_smoke.py"), tmp_path)
    alone = subprocess.run([sys.executable, "chip_smoke.py"], cwd=tmp_path,
                           capture_output=True, text=True, timeout=120,
                           env={k: v for k, v in os.environ.items()
                                if k != "PYTHONPATH"})
    assert alone.returncode != 0 and '"ok"' not in alone.stdout


def test_chip_smoke_phase_selector():
    # --phases runs the named phases in their usual order after device and
    # build; an unknown name exits 2 and lists the valid ones
    proc = _run([os.path.join(ROOT, "chip_smoke.py"), "--phases",
                 "bench,nope"])
    assert proc.returncode == 2 and '"ok"' not in proc.stdout
    assert "nope" in proc.stderr and "dmdc, active_ss" in proc.stderr
    proc = _run("import argparse, chip_smoke as c\n"
                "print(c.parse_phases(argparse.ArgumentParser(),\n"
                "                     'bench, dmdc,build'))\n"
                "print(c.parse_phases(argparse.ArgumentParser(),\n"
                "                     ','.join(c.PHASES)) == list(c.PHASES))\n")
    assert proc.stdout.split("\n")[:2] == ["['dmdc', 'bench']", "True"]
