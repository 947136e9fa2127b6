"""The port's package boundary: no JAX, public names, device defaults, and
chip_smoke.py's refusal to run without a CUDA device."""
import os
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
        "for m in pkgutil.walk_packages(p.__path__, 'corrla_rs_tpu_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        "bad = sorted(m for m in sys.modules if m == 'jax' or "
        "m.startswith(('jax.', 'jaxlib', 'corrla_rs_tpu.')) or "
        "m == 'corrla_rs_tpu')\n"
        "print('LOADED', len([m for m in sys.modules if "
        "m.startswith('corrla_rs_tpu_torch')]))\n"
        "assert not bad, bad\n"
    )
    assert proc.returncode == 0, proc.stderr
    assert int(proc.stdout.split("LOADED")[1]) >= 15


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
