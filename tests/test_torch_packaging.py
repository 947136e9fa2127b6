"""The port's packaging: an installed (not editable) copy must carry every
CUDA source and header its build compiles, and the drop-in shim."""
import fnmatch
import os
import tomllib

import torch

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(ROOT, "corrla_rs_tpu_torch", "csrc")


def _setuptools():
    with open(os.path.join(ROOT, "pyproject.toml"), "rb") as f:
        return tomllib.load(f)["tool"]["setuptools"]


def test_every_csrc_file_is_package_data():
    globs = _setuptools()["package-data"]["corrla_rs_tpu_torch"]
    files = sorted(os.listdir(CSRC))
    assert any(f.endswith(".cuh") for f in files)
    missing = [f for f in files
               if not any(fnmatch.fnmatch(f"csrc/{f}", g) for g in globs)]
    assert not missing, missing


def test_build_compiles_only_packaged_files():
    # what ops._build globs and hashes is what the package ships
    from corrla_rs_tpu_torch.ops import _build

    shipped = set(os.listdir(CSRC))
    assert {os.path.basename(p) for p in _build._sources()} <= shipped


def test_shim_and_port_are_packaged():
    cfg = _setuptools()
    assert {"corrla_rs", "corrla_rs_torch"} <= set(cfg["py-modules"])
    assert any(fnmatch.fnmatch("corrla_rs_tpu_torch", g)
               for g in cfg["packages"]["find"]["include"])
