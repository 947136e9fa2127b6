"""Build and load the port's CUDA kernels.

Each ``csrc/*.cu`` is compiled by its own ``nvcc`` process, all started
together, and the objects are linked into one shared library with a plain
C interface, which is loaded with ``ctypes``. The build runs on first use,
never at import, and goes to ``build/corrla_rs_tpu_torch/`` beside the
package (a directory that ``.gitignore`` lists), under a name keyed by a
hash of the sources, the headers (``csrc/*.cuh``) and the flags: a checkout
builds its own library the first time a kernel is launched, and an edited
source builds anew. Only the sources in this package are compiled. Without
``nvcc`` the build raises.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path

__all__ = ["load_library", "build_info", "BUILD_DIR"]

_CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "corrla_rs_tpu_torch"
_DEFAULT_NVCC = Path("/usr/local/cuda/bin/nvcc")
_ARCH = ("-gencode", "arch=compute_90a,code=sm_90a")
_NVCC_FLAGS = (*_ARCH, "-std=c++17", "-O3", "-Xcompiler", "-fPIC",
               "-Xptxas=-v")

_P, _I64, _F64 = ctypes.c_void_p, ctypes.c_int64, ctypes.c_double
_SIGNATURES = {
    # xa, xb, out, na, nb, d, ldo, phi, eps, stream
    "corrla_kernel_matrix_f32": (_P, _P, _P, _I64, _I64, _I64, _I64, _I64,
                                 _F64, _P),
    "corrla_kernel_matrix_f64": (_P, _P, _P, _I64, _I64, _I64, _I64, _I64,
                                 _F64, _P),
    # out, na, nb, ldo, itemsize -> 1 if the kernel matrix stores by TMA
    "corrla_kernel_matrix_tma": (_P, _I64, _I64, _I64, _I64),
    # q, x, c, out, scratch, m, n, d, ncols, phi, eps, cols, splits,
    # split_len, stream
    "corrla_rbf_matvec_f32": (_P, _P, _P, _P, _P, _I64, _I64, _I64, _I64,
                              _I64, _F64, _I64, _I64, _I64, _P),
    "corrla_rbf_matvec_f64": (_P, _P, _P, _P, _P, _I64, _I64, _I64, _I64,
                              _I64, _F64, _I64, _I64, _I64, _P),
    # cudaError_t -> its message
    "corrla_error_string": (ctypes.c_int,),
}
_RESTYPES = {"corrla_error_string": ctypes.c_char_p}   # the rest return int

_lock = threading.Lock()
_lib = None
_info: dict = {}


def _find_nvcc() -> str:
    root = os.environ.get("CUDA_HOME")
    if root and (Path(root) / "bin" / "nvcc").exists():
        return str(Path(root) / "bin" / "nvcc")
    found = shutil.which("nvcc")
    if found:
        return found
    if _DEFAULT_NVCC.exists():
        return str(_DEFAULT_NVCC)
    raise RuntimeError(
        "nvcc not found (set CUDA_HOME or put nvcc on PATH): the CUDA "
        "kernels of corrla_rs_tpu_torch are built from source on first use"
    )


def _sources() -> list[Path]:
    srcs = sorted(_CSRC.glob("*.cu"))
    if not srcs:
        raise RuntimeError(f"no CUDA sources under {_CSRC}")
    return srcs


def _library_path(srcs: list[Path]) -> Path:
    h = hashlib.sha256(" ".join(_NVCC_FLAGS).encode())
    for src in [*srcs, *sorted(_CSRC.glob("*.cuh"))]:
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return BUILD_DIR / f"libcorrla_kernels_{h.hexdigest()[:16]}.so"


def _build(srcs: list[Path], so: Path) -> None:
    nvcc = _find_nvcc()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = so.with_suffix(f".{os.getpid()}.tmp")
    objs = [tmp.with_name(f"{tmp.name}.{src.stem}.o") for src in srcs]
    cmds = [[nvcc, *_NVCC_FLAGS, "-c", "-o", str(obj), str(src)]
            for src, obj in zip(srcs, objs)]
    link = [nvcc, *_ARCH, "-shared", "-o", str(tmp), *map(str, objs)]
    t0 = time.perf_counter()
    procs: list[subprocess.Popen] = []
    try:
        for cmd in cmds:
            procs.append(subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                          stderr=subprocess.STDOUT,
                                          text=True))
        outs = [proc.communicate()[0] for proc in procs]
        log = "".join(outs)
        failed = [cmd for cmd, proc in zip(cmds, procs) if proc.returncode]
        if not failed:
            proc = subprocess.run(link, capture_output=True, text=True,
                                  check=False)
            log += proc.stdout + proc.stderr
            failed = [link] if proc.returncode else []
        _info.update(seconds=time.perf_counter() - t0, log=log,
                     command="\n".join(" ".join(c) for c in [*cmds, link]))
        if failed:
            tmp.unlink(missing_ok=True)
            raise RuntimeError(f"nvcc failed: {' '.join(failed[0])}\n{log}")
        os.replace(tmp, so)
    finally:
        for proc in procs:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
        for obj in objs:
            obj.unlink(missing_ok=True)


def load_library() -> ctypes.CDLL:
    """The kernels' shared library, built first if this checkout has none."""
    global _lib
    with _lock:
        if _lib is None:
            srcs = _sources()
            so = _library_path(srcs)
            _info.update(path=str(so), built=not so.exists())
            if _info["built"]:
                _build(srcs, so)
            lib = ctypes.CDLL(str(so))
            for name, argtypes in _SIGNATURES.items():
                fn = getattr(lib, name)
                fn.argtypes = list(argtypes)
                fn.restype = _RESTYPES.get(name, ctypes.c_int)
            _lib = lib
        return _lib


def build_info() -> dict:
    """Path of the loaded library and, if this process built it, the nvcc
    commands (one a line), their wall time in seconds and their output
    (``-Xptxas=-v`` register, spill and shared-memory report)."""
    return dict(_info)
