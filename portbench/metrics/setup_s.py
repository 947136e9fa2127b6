"""Set-up seconds: from the start of ``run.py`` to the first timed call
(imports, the CUDA context, the kernels' library, the inputs on the
device, a predict mix's fit, the warm-up calls)."""


def read(run):
    return run.setup_s
