"""Per cent of its roofline that a fit's RSVD core reaches: the least time
of the fit's products that read A, from the driver's ``rsvd_work`` (the
larger of their bytes over the HBM rate and their operations over the dense
TF32 tensor peak, the fastest any product of float32 inputs runs on the
card), over the device time of every operation launched inside the
program's ``corrla.rsvd`` span a fit (``rsvd_busy_ms.fit``). The count comes
from the shapes, so it reads the same work whatever carries it out, and
moving work between the spans inside ``corrla.rsvd`` cannot lift it. None
where the driver gives no ``rsvd_work`` or the span is absent."""
from portbench.harness import _load_metric
from portbench.roofline import PEAK_BYTES_S

_rsvd = _load_metric("rsvd_busy_ms.fit")
# H100 SXM dense TF32 tensor-core peak (NVIDIA data sheet, at 700 W)
PEAK_TF32_FLOPS = 494.7e12


def bound_s(n_bytes: float, n_ops: float) -> float:
    """The least time of ``n_bytes`` and ``n_ops`` of float32 products."""
    return max(n_bytes / PEAK_BYTES_S, n_ops / PEAK_TF32_FLOPS)


def read(run):
    work = getattr(run.driver, "rsvd_work", None)
    busy = _rsvd.busy_ms(run, _rsvd.SPANS) if work else None
    if not busy:
        return None
    return bound_s(*work(run.cell.config)) * 1e3 / busy * 100.0
