"""Milliseconds of device time a fit in the RSVD core's products that read
A: as ``rsvd_busy_ms.fit``, over the program's ``corrla.rsvd.products``
spans (A Omega, each A^T Y and A Z, and Q^T A)."""
from portbench.harness import _load_metric

_rsvd = _load_metric("rsvd_busy_ms.fit")
SPANS = ("corrla.rsvd.products",)


def read(run):
    return _rsvd.busy_ms(run, SPANS)
