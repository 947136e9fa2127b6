"""Milliseconds of device time a fit in the RSVD core's orthonormalizations:
as ``rsvd_busy_ms.fit``, over the program's ``corrla.rsvd.orth`` spans
(each thin QR of the power iteration and the final Householder QR)."""
from portbench.harness import _load_metric

_rsvd = _load_metric("rsvd_busy_ms.fit")
SPANS = ("corrla.rsvd.orth",)


def read(run):
    return _rsvd.busy_ms(run, SPANS)
