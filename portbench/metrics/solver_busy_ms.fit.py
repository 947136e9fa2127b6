"""Milliseconds of device time a fit in the dense solvers: as
``rsvd_busy_ms.fit``, over the program's ``corrla.solve.pinv`` and
``corrla.solve.saddle`` spans together."""
from portbench.harness import _load_metric

_rsvd = _load_metric("rsvd_busy_ms.fit")
SPANS = ("corrla.solve.pinv", "corrla.solve.saddle")


def read(run):
    return _rsvd.busy_ms(run, SPANS)
