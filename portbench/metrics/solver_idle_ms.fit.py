"""Milliseconds a fit in which the device idles under the dense solvers: as
``rsvd_idle_ms.fit``, over the program's ``corrla.solve.pinv`` and
``corrla.solve.saddle`` spans together."""
from portbench.harness import _load_metric

_rsvd = _load_metric("rsvd_idle_ms.fit")
SPANS = ("corrla.solve.pinv", "corrla.solve.saddle")


def read(run):
    return _rsvd.idle_ms(run, SPANS)
