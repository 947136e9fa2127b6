"""Milliseconds a fit in which the device idles under the RSVD core: the
gaps between the traced window's merged device operations, clipped to each
``portbench.fit`` span, counted where a gap's midpoint lies inside a
``corrla.rsvd`` span (as the breakdown names a gap by the host event over
its middle), summed, over the traced fits. A gap counts once, however many
of the spans cover its midpoint. None and 0.0 as in ``rsvd_busy_ms.fit``."""
import bisect

from portbench.harness import _load_metric

_busy = _load_metric("rsvd_busy_ms.fit")
SPANS = ("corrla.rsvd",)


def idle_ms(run, names):
    """Idle device milliseconds a fit whose gaps' midpoints lie inside the
    spans ``names``."""
    found = _busy.fits_and_spans(run, names)
    if found is None:
        return None
    fits, merged = found
    t = run.trace
    edges = [t.window[0]]
    for a, b in t._merged():
        edges += [a, b]
    edges.append(t.window[1])
    gaps = [(edges[i], edges[i + 1]) for i in range(0, len(edges), 2)
            if edges[i + 1] > edges[i]]
    ends = [b for _, b in gaps]
    us = 0.0
    for lo, hi in _busy.union(t, (_busy.FIT,)):
        for a, b in gaps[bisect.bisect_right(ends, lo):]:
            if a >= hi:
                break
            a, b = max(a, lo), min(b, hi)
            if b > a and _busy.inside(merged, (a + b) / 2):
                us += b - a
    return us / fits * 1e-3


def read(run):
    return idle_ms(run, SPANS)
