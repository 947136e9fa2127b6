"""Milliseconds of device time a fit in the RSVD core: the durations of the
device operations (kernels, copies, fills) launched inside the program's
``corrla.rsvd`` spans, summed, over the traced fits (``portbench.fit``
spans). An operation counts once, however many of the spans cover its
launch. None outside a fit mix, where the trace holds no device operation
(no device was traced) or where the spans are absent; 0.0 where they are
there and launched nothing."""
import bisect

FIT = "portbench.fit"
SPANS = ("corrla.rsvd",)


def union(trace, names) -> list:
    """The spans of ``names`` merged: sorted disjoint [start, end] pairs, in
    the trace's microseconds."""
    out = []
    for a, b in sorted(s for n in names for s in trace.spans.get(n, ())):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return out


def inside(merged: list, ts: float) -> bool:
    """Whether ``ts`` lies in one of the ``union`` intervals ``merged``."""
    i = bisect.bisect_right(merged, [ts, float("inf")]) - 1
    return i >= 0 and ts <= merged[i][1]


def fits_and_spans(run, names):
    """(traced fits, ``union`` of the spans ``names``) where the run is a
    traced fit mix that holds device operations and those spans, else
    None."""
    t = run.trace
    if run.cell.kind != "fit" or t is None or not t.device_ops:
        return None
    fits, merged = t.span_count(FIT), union(t, names)
    return (fits, merged) if fits and merged else None


def busy_ms(run, names):
    """Device milliseconds a fit launched inside the spans ``names``."""
    found = fits_and_spans(run, names)
    if found is None:
        return None
    fits, merged = found
    launched = run.trace.launch_ts
    us = sum(op["dur"] for op in run.trace.device_ops
             if op["corr"] in launched
             and inside(merged, launched[op["corr"]]))
    return us / fits * 1e-3


def read(run):
    return busy_ms(run, SPANS)
