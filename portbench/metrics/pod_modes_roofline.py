"""Per cent of its roofline that PodI.predict's modes product reaches: the
least time of the product, times the program's ``corrla.pod.modes`` spans
in the traced window, over the device time of the operations launched
inside them. The least time is the larger of the bytes over the HBM rate
(the (points, queries) field written once, the modes and the weights read
once, at the configuration's dtype) and the 2k operations an element over
the dtype's peak outside the tensor cores. The count comes from the
configuration and the traffic (``nx``, ``n_modes``, ``queries_per_call``,
``dtype``), so it reads the same work whatever carries it out. None where
the spans are absent or launched nothing."""
from portbench.roofline import bound_s

SPAN = "corrla.pod.modes"


def modes_work(cfg: dict, traffic: dict) -> tuple:
    """(bytes, operations, itemsize) of one predict call's modes product."""
    n_pts, k = int(cfg["nx"]), int(cfg["n_modes"])
    n_q = int(traffic["queries_per_call"])
    itemsize = 8 if cfg["dtype"] == "float64" else 4
    n_bytes = itemsize * (n_pts * n_q + n_pts * k + n_q * k)
    return n_bytes, 2 * k * n_pts * n_q, itemsize


def read(run):
    t = run.trace
    calls = t.span_count(SPAN) if t is not None else 0
    if not calls or run.cell.kind != "predict":
        return None
    busy = sum(op["dur"] for op in t.ops_under(SPAN)) * 1e-6
    if busy <= 0:
        return None
    return (calls * bound_s(*modes_work(run.cell.config, run.cell.traffic))
            / busy * 100.0)
