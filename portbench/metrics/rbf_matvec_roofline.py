"""Per cent of the RBF matvec's roofline a predict call reaches: the least
time of the call's matvec work (``roofline.rbf_matvec_bound_s`` of the
call's shapes and the configuration's dtype) over the device time of every
operation that the traced predict calls launched. The count comes from the
shapes, so it reads the same work whatever carries it out."""
from portbench.roofline import rbf_matvec_bound_s


def read(run):
    t = run.trace
    shape = run.driver.rbf_matvec_shape(run.cell.config, run.cell.traffic)
    calls = t.span_count("portbench.predict") if t is not None else 0
    if shape is None or not calls:
        return None
    busy = sum(op["dur"] for op in t.ops_under("portbench.predict")) * 1e-6
    if busy <= 0:
        return None
    itemsize = 8 if run.cell.config["dtype"] == "float64" else 4
    return calls * rbf_matvec_bound_s(*shape, itemsize) / busy * 100.0
