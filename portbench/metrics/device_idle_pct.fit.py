"""Per cent of the traced window of a fit mix in which no operation ran on
the device."""


def read(run):
    t = run.trace
    if run.cell.kind != "fit" or t is None or not t.device_ops:
        return None
    return (t.window_s - t.busy_s) / t.window_s * 100.0
