"""Query points answered a second: all the points of the window's predict
calls over all the window's time."""


def read(run):
    if run.cell.kind != "predict" or not run.calls:
        return None
    return run.items / run.window_s
