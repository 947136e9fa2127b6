"""Milliseconds a fit: all the window's time over all the fits it
completed, each ended by a synchronisation as a user reads the model."""


def read(run):
    if run.cell.kind != "fit" or not run.calls:
        return None
    return run.window_s / run.calls * 1e3
