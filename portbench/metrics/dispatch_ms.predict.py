"""The median host time of a predict call from its entry to its return,
before the synchronisation, over the window's calls, in milliseconds."""
import statistics


def read(run):
    if run.cell.kind != "predict" or not run.dispatch:
        return None
    return statistics.median(run.dispatch) * 1e3
