"""The 95th percentile of every predict call's latency in the window, from
the call to the end of its synchronisation, in milliseconds."""
import statistics


def read(run):
    if run.cell.kind != "predict" or len(run.latencies) < 2:
        return None
    return statistics.quantiles(run.latencies, n=20)[18] * 1e3
