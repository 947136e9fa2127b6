"""Kernels launched a fit: the kernels that the traced fits launched, by
the correlation of each kernel with its launch, over the traced fits."""


def read(run):
    t = run.trace
    fits = t.span_count("portbench.fit") if t is not None else 0
    if run.cell.kind != "fit" or not fits:
        return None
    kernels = t.ops_under("portbench.fit", cats={"kernel"})
    return len(kernels) / fits if kernels else None
