"""Device ops (CUDA kernels, copies, memsets) that the profiled collect half
launched, per physics substep: an exact count of the host-dispatch work of
the substep loop and its engine stages."""


def read(run):
    n = run.launched_in("collect")
    return n / run.substeps if n else None
