"""Device microseconds per launch of the solve kernel (``cg_fused_kernel``),
from the profiled steps."""


def read(run):
    n, seconds = run.kernels("cg_fused_kernel")
    return 1e6 * seconds / n if n else None
