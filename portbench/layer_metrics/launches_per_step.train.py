"""``launches_per_step.train``: CUDA kernels the profiler saw ÷ profiled
train steps."""


def read(t):
    tr = getattr(t, "trace", None)
    if tr is None or not tr.kernels:
        return None
    return len(tr.kernels) / tr.units
