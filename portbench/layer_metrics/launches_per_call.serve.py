"""``launches_per_call.serve``: CUDA kernels the profiler saw ÷ profiled
``predict_probs`` calls."""


def read(t):
    tr = getattr(t, "trace", None)
    if tr is None or not tr.kernels:
        return None
    return len(tr.kernels) / tr.units
