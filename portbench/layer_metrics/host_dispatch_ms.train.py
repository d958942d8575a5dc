"""``host_dispatch_ms.train``: the host's milliseconds a traced
``train_step`` call spends outside CUDA's runtime and driver calls, median
over the profiled steps (``trace.host_outside_api``).  A wait on a full
launch queue, a launch's own cost and any synchronisation happen inside
those calls and are left out, so this reads the dispatch (Python, the
dispatcher, autograd, the optimizer's loop) whether the host or the card
paces the step.  Under the profiler, which adds a little to each
operator."""


def read(t):
    tr = getattr(t, "trace", None)
    s = None if tr is None else tr.host_s
    return None if s is None else s * 1e3
