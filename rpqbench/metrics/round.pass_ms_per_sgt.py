"""Device ms a sgt of every operation that is not one of the port's own
CUDA kernels: PyTorch's elementwise passes over the state, its
reductions, gathers and scatters, the emit and the copies, from the
profiler's trace of the window."""


def read(run):
    w = run.device_window
    if w is None or not run.window_sgts or not w.events:
        return None
    return w.device_s(others=True) / run.window_sgts * 1e3
