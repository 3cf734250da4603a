"""The service's host time outside its dense dispatches, a sgt (ms): the
window's wall time less the dense group's dispatch time from the
service's own ``record_latency`` span (``QueryStats.latencies_us``, one
entry a dispatch on every live dense lane), over the window's sgts."""


def read(run):
    if not run.trace or not run.window_sgts:
        return None
    svc = run.service
    queries = svc.queries
    # a dense lane live from the window's start to its end (names are never
    # reused) carries every dispatch of the window
    for name, mark in run.latency_marks.items():
        if type(queries.get(name)).__name__ == "BatchedDenseRPQEngine":
            dispatch_s = sum(svc.stats[name].latencies_us[mark:]) / 1e6
            return (run.window_s - dispatch_s) / run.window_sgts * 1e3
    return None
