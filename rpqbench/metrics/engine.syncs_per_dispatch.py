"""Blocking device-to-host reads a dispatch: the growth of the dense
group's ``host_syncs`` (closure-loop flag reads, result decodes, conflict
probes) over the growth of the executor's ``steps`` in the window."""


def read(run):
    steps = run.delta("steps")
    return run.delta("host_syncs") / steps if steps else None
