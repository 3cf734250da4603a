"""Closure rounds a dispatch: the growth of the executor's
``rounds_total`` over that of its ``steps`` in the window."""


def read(run):
    steps = run.delta("steps")
    return run.delta("rounds_total") / steps if steps else None
