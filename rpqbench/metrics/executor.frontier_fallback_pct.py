"""The share of frontier dispatches in the window that fell back to the
dense loop (%), from the executor's ``frontier_stats``."""


def read(run):
    dispatches = run.delta("frontier.dispatches")
    if not dispatches:
        return None
    return 100.0 * run.delta("frontier.fallbacks") / dispatches
