"""sgts/s: every sgt whose ``ingest`` call completed in the window, over
the window's wall seconds (registrations and retirements included)."""


def read(run):
    return run.window_sgts / run.window_s if run.window_sgts else None
