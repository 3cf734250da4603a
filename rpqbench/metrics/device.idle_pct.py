"""The share of the window in which no operation ran on the card (%):
100 x (1 - the union of device-busy intervals / the traced window)."""


def read(run):
    w = run.device_window
    if w is None or not w.events or w.window_s <= 0:
        return None
    return 100.0 * (1.0 - w.busy_s / w.window_s)
