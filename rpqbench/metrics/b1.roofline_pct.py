"""Kernel B1's share of its roofline over the window (%): the sum of each
launch's bound over B1's device time in the profiler's trace (its
occupancy pre-pass and product kernels).

A launch's bound (rpqbench/roofline.py) is the larger of its bytes, the
operands read once and the output written once at the HBM peak, and the
min/max operations its operands need at the float32 peak. The operands
are not read (that would add device work to the window), so the count of
operations is bounded above: on the main path the second operand holds
adjacency rows, at most one finite entry a retained edge, so a launch
needs at most 2 * J * m * (most edges retained in the window) of them.
Where that bound stays under the bytes term the bound is the bytes term
exactly; where it does not, the bytes term alone is used, which can only
understate the share."""
from rpqbench.roofline import bound_ms


def read(run):
    w = run.device_window
    launches = run.launches.get("b1", [])
    if w is None or not launches:
        return None
    device_s = w.device_s("b1")
    if device_s <= 0:
        return None
    total_ms = 0.0
    for ln in launches:
        # the operations' upper bound; the bound is the bytes term either way
        ops = 2.0 * ln["j"] * ln["m"] * run.present_edges_max
        ms, by = bound_ms(ln["j"], ln["m"], ln["k"], ln["n"], ln["itemsize"], ops=ops)
        if by == "operations":
            ms, _ = bound_ms(ln["j"], ln["m"], ln["k"], ln["n"], ln["itemsize"], ops=0)
        total_ms += ms
    return 100.0 * total_ms / 1e3 / device_s
