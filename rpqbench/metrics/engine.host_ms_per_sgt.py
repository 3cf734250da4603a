"""The engine's host time a sgt (ms): the self time of the program's
``engine.*`` spans in the traced window (interning and packing, the
conflict probe, the result decode, slot recycling), over the window's
sgts (rpqbench/spans.py)."""
from rpqbench.spans import self_ms_per_sgt


def read(run):
    return self_ms_per_sgt(run, "engine.")
