"""The host's waits on the card a sgt (ms): the time of the program's
``sync.*`` spans in the traced window, its blocking reads and blocking
copies, over the window's sgts (rpqbench/spans.py)."""
from rpqbench.spans import self_ms_per_sgt


def read(run):
    return self_ms_per_sgt(run, "sync.")
