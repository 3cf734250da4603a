"""The service's self time a sgt (ms): the self time of the program's
``service.*`` spans in the traced window (the ``ingest`` call, the
slide-boundary upkeep, the reference engines, a simple lane's hand-over
and the call's tail), over the window's sgts (rpqbench/spans.py)."""
from rpqbench.spans import self_ms_per_sgt


def read(run):
    return self_ms_per_sgt(run, "service.")
