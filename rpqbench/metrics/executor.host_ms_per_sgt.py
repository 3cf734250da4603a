"""The executor's host time a sgt (ms): the self time of the program's
``executor.*`` spans in the traced window (the dispatch, the upload and
fold of the batch, each closure round's enqueue, the frontier plan, the
emit, the counter flush, the spill budget and expiry), over the window's
sgts (rpqbench/spans.py)."""
from rpqbench.spans import self_ms_per_sgt


def read(run):
    return self_ms_per_sgt(run, "executor.")
