"""The share of the traced window (%) in which the card is idle while
the host's innermost open span is a program span other than ``sync.*``:
host work the card waited for, from the profiler's busy intervals and
the program's spans on the same clock (rpqbench/spans.py)."""
from rpqbench.spans import idle_host_bound_pct


def read(run):
    return idle_host_bound_pct(run)
