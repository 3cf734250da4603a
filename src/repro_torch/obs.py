"""Layer spans of the port: where the host spends an ``ingest`` call.

A span is ``(name, t0_ns, t1_ns)``, named ``<layer>.<what>``: ``service.*``
(:mod:`repro_torch.streaming.service`), ``engine.*``
(:mod:`repro_torch.core.engine`), ``executor.*``
(:mod:`repro_torch.core.executor`, :mod:`repro_torch.core.semiring`) and
``sync.<site>``, the host waiting on the card in a blocking read
(:func:`repro_torch.device.device_get`). Spans nest: a span's self time is
its time less that of the spans inside it (:func:`self_ns`).

Recording is off unless a call turns it on
(``PersistentQueryService.ingest(record_latency=True)``). Off, a span site
costs the test of :data:`on` and nothing else: no clock read, no
allocation, no device work. A site reads::

    t0 = obs.on and obs.now()
    ...                                  # the work
    if t0:
        obs.add("engine.intern", t0)

Times come from ``time.time_ns``, the host clock ``torch.profiler`` puts
its device timestamps on, so a span lies on the device trace's time axis.
"""
from __future__ import annotations

import time
from typing import Dict, Iterable, List, Tuple

Span = Tuple[str, int, int]

#: True while a traced call runs; every span site tests it first
on = False

now = time.time_ns


class Recorder:
    """Closed spans in the order they closed, at most ``cap`` of them:
    each span past the cap is dropped and counted in :attr:`dropped`."""

    def __init__(self, cap: int = 1 << 19):
        self.cap = int(cap)
        self.spans: List[Span] = []
        self.dropped = 0

    def add(self, name: str, t0: int) -> None:
        """Close the span ``name`` opened at ``t0``."""
        if len(self.spans) < self.cap:
            self.spans.append((name, t0, time.time_ns()))
        else:
            self.dropped += 1

    def between(self, t0_ns: int, t1_ns: int) -> List[Span]:
        """The spans that lie wholly inside ``[t0_ns, t1_ns]``."""
        return [s for s in self.spans if s[1] >= t0_ns and s[2] <= t1_ns]

    def clear(self) -> None:
        self.spans.clear()
        self.dropped = 0


#: the process's recorder, which every span site writes to
RECORDER = Recorder()


def add(name: str, t0: int) -> None:
    """Close the span ``name`` opened at ``t0`` in :data:`RECORDER`."""
    RECORDER.add(name, t0)


class recording:
    """``with recording():`` turns recording on for the block and restores
    the previous state after it."""

    def __enter__(self):
        global on
        self._prev, on = on, True
        return RECORDER

    def __exit__(self, *exc):
        global on
        on = self._prev
        return False


def innermost(spans: Iterable[Span]) -> List[Span]:
    """The time the spans cover, cut into pieces ``(name, t0, t1)``, each
    piece named by the innermost span open over it, in time order. A span
    that outlasts the span it opened in is cut at that span's end."""
    pieces: List[Span] = []
    stack: List[Tuple[str, int]] = []        # open spans: (name, end)
    cur = None

    def close(until: float) -> None:
        nonlocal cur
        while stack and stack[-1][1] <= until:
            name, end = stack.pop()
            if end > cur:
                pieces.append((name, cur, end))
                cur = end

    for name, a, b in sorted(spans, key=lambda s: (s[1], -s[2])):
        if cur is None:
            cur = a
        close(a)
        if stack and a > cur:
            pieces.append((stack[-1][0], cur, a))
        cur = max(cur, a)
        stack.append((name, min(b, stack[-1][1]) if stack else b))
    close(float("inf"))
    return pieces


def self_ns(spans: Iterable[Span]) -> Dict[str, int]:
    """Self time by span name (ns): the time in which a span of that name
    is the innermost one open."""
    out: Dict[str, int] = {}
    for name, a, b in innermost(spans):
        out[name] = out.get(name, 0) + b - a
    return out
