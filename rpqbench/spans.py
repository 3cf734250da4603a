"""The program's layer spans in a traced window, for the per-layer metrics
that read them (``metrics/service.self_ms_per_sgt.py`` and the others):
self time by layer a sgt, the host's waits on the card, and the card's
idle time by the innermost span open over it.

The spans are ``repro_torch.obs``'s: ``(name, t0_ns, t1_ns)`` named
``<layer>.<what>``, recorded inside ``ingest(record_latency=True)``, which
the traced window calls, on the host clock the profiler puts its device
timestamps on (``trace.DeviceWindow``). A span's self time is its time
less that of the spans nested in it (``obs.self_ns``). A program that
records no spans (one without ``repro_torch.obs``) gives every reader
here nothing to read: None.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Tuple

#: the name of idle time that no program span covers
NO_SPAN = "no program span"


def _obs():
    try:
        from repro_torch import obs
    except ImportError:
        return None
    return obs


def window_spans(run) -> Optional[List[Tuple[str, int, int]]]:
    """The program's spans inside the traced window, or None."""
    w, obs = run.device_window, _obs()
    if w is None or obs is None or not run.window_sgts:
        return None
    return obs.RECORDER.between(w.t0_ns, w.t1_ns) or None


def self_ms_per_sgt(run, prefix: str) -> Optional[float]:
    """Self time of the spans whose names start with ``prefix``, over the
    window's sgts (ms)."""
    spans = window_spans(run)
    if spans is None:
        return None
    ns = sum(v for name, v in _obs().self_ns(spans).items()
             if name.startswith(prefix))
    return ns / 1e6 / run.window_sgts


def idle_intervals(w) -> List[Tuple[int, int]]:
    """The window's idle intervals (ns): its time outside the device's
    busy intervals."""
    out, cur = [], w.t0_ns
    for a, b in w.busy:
        if b <= cur:
            continue
        if a >= w.t1_ns:
            break
        if a > cur:
            out.append((cur, a))
        cur = b
    if cur < w.t1_ns:
        out.append((cur, w.t1_ns))
    return out


def idle_cover(run) -> Optional[List[Tuple[int, int, Dict[str, int]]]]:
    """Each idle interval ``(a, b)`` of the window (ns) with its ns under
    each innermost program span (:data:`NO_SPAN` where none is open), or
    None where the window has no device events, no spans or unaligned
    clocks."""
    w = run.device_window
    spans = window_spans(run)
    if spans is None or not w.events or not w.aligned:
        return None
    pieces = _obs().innermost(spans)
    out = []
    i = 0
    for a, b in idle_intervals(w):
        while i < len(pieces) and pieces[i][2] <= a:
            i += 1
        cover: Dict[str, int] = {}
        j = i
        while j < len(pieces) and pieces[j][1] < b:
            name, p0, p1 = pieces[j]
            part = min(b, p1) - max(a, p0)
            if part > 0:
                cover[name] = cover.get(name, 0) + part
            j += 1
        rest = b - a - sum(cover.values())
        if rest:
            cover[NO_SPAN] = rest
        out.append((a, b, cover))
    return out


def idle_by_span(run) -> Optional[Dict[str, float]]:
    """The card's idle seconds in the window by the innermost program span
    open over them (:func:`idle_cover`), or None."""
    cover = idle_cover(run)
    if cover is None:
        return None
    out: Dict[str, float] = {}
    for _a, _b, by_name in cover:
        for name, ns in by_name.items():
            out[name] = out.get(name, 0) + ns
    return {name: ns / 1e9 for name, ns in out.items()}


def idle_host_bound_pct(run) -> Optional[float]:
    """The share of the window (%) in which the card is idle and the
    innermost open span is a program span other than ``sync.*``: host work
    the card waited for."""
    idle = idle_by_span(run)
    if idle is None:
        return None
    host = sum(s for name, s in idle.items()
               if name != NO_SPAN and not name.startswith("sync."))
    return 100.0 * host / run.device_window.window_s
