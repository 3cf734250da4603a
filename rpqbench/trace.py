"""The profiler window reader: device activity of the timed window from
``torch.profiler`` (device events only; recording the host's operators
as well tripled a window's wall time), reduced to busy time, idle gaps
named by the benchmark's own host span open at the time, and device
time by operation.

The device timestamps are the profiler's, on the host's wall clock; the
host spans are ``time.time_ns`` around each call of the window.
"""
from __future__ import annotations

import bisect
from typing import Dict, List, Optional, Tuple

#: the port's own CUDA kernels (``repro_torch/csrc``), by kernel name
PORT_KERNELS = {
    "b1": ("occupancy_kernel", "maxmin_fused_kernel"),
    "b5": ("ell_contract_kernel",),
    "b6": ("rowsparse_gather_kernel",),
    "b3": ("levels_kernel", "bucket_product_kernel"),
}


def start_profiler():
    """The profiler over the card's activity (over the host's where the
    build has no CUDA, so that a CPU rehearsal runs the same code)."""
    from torch.profiler import ProfilerActivity, profile, supported_activities

    act = (ProfilerActivity.CUDA if ProfilerActivity.CUDA in supported_activities()
           else ProfilerActivity.CPU)
    prof = profile(activities=[act])
    prof.start()
    return prof


def kernel_of(name: str) -> Optional[str]:
    """Which of the port's kernels (``b1``, ``b5``, ...) an operation
    is, or None for every other device operation."""
    for kern, names in PORT_KERNELS.items():
        if any(n in name for n in names):
            return kern
    return None


def _device_events(prof) -> List[Tuple[str, int, int]]:
    from torch.autograd import DeviceType

    out = []
    for ev in prof.profiler.kineto_results.events():
        if ev.device_type() != DeviceType.CUDA:
            continue
        start = ev.start_ns()
        end = ev.end_ns() if hasattr(ev, "end_ns") else start + ev.duration_ns()
        if end > start:
            out.append((ev.name(), start, end))
    return out


def _union(intervals: List[Tuple[int, int]]) -> List[Tuple[int, int]]:
    out: List[Tuple[int, int]] = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            if b > out[-1][1]:
                out[-1] = (out[-1][0], b)
        else:
            out.append((a, b))
    return out


def span_name(what, prev_ts: Optional[float], slide: float) -> str:
    """A host span's name: the one given, or ``ingest`` with the sgt's
    operation, and whether it opened a slide interval."""
    if isinstance(what, str):
        return what
    name = "ingest insert" if what.op == "+" else "ingest delete"
    if prev_ts is not None and int(what.ts // slide) != int(prev_ts // slide):
        name += " at a slide boundary"
    return name


class DeviceWindow:
    """The traced window: stops the profiler and reduces its events."""

    def __init__(self, prof, spans: List[tuple], t0_ns: int, t1_ns: int,
                 slide: float):
        prof.stop()
        self.events = _device_events(prof)
        self.t0_ns, self.t1_ns = t0_ns, t1_ns
        self.window_s = (t1_ns - t0_ns) / 1e9
        self.busy = _union([(a, b) for _n, a, b in self.events])
        self.busy_s = sum(b - a for a, b in self.busy) / 1e9
        self.by_name: Dict[str, float] = {}
        for name, a, b in self.events:
            self.by_name[name] = self.by_name.get(name, 0.0) + (b - a) / 1e9
        inside = sum(min(b, t1_ns + 10**6) - max(a, t0_ns - 10**6)
                     for a, b in self.busy if b > t0_ns - 10**6 and a < t1_ns + 10**6)
        #: device and host clocks agree (the busy time falls in the window)
        self.aligned = bool(self.busy) and inside >= 0.95 * sum(b - a for a, b in self.busy)
        names, prev = [], None
        for what, _a, _b in spans:
            names.append(span_name(what, prev, slide))
            if not isinstance(what, str):
                prev = what.ts
        self.spans = [(a, b, n) for (_w, a, b), n in zip(spans, names)]

    def device_s(self, kernel: Optional[str] = None, others: bool = False) -> float:
        """Device seconds of one of the port's kernels (``"b1"``...), or
        with ``others`` of every operation that is none of them."""
        total = 0.0
        for name, sec in self.by_name.items():
            k = kernel_of(name)
            if (others and k is None) or (not others and k == kernel):
                total += sec
        return total

    def gaps(self) -> List[Tuple[float, str]]:
        """Idle intervals of the window, each with the host span open at
        its midpoint ("between calls" where none is)."""
        out = []
        edges = [self.t0_ns]
        for a, b in self.busy:
            if b > self.t0_ns and a < self.t1_ns:
                edges += [max(a, self.t0_ns), min(b, self.t1_ns)]
        edges.append(self.t1_ns)
        starts = [a for a, _b, _n in self.spans]
        for k in range(0, len(edges), 2):
            a, b = edges[k], edges[k + 1]
            if b <= a:
                continue
            name = "unaligned clocks"
            if self.aligned:
                mid = (a + b) // 2
                j = bisect.bisect_right(starts, mid) - 1
                name = (self.spans[j][2] if j >= 0 and self.spans[j][1] >= mid
                        else "between calls")
            out.append(((b - a) / 1e9, name))
        return out

    def breakdown(self, top: int = 10) -> dict:
        ops = sorted(self.by_name.items(), key=lambda kv: -kv[1])[:top]
        by_span: Dict[str, List[float]] = {}
        for sec, name in self.gaps():
            by_span.setdefault(name, []).append(sec)
        idle = sorted(((f"{name} ({len(v)} gaps, longest {max(v)} s)", sum(v))
                       for name, v in by_span.items()), key=lambda kv: -kv[1])[:top]
        return {"device_ops": [[n, s] for n, s in ops],
                "idle_gaps": [[n, s] for n, s in idle]}
