"""Fault-tolerance helpers for long-running jobs — the counterpart of
``repro.distributed.fault`` (the mesh executor is its sibling,
:mod:`repro_torch.distributed.executor`).

* **checkpoint/restart loop** — `run_with_restarts` wraps a step function
  over a pytree of tensors (a dict of them, say), snapshots every
  `ckpt_every` steps (async), and on ANY exception restores the latest
  committed checkpoint and continues. Failures mid-save can never corrupt
  state (the atomic manifest + LATEST protocol of checkpoint/ckpt.py);
  restored tensors land on the devices of the state they replace.

* **straggler mitigation** — `StragglerMonitor` tracks per-step durations;
  a step exceeding `deadline_factor` x the trailing median is recorded and
  the policy hook `on_straggler` lets the driver act on it. It judges the
  durations it is given, so a caller (or a test) may feed fixed ones.

* **supervised service** — `run_service_with_restarts` is the same
  contract over `PersistentQueryService` micro-batches, with WAL-suffix
  replay (streaming/supervisor.py).
"""
from __future__ import annotations

import time
from statistics import median
from typing import Any, Callable, Dict, List, Optional, Tuple

from ..checkpoint import ckpt


class StragglerMonitor:
    def __init__(self, deadline_factor: float = 3.0, warmup: int = 5):
        self.deadline_factor = deadline_factor
        self.warmup = warmup
        self.times: List[float] = []
        self.stragglers: List[int] = []

    def observe(self, step: int, dt: float) -> bool:
        """Record a step time; returns True if this step was a straggler."""
        is_straggler = False
        if len(self.times) >= self.warmup:
            med = median(self.times[-32:])
            if dt > self.deadline_factor * med:
                self.stragglers.append(step)
                is_straggler = True
        self.times.append(dt)
        return is_straggler


def run_with_restarts(
    step_fn: Callable[[Any, int], Any],
    init_state: Any,
    n_steps: int,
    ckpt_dir: str,
    ckpt_every: int = 10,
    max_restarts: int = 3,
    on_straggler: Optional[Callable[[int], None]] = None,
    monitor: Optional[StragglerMonitor] = None,
) -> Tuple[Any, Dict[str, Any]]:
    """Supervised training loop: periodic async checkpoints, restore-on-crash."""
    state = init_state
    start = 0
    restarts = 0
    monitor = monitor or StragglerMonitor()
    # resume if a committed checkpoint exists
    try:
        state, extra = ckpt.restore(ckpt_dir, like=state)
        start = int(extra.get("step", 0))
    except FileNotFoundError:
        pass

    step = start
    while step < n_steps:
        try:
            t0 = time.monotonic()
            state = step_fn(state, step)
            dt = time.monotonic() - t0
            if monitor.observe(step, dt) and on_straggler is not None:
                on_straggler(step)
            step += 1
            if step % ckpt_every == 0 or step == n_steps:
                ckpt.async_save(ckpt_dir, step, state, extra={"step": step})
        except Exception:
            restarts += 1
            if restarts > max_restarts:
                raise
            ckpt.wait_pending(ckpt_dir)
            try:
                state, extra = ckpt.restore(ckpt_dir, like=state)
                step = int(extra.get("step", 0))
            except FileNotFoundError:
                state = init_state
                step = 0
    ckpt.wait_pending(ckpt_dir)
    return state, {
        "restarts": restarts,
        "stragglers": list(monitor.stragglers),
        "final_step": step,
    }


def run_service_with_restarts(
    make_service: Callable[..., Any],
    stream: Any,
    ckpt_dir: str,
    *,
    batch_events: int = 8,
    ckpt_every: int = 4,
    max_restarts: int = 8,
    fault_plan: Any = None,
    on_straggler: Optional[Callable[[int], None]] = None,
    monitor: Optional[StragglerMonitor] = None,
    **supervisor_kwargs: Any,
) -> Tuple[Dict[str, Any], Dict[str, Any]]:
    """`run_with_restarts` ported onto `PersistentQueryService`: the same
    supervise/checkpoint/restore contract, but the unit of work is a WAL-logged
    micro-batch instead of a training step, and restore is followed by exact
    WAL-suffix replay (streaming/supervisor.py) rather than recompute-forward.

    Per-batch wall times feed the same `StragglerMonitor`; detected stragglers
    invoke `on_straggler(lsn)` and land in the supervisor's `health_log`.

    Returns ``(final_results, report)`` where the report mirrors
    `run_with_restarts`'s (restarts / stragglers / final step) plus the
    recovery measurements the service path adds.
    """
    from ..streaming.supervisor import ServiceSupervisor

    sup = ServiceSupervisor(
        make_service, ckpt_dir,
        batch_events=batch_events, ckpt_every=ckpt_every,
        max_restarts=max_restarts, fault_plan=fault_plan,
        monitor=monitor or StragglerMonitor(),
        on_straggler=on_straggler, **supervisor_kwargs)
    results = sup.run(stream)
    return results, {
        "restarts": sup.restarts,
        "stragglers": list(sup.stragglers),
        "final_step": sup.wal.last_lsn,
        "recoveries": [
            {"recovery_s": r.recovery_s, "replayed_events": r.replayed_events,
             "replay_eps": r.replay_eps} for r in sup.recoveries],
        "health_log": list(sup.health_log),
    }
