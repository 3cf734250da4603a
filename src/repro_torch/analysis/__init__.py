"""Dispatch-hygiene static analysis for the PyTorch/CUDA port.

The counterpart of ``repro.analysis``: an AST rule engine with the same
rule ids, restated for eager PyTorch and CUDA kernels bound through
ctypes. Pure stdlib: importing or running this package imports neither
torch, jax nor ``repro``, so the gate runs on a bare interpreter.

Rules:

* **R1, host syncs on the dispatch path.** Inside the functions that the
  port's counterparts of the JAX package's traced entry points reach
  (``DISPATCH_ROOTS`` in ``rules/r1_dispatch_syncs.py``): ``.item()``,
  ``.tolist()``, ``.cpu()``, ``.numpy()``, ``.to("cpu")``,
  ``device_get``, ``torch.nonzero`` and the other result-size reads,
  ``float/int/bool`` of a non-static value, ``len`` of state, a branch
  on a tensor's truth value, a blocking host-to-device copy. The port's
  intentional syncs (the host fixpoint loop, the frontier's fallback
  decision, the re-pack reads) carry a suppression with their reason:
  the suppressed findings are the reviewed inventory of the path's syncs.
* **R2, capacity bucketing.** Capacity-named assignments ride
  ``_next_pow2`` / ``_round_up`` / x2 doubling, so the port's state
  shapes equal the reference's at every step; no unhashable literal
  reaches an ``lru_cache``'d factory.
* **R3, kernel contracts** (``kernels/``). No literal tile or launch
  size >= 8 handed to a bound C entry; a device pointer reaches a bound
  entry only through ``call_on`` (the tensor's device and stream).
* **R4, backend conformance.** Every subclass of ``Backend``
  (``core/contraction.py``) defines each hook the base leaves raising;
  every string backend name resolves against ``KNOWN_BACKENDS``.
* **R5, accounting.** No ``pop(0)`` / ``insert(0, ...)``; no eager read
  of ``.now`` or of a ``*rounds`` / ``*counts`` name outside the
  sanctioned flush sites, unless through ``device_get``.

Suppression: ``# repro: noqa[R1]`` (or ``noqa[R1,R5]``, or a bare
``# repro: noqa`` for every rule) on the flagged line, with the reason
after it on the same line. The JAX package's analyzer reads the same
directive.

Usage::

    PYTHONPATH=src python -m repro_torch.analysis            # src/repro_torch
    PYTHONPATH=src python -m repro_torch.analysis src/repro_torch --format=json
"""
from .analyzer import Finding, Module, Project, load_project, run  # noqa: F401

__all__ = ["Finding", "Module", "Project", "load_project", "run"]
