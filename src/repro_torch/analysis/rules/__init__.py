"""Rule registry. Each rule is a module exposing ``RULE`` (the id used in
findings and ``# repro: noqa[...]``), ``TITLE``, and ``check(project)``
yielding :class:`~repro_torch.analysis.analyzer.Finding`."""
from . import (r1_dispatch_syncs, r2_recompile, r3_kernel_contracts,
               r4_backend_conformance, r5_accounting)

ALL_RULES = (r1_dispatch_syncs, r2_recompile, r3_kernel_contracts,
             r4_backend_conformance, r5_accounting)

__all__ = ["ALL_RULES"]
