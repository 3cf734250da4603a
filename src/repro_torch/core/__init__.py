"""Core of the port: queries, the batched dense engine and its executor.

Public API (the dense, frontier-off slice of ``repro.core``):
    compile_query(expr)            -- regex -> minimal DFA (+ RSPQ metadata)
    RAPQ / RSPQ                    -- paper-faithful pointer engines (oracle)
    BatchedDenseRPQEngine          -- Q queries, one shared-adjacency step
    DenseRPQEngine                 -- the Q=1 view
    resolve_backend                -- "cuda" (kernel B1, default) | "plain"
    carry_reference_state          -- load a JAX engine's exported state
"""
from .automaton import DFA, compile_query
from .batch import batch_rapq, batch_rspq_bruteforce, snapshot_from_edges, streaming_oracle
from .carry import carry_reference_state
from .contraction import KNOWN_BACKENDS, KernelBackend, PlainBackend, resolve_backend
from .engine import BatchedDenseRPQEngine, DenseRPQEngine, RegisteredQuery
from .executor import Executor, LocalExecutor, QueryTables
from .reference import RAPQ, RSPQ, SnapshotGraph

__all__ = [
    "DFA",
    "compile_query",
    "KNOWN_BACKENDS",
    "KernelBackend",
    "PlainBackend",
    "resolve_backend",
    "RAPQ",
    "RSPQ",
    "SnapshotGraph",
    "BatchedDenseRPQEngine",
    "DenseRPQEngine",
    "RegisteredQuery",
    "Executor",
    "LocalExecutor",
    "QueryTables",
    "batch_rapq",
    "batch_rspq_bruteforce",
    "carry_reference_state",
    "snapshot_from_edges",
    "streaming_oracle",
]
