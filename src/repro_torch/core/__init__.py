"""Core of the port: queries, the batched dense engine and its executor.

Public API (the local-executor slice of ``repro.core``: dense or ELL
adjacency, dense or row-sparse dist, frontier off, on or auto):
    compile_query(expr)            -- regex -> minimal DFA (+ RSPQ metadata)
    RAPQ / RSPQ                    -- paper-faithful pointer engines (oracle)
    BatchedDenseRPQEngine          -- Q queries, one shared-adjacency step
    DenseRPQEngine                 -- the Q=1 view
    make_churn_oracle              -- fresh-engine oracle for a mid-stream registration
    resolve_backend                -- "cuda" (kernels B1/B2/B5/B6, default) | "plain"
                                      | "mxu_bucket" (BucketBackend: B3/B4, B5 on levels)
    carry_reference_state          -- load a JAX engine's exported state
    carry_reference_dist           -- and its row-sparse dist, leaf for leaf
"""
from .automaton import DFA, compile_query
from .batch import batch_rapq, batch_rspq_bruteforce, snapshot_from_edges, streaming_oracle
from .carry import carry_reference_dist, carry_reference_state
from .contraction import (
    KNOWN_BACKENDS,
    BucketBackend,
    KernelBackend,
    PlainBackend,
    resolve_backend,
)
from .engine import BatchedDenseRPQEngine, DenseRPQEngine, RegisteredQuery, make_churn_oracle
from .executor import Executor, LocalExecutor, QueryTables
from .reference import RAPQ, RSPQ, SnapshotGraph

__all__ = [
    "DFA",
    "compile_query",
    "KNOWN_BACKENDS",
    "BucketBackend",
    "KernelBackend",
    "PlainBackend",
    "resolve_backend",
    "RAPQ",
    "RSPQ",
    "SnapshotGraph",
    "BatchedDenseRPQEngine",
    "DenseRPQEngine",
    "RegisteredQuery",
    "make_churn_oracle",
    "Executor",
    "LocalExecutor",
    "QueryTables",
    "batch_rapq",
    "batch_rspq_bruteforce",
    "carry_reference_dist",
    "carry_reference_state",
    "snapshot_from_edges",
    "streaming_oracle",
]
