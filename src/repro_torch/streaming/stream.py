"""Streaming-graph tuple (sgt) model and ordered stream abstractions."""
from __future__ import annotations

import dataclasses
from typing import Iterable, Iterator, List, Tuple


@dataclasses.dataclass(frozen=True)
class SGT:
    """Streaming graph tuple (Definition 2): (timestamp, edge, label, op)."""

    ts: float
    src: object
    dst: object
    label: str
    op: str = "+"  # '+' insert | '-' explicit delete

    def as_edge(self) -> Tuple[object, object, str, float]:
        return (self.src, self.dst, self.label, self.ts)


class Stream:
    """An in-order sgt sequence with micro-batch iteration."""

    def __init__(self, tuples: Iterable[SGT]):
        self.tuples: List[SGT] = sorted(tuples, key=lambda t: t.ts)

    def __iter__(self) -> Iterator[SGT]:
        return iter(self.tuples)

    def __len__(self) -> int:
        return len(self.tuples)

    def batches(self, size: int) -> Iterator[List[SGT]]:
        for i in range(0, len(self.tuples), size):
            yield self.tuples[i : i + size]

    def span(self) -> Tuple[float, float]:
        return self.tuples[0].ts, self.tuples[-1].ts
