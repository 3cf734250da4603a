"""The yardstick's peaks and bounds: a frozen copy of ``chip_smoke.py``'s
``bound_ms`` and ``bound_ell_ms`` at the published H100 SXM peaks.

A bound is the least time the chip could take for one launch: the larger
of the bytes it must move (each input read once, each output written
once) over the HBM bandwidth and the min/max operations over the float32
rate outside the tensor cores.
"""
from __future__ import annotations

from typing import Tuple

PEAK_F32_OPS = 67e12      # H100 SXM, float32 outside the tensor cores (min/max)
PEAK_BYTES = 3.35e12      # H100 SXM, HBM3 bytes per second


def bound_ms(j: int, m: int, k: int, n: int, itemsize: int = 4,
             ops: float = None) -> Tuple[float, str]:
    """(bound in ms, "bytes" | "operations") of one (J, m, k) x (J, k, n)
    max-min product. ``ops`` is the min and max count the operands need;
    None counts one min and one max per (j, i, k, n), as the original."""
    t_bytes = itemsize * (j * m * k + j * k * n + j * m * n) / PEAK_BYTES
    t_ops = (2.0 * j * m * k * n if ops is None else float(ops)) / PEAK_F32_OPS
    return max(t_bytes, t_ops) * 1e3, ("operations" if t_ops >= t_bytes else "bytes")


def bound_ell_ms(j: int, m: int, u: int, e: int, live_candidates: int,
                 n_labels: int, ring: int) -> Tuple[float, str]:
    """(bound in ms, "bytes" | "operations") of one ELL contraction with
    the label gather and the ring folded in: d (J, M, U) read and the
    (J, M, U) output written once, the (L, U, E) ELL leaves (int32 index,
    4-byte timestamp) and the ring's four (S,) leaves read once, against
    one min and one max per live candidate."""
    t_bytes = (4 * 2 * j * m * u + 8 * n_labels * u * e + 16 * ring) / PEAK_BYTES
    t_ops = 2.0 * live_candidates / PEAK_F32_OPS
    return max(t_bytes, t_ops) * 1e3, ("operations" if t_ops >= t_bytes else "bytes")
