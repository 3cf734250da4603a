"""Kernel B5's wrappers: the ELL gather-contract, with and without the
label gather and the spill ring.

    ell_contract_rows:   out[j, m, v] = max over (u, e) with
                             ell_idx[labs[j], u, e] == v of
                             min(d[j, m, u], ell_ts[labs[j], u, e]),
                         and over ring entries s on label labs[j] with
                             spill_dst[s] == v of
                             min(d[j, m, spill_src[s]], spill_ts[s])
    ell_gather_contract: the same on pre-gathered rows idx/ts (J, U, E)
                         (label j for row j) and no ring

(zero where no term exists). ``ell_contract_rows`` is what a backend's
``contract_rows_ell`` computes: the counterpart of the reference's
gather-contract followed by its ``_fold_spill``;
``ell_gather_contract`` is the counterpart of
``repro.kernels.ell.ell.ell_gather_contract_fused``. Both run on float32
timestamps (zero -inf) and on int32 levels (zero 0). On CUDA tensors
both launch the one hand-written Hopper kernel in
``repro_torch/csrc/ell.cu`` (built by nvcc at first use) or raise; they
take the plain PyTorch versions only for tensors that lie on the CPU.
There is no fallback from the card to the plain version.
"""
from __future__ import annotations

import ctypes

import torch

from ..build import bind, call_on
from .ref import ell_contract_rows_ref, ell_gather_contract_ref

NEG_INF = float("-inf")

_INT_MAX = 2**31 - 1


#: the kernel's entry per element type: float32 timestamps and the
#: bucket backend's int32 levels
_ENTRIES = {torch.float32: "ell_contract_rows_f32",
            torch.int32: "ell_contract_rows_s32"}


def _zero(dtype: torch.dtype):
    """The semiring zero of an element type: -inf on floats, 0 on levels."""
    return NEG_INF if dtype.is_floating_point else 0


def _kernel(dtype: torch.dtype):
    return bind("ell", _ENTRIES[dtype],
                [ctypes.c_void_p] * 4 + [ctypes.c_int] + [ctypes.c_void_p] * 5
                + [ctypes.c_int] * 6 + [ctypes.c_void_p])


def _check_card(d, ts, leaves, ints) -> None:
    """Raise for what the kernel does not take: its element types and
    non-contiguous operands."""
    if d.device.type != "cuda":
        raise ValueError(f"no kernel for device {d.device}")
    if d.dtype not in _ENTRIES or any(t.dtype != d.dtype for t in ts):
        raise TypeError(f"kernel B5 takes float32 or int32 d and timestamps of "
                        f"one type, got {d.dtype}, {[t.dtype for t in ts]}")
    if any(t.dtype != torch.int32 for t in ints):
        raise TypeError(f"kernel B5 takes int32 indices, got "
                        f"{[t.dtype for t in ints]}")
    if not all(t.is_contiguous() for t in (d, *leaves)):
        raise ValueError("kernel B5 takes contiguous operands")


def _launch(d, idx, ts, labs, ring, n_labels: int) -> torch.Tensor:
    """One launch into a new (J, M, U) output; ``labs`` None reads label
    j for row j, ``ring`` None folds no ring."""
    j, m, u = d.shape
    e = idx.shape[2]
    if j * m > _INT_MAX or n_labels * u * e > _INT_MAX:
        raise ValueError(f"J*M={j * m} or L*U*E={n_labels * u * e} exceeds int32")
    out = torch.empty((j, m, u), dtype=d.dtype, device=d.device)
    src, dst, lab, sts = ring if ring is not None else (None,) * 4
    s = 0 if ring is None else src.shape[0]
    lab_bytes = 0 if labs is None else labs.element_size()

    def ptr(t):
        return None if t is None or t.numel() == 0 else t.data_ptr()

    err = call_on(d, _kernel(d.dtype), d.data_ptr(), ptr(idx), ptr(ts), ptr(labs),
                  lab_bytes, ptr(src), ptr(dst), ptr(lab), ptr(sts),
                  out.data_ptr(), j, m, u, e, n_labels, s)
    if err != 0:
        raise RuntimeError(f"ell contraction launch failed: CUDA error {err}")
    return out


def ell_contract_rows(d: torch.Tensor, ell_idx: torch.Tensor,
                      ell_ts: torch.Tensor, labs: torch.Tensor,
                      spill_src: torch.Tensor, spill_dst: torch.Tensor,
                      spill_lab: torch.Tensor,
                      spill_ts: torch.Tensor) -> torch.Tensor:
    """Batched gather-contract of d (J, M, U) against the ELL rows of
    label ``labs[j]`` (leaves ``ell_idx`` int32 / ``ell_ts`` (L, U, E))
    and the spill ring's (S,) leaves, -> (J, M, U), in one launch for all
    J rows. ``labs`` is int32 or int64 (the transition table's own
    column); the element type of d sets the semiring zero: -inf on
    float32 timestamps, 0 on the bucket backend's int32 levels.

    ``ell_contract_rows.launches`` counts the kernel launches (plain int);
    CPU calls and empty problems launch nothing and count nothing."""
    if d.dim() != 3 or ell_idx.dim() != 3 or ell_ts.dim() != 3:
        raise ValueError(f"expected 3-D d and ELL leaves, got d {tuple(d.shape)}, "
                         f"idx {tuple(ell_idx.shape)}, ts {tuple(ell_ts.shape)}")
    j, m, u = d.shape
    ring = (spill_src, spill_dst, spill_lab, spill_ts)
    if (ell_idx.shape != ell_ts.shape or ell_idx.shape[1] != u
            or labs.shape != (j,) or any(t.dim() != 1 for t in ring)
            or len({t.shape[0] for t in ring}) != 1):
        raise ValueError(
            f"shape mismatch: d {tuple(d.shape)}, ELL {tuple(ell_idx.shape)} / "
            f"{tuple(ell_ts.shape)}, labs {tuple(labs.shape)}, ring "
            f"{[tuple(t.shape) for t in ring]}")
    leaves = (ell_idx, ell_ts, labs, *ring)
    if any(t.device != d.device for t in leaves):
        raise ValueError(f"operands on different devices: {d.device}, "
                         f"{[str(t.device) for t in leaves]}")
    if d.device.type == "cpu":
        return ell_contract_rows_ref(d, ell_idx, ell_ts, labs, *ring,
                                     zero=_zero(d.dtype))
    _check_card(d, (ell_ts, spill_ts), leaves,
                (ell_idx, spill_src, spill_dst, spill_lab))
    if labs.dtype not in (torch.int32, torch.int64):
        raise TypeError(f"kernel B5 takes int32 or int64 labs, got {labs.dtype}")
    if j == 0 or m == 0 or u == 0:
        return torch.full((j, m, u), _zero(d.dtype), dtype=d.dtype, device=d.device)
    out = _launch(d, ell_idx, ell_ts, labs, ring, ell_idx.shape[0])
    ell_contract_rows.launches += 1
    return out


ell_contract_rows.launches = 0


def ell_gather_contract(d: torch.Tensor, idx: torch.Tensor,
                        ts: torch.Tensor) -> torch.Tensor:
    """Batched gather-contract d (J, M, U) x ELL rows idx (J, U, E) int32 /
    ts (J, U, E) -> (J, M, U), one launch for all J rows: kernel B5 with
    label j for row j and no ring. The element type sets the semiring
    zero: -inf on float32 timestamps, 0 on the bucket backend's int32
    levels.

    ``ell_gather_contract.launches`` counts the kernel launches (plain
    int); CPU calls and empty problems launch nothing and count nothing."""
    if d.dim() != 3 or idx.dim() != 3 or ts.dim() != 3:
        raise ValueError(f"expected 3-D operands, got d {tuple(d.shape)}, "
                         f"idx {tuple(idx.shape)}, ts {tuple(ts.shape)}")
    j, m, u = d.shape
    if idx.shape != ts.shape or idx.shape[:2] != (j, u):
        raise ValueError(f"shape mismatch: d {tuple(d.shape)}, idx "
                         f"{tuple(idx.shape)}, ts {tuple(ts.shape)}")
    if not (d.device == idx.device == ts.device):
        raise ValueError(f"operands on different devices: {d.device}, "
                         f"{idx.device}, {ts.device}")
    if d.device.type == "cpu":
        return ell_gather_contract_ref(d, idx, ts, zero=_zero(d.dtype))
    _check_card(d, (ts,), (idx, ts), (idx,))
    if j == 0 or m == 0 or u == 0:
        return torch.full((j, m, u), _zero(d.dtype), dtype=d.dtype, device=d.device)
    out = _launch(d, idx, ts, None, None, j)
    ell_gather_contract.launches += 1
    return out


ell_gather_contract.launches = 0
