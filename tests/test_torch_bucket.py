"""Kernels B3/B4 and the bucket backend in the port against the JAX
package: the plain level products against the Pallas kernels (interpret
mode) and the direct max-min on levels, the grid's encode/decode bit for
bit, B5's int32 plain version against the JAX gather-contract on levels,
and the backend's resolution and configuration equality. Tolerance 0: the
operations are integer, max and min, and the grid arithmetic follows the
reference operation for operation in float32. The CUDA kernels themselves
are held against the plain versions on the card (tests/test_torch_gpu.py,
chip_smoke.py).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.backend import BucketBackend as JaxBucket
from repro.kernels.bucket.bucket import bucket_maxmin as jax_b4
from repro.kernels.bucket.bucket import bucket_maxmin_fused as jax_b3
from repro.kernels.bucket.ref import bucket_maxmin_exact as jax_exact
from repro.kernels.ell.ops import ell_gather_contract as jax_ell
from repro_torch.core.contraction import (
    KNOWN_BACKENDS,
    BucketBackend,
    KernelBackend,
    PlainBackend,
    resolve_backend,
)
from repro_torch.kernels.bucket import bucket as b3
from repro_torch.kernels.bucket.ops import bucket_maxmin_op
from repro_torch.kernels.bucket.ref import (
    bucket_maxmin_exact,
    bucket_maxmin_fused_ref,
    bucket_maxmin_ref,
)
from repro_torch.kernels.ell import ell as b5
from repro_torch.kernels.ell.ref import ell_gather_contract_naive, ell_gather_contract_ref
from repro_torch.streaming.service import PersistentQueryService
from repro_torch.streaming.stream import SGT, Stream

from _torch_levels import PATTERNS as LEVEL_PATTERNS
from _torch_levels import level_operands

# tests/test_kernels.py: BUCKET_SHAPES (m, k, n, T), plus odd shapes: m=1,
# k or n not a multiple of 8, T=1
BUCKET_SHAPES = [(16, 16, 16, 4), (128, 128, 128, 8), (70, 200, 90, 3),
                 (1, 130, 257, 6)]
ODD_SHAPES = [(1, 7, 5, 1), (3, 13, 9, 2), (9, 1, 30, 9), (5, 33, 1, 1)]


def _levels(rng, shape, t):
    return rng.integers(0, t + 1, shape).astype(np.int32)


@pytest.mark.parametrize("m,k,n,T", BUCKET_SHAPES + ODD_SHAPES)
def test_plain_b4_matches_pallas_and_exact(m, k, n, T):
    rng = np.random.default_rng(m + k + n + T)
    a, b = _levels(rng, (m, k), T), _levels(rng, (k, n), T)
    kern = np.asarray(jax_b4(jnp.asarray(a), jnp.asarray(b), n_levels=T,
                             interpret=True, bm=64, bn=64, bk=32))
    exact = np.asarray(jax_exact(jnp.asarray(a), jnp.asarray(b)))
    ta, tb = torch.from_numpy(a), torch.from_numpy(b)
    out = bucket_maxmin_ref(ta, tb, T)
    assert out.dtype == torch.int32
    np.testing.assert_array_equal(out.numpy(), kern)
    np.testing.assert_array_equal(out.numpy(), exact)
    assert torch.equal(bucket_maxmin_exact(ta, tb), out)
    # the wrapper and the op on CPU tensors are the plain version and
    # launch nothing
    before = b3.bucket_maxmin.launches
    assert torch.equal(b3.bucket_maxmin(ta, tb, n_levels=T), out)
    assert torch.equal(bucket_maxmin_op(ta, tb, n_levels=T), out)
    assert b3.bucket_maxmin.launches == before


def _plain_b3_equals_jax_and_exact(a, b, t, jax_too=True):
    ta, tb = torch.from_numpy(a), torch.from_numpy(b)
    out = bucket_maxmin_fused_ref(ta, tb, t)
    if jax_too:
        kern = np.asarray(jax_b3(jnp.asarray(a), jnp.asarray(b), n_levels=t,
                                 interpret=True))
        np.testing.assert_array_equal(out.numpy(), kern)
    # the direct max-min on the clamped levels
    assert torch.equal(bucket_maxmin_exact(ta.clamp(0, t), tb.clamp(0, t)), out)
    before = b3.bucket_maxmin_fused.launches
    assert torch.equal(b3.bucket_maxmin_fused(ta, tb, n_levels=t), out)
    assert b3.bucket_maxmin_fused.launches == before


@pytest.mark.parametrize("J", [1, 3])
@pytest.mark.parametrize("m,k,n,T", [(16, 16, 16, 4), (70, 200, 90, 3),
                                     (1, 7, 5, 1), (9, 33, 30, 9)])
def test_plain_b3_matches_pallas_and_exact(J, m, k, n, T):
    """Uniform levels with all-zero rows, then each pattern of
    tests/_torch_levels.py (whole tiles of the CUDA kernel at level 0,
    lone corner entries, the worst case, levels outside [0, T]) at the same
    shape, so the plain version the card kernel is held to is itself held
    to the JAX kernel in each regime."""
    rng = np.random.default_rng(J * 100 + m + k + n + T)
    a, b = _levels(rng, (J, m, k), T), _levels(rng, (J, k, n), T)
    a[:, : max(1, m // 5)] = 0                # all-zero rows
    _plain_b3_equals_jax_and_exact(a, b, T)
    for pattern in LEVEL_PATTERNS:
        _plain_b3_equals_jax_and_exact(*level_operands(rng, pattern, J, m, k, n, T), T)


@pytest.mark.parametrize("T", [0, 1, 9, 127])
def test_plain_b3_at_every_threshold_count(T):
    """T = 0 (every output 0), 1, 9 (the service's) and 127 (the kernel's
    largest) on clamped and worst-case levels against the direct max-min;
    against the JAX kernel too where it takes T (it allocates T counts)."""
    rng = np.random.default_rng(T)
    for pattern in ("clamp", "worst", "corners"):
        a, b = level_operands(rng, pattern, 2, 70, 130, 40, T)
        _plain_b3_equals_jax_and_exact(a, b, T, jax_too=T in (1, 9))


def test_bucket_wrappers_validate():
    a = torch.zeros((2, 3, 4), dtype=torch.int32)
    with pytest.raises(ValueError):
        b3.bucket_maxmin_fused(a, a, n_levels=4)      # k mismatch
    with pytest.raises(ValueError):
        b3.bucket_maxmin(a, a, n_levels=4)            # not 2-D
    # empty problems: zeros of the right shape
    assert b3.bucket_maxmin_fused(torch.zeros((0, 3, 4), dtype=torch.int32),
                                  torch.zeros((0, 4, 5), dtype=torch.int32),
                                  n_levels=4).shape == (0, 3, 5)


def _grid_values(now, w, n_levels):
    """Timestamps around the grid of (now, w): -inf/+inf, random values
    over two windows, and every grid line near the window with its float32
    neighbours on both sides (the origin included)."""
    rng = np.random.default_rng(int(abs(now)) % 1000 + n_levels)
    step = np.float32(w) / np.float32(n_levels)
    origin = np.floor((np.float32(now) - np.float32(w)) / step) * step
    lines = (np.float32(origin)
             + np.arange(-2, n_levels + 4, dtype=np.float32) * step).astype(np.float32)
    x = np.concatenate([
        np.array([-np.inf, np.inf], np.float32),
        rng.uniform(now - 2 * w, now + w / 4, 500).astype(np.float32),
        lines, np.nextafter(lines, np.float32(np.inf)),
        np.nextafter(lines, np.float32(-np.inf))]).astype(np.float32)
    return x


@pytest.mark.parametrize("now,w,n_levels", [
    (23.0, 20.0, 8), (55.5, 2.4, 8), (7.0, 24.0, 8), (31.7, 20.0, 4),
    (1e6 + 0.37, 2.4, 8), (999999.9, 20.0, 8), (123456.7, 3.0, 1),
    (float("-inf"), 20.0, 8)])
def test_encode_decode_bitwise_equal_reference(now, w, n_levels):
    """Levels and decoded float32 equal the reference's bit for bit: -inf,
    values at and just above the origin, the inexact step w=2.4 at T=8,
    and clocks near 1e6 where the snap tolerance scales with the clock."""
    jb, tb = JaxBucket(n_levels, use_pallas=False), BucketBackend(n_levels)
    x = _grid_values(now if np.isfinite(now) else 0.0, w, n_levels)
    jn, jw = jnp.float32(now), jnp.float32(w)
    tn = torch.tensor(now, dtype=torch.float32)
    tw = torch.tensor(w, dtype=torch.float32)
    lj = np.asarray(jb.encode(jnp.asarray(x), jn, jw))
    lt = tb.encode(torch.from_numpy(x), tn, tw)
    assert lt.dtype == torch.int32
    np.testing.assert_array_equal(lt.numpy(), lj)
    dj = np.asarray(jb.decode_state(jnp.asarray(lj), jn, jw))
    dt = tb.decode_state(torch.from_numpy(np.array(lj)), tn, tw)
    np.testing.assert_array_equal(dt.numpy().view(np.int32), dj.view(np.int32))
    # re-encoding a decoded value is the identity (the snap keeps it so)
    np.testing.assert_array_equal(tb.encode(dt, tn, tw).numpy(), lj)
    with pytest.raises(ValueError, match="stream clock"):
        tb.encode(torch.from_numpy(x))


def test_prepare_state_encodes_ell_leaves_and_none():
    """Dense operands, an ELL adjacency's ts/spill_ts leaves (free slots
    land on level 0, the zero) and None operands (the row-sparse path)."""
    from repro_torch.core.sparse_adj import pack_ell_dense

    tb = BucketBackend(8)
    now, w = torch.tensor(30.0), torch.tensor(20.0)
    dense = torch.full((2, 6, 6), float("-inf"))
    dense[0, 1, 2], dense[1, 3, 4], dense[1, 3, 5] = 25.0, 12.0, 29.9
    ell = pack_ell_dense(dense, 2, 4)
    d_op, a_op = tb.prepare_state(dense[None], ell, now, w)
    assert torch.equal(d_op[0], tb.encode(dense, now, w))
    assert torch.equal(a_op.ts, tb.encode(ell.ts, now, w))
    assert torch.equal(a_op.spill_ts, tb.encode(ell.spill_ts, now, w))
    assert torch.equal(a_op.idx, ell.idx) and a_op.ts.dtype == torch.int32
    assert int(a_op.ts.max()) > 0 and int((a_op.ts == 0).sum()) > 0
    assert tb.prepare_state(None, ell, now, w)[0] is None
    assert tb.prepare_state(dense, None, now, w)[1] is None


def test_plain_b5_on_levels_matches_jax():
    """B5's plain version on int32 levels with zero 0 equals the JAX
    gather-contract on levels (its Pallas kernel in interpret mode); the
    wrapper on CPU tensors is the plain version."""
    rng = np.random.default_rng(4)
    j, m, u, e = 3, 5, 13, 3
    d = _levels(rng, (j, m, u), 9)
    idx = rng.integers(0, u, (j, u, e)).astype(np.int32)
    ts = _levels(rng, (j, u, e), 9)
    ts[:, :2] = 0                              # free rows carry the zero
    ref = np.asarray(jax_ell(jnp.asarray(d), jnp.asarray(idx), jnp.asarray(ts),
                             zero=0, use_pallas=True, interpret=True))
    td, ti, tt = (torch.from_numpy(x) for x in (d, idx, ts))
    out = ell_gather_contract_ref(td, ti, tt, zero=0)
    assert out.dtype == torch.int32
    np.testing.assert_array_equal(out.numpy(), ref)
    assert torch.equal(ell_gather_contract_naive(td, ti, tt, zero=0), out)
    assert torch.equal(b5.ell_gather_contract(td, ti, tt), out)


def test_resolve_and_configuration_equality():
    assert KNOWN_BACKENDS == ("cuda", "plain", "mxu_bucket")
    bk = resolve_backend("mxu_bucket")
    assert isinstance(bk, BucketBackend) and bk is resolve_backend("mxu_bucket")
    assert (bk.n_levels, bk.zero, bk.exact, bk.t_alloc) == (8, 0, False, 9)
    assert bk == BucketBackend(8) and hash(bk) == hash(BucketBackend(8))
    assert BucketBackend(8) != BucketBackend(4)
    assert BucketBackend(8) != BucketBackend(8, use_kernels=False)
    assert len({BucketBackend(8), BucketBackend(8), BucketBackend(4)}) == 2
    assert KernelBackend() == resolve_backend("cuda") != PlainBackend()
    assert BucketBackend(8) != resolve_backend("cuda")
    with pytest.raises(ValueError, match="n_levels"):
        BucketBackend(0)


def test_service_refuses_two_bucket_configurations_in_one_group():
    svc = PersistentQueryService(window=10.0, slide=1.0, device="cpu")
    svc.register("a", "a*", n_slots=8, backend=BucketBackend(8))
    svc.register("b", "b*", n_slots=8, backend=BucketBackend(8))
    svc.ingest(Stream([SGT(1.0, 0, 1, "a")]))     # one configuration: fine
    svc = PersistentQueryService(window=10.0, slide=1.0, device="cpu")
    svc.register("a", "a*", n_slots=8, backend=BucketBackend(8))
    svc.register("b", "b*", n_slots=8, backend=BucketBackend(4))
    with pytest.raises(ValueError, match="share one backend"):
        svc.ingest(Stream([SGT(1.0, 0, 1, "a")]))
