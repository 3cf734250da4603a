"""Level operands of kernels B3/B4 (the bucket product) shaped around the
CUDA kernel's own tiles, shared by tests/test_torch_bucket.py (the plain
version against the JAX kernel) and tests/test_torch_gpu.py (the kernel
against the plain version). The kernel's level pre-pass flags a's
(64 x 64) and b's (64 x 128) tiles by their largest level; the product
skips the k tiles where either flag is 0, runs only the thresholds that
can raise an output, and stops once none can."""
import numpy as np

A_TILE, B_TILE = (64, 64), (64, 128)
#: uniform levels; most tiles of a, of b or of both at level 0 (each keeps
#: its first k tile); everything at level 0; only the four corner entries of
#: every tile above 0; the worst case, where every threshold of every k tile
#: must run (a at T everywhere, b at T but for one level-0 column in every
#: 32, the narrowest warp tile, so one output of each stays at 0); and
#: levels below 0 and above T, which the kernel clamps
PATTERNS = ("uniform", "a_tiles", "b_tiles", "both_tiles", "all_zero", "corners",
            "worst", "clamp")


def _tiles(shape, tile):
    r, c = shape
    return [(slice(r0, r0 + tile[0]), slice(c0, c0 + tile[1]))
            for r0 in range(0, r, tile[0]) for c0 in range(0, c, tile[1])]


def _clear_tiles(rng, x, tile, k_axis):
    """Most tiles of x (J, R, C) at level 0, each j on its own draw; the
    first k tile (k along ``k_axis``, 1 or 2) stays."""
    for j in range(x.shape[0]):
        for rs, cs in _tiles(x.shape[1:], tile):
            first_k = (rs if k_axis == 1 else cs).start == 0
            if not first_k and rng.random() < 0.7:
                x[j, rs, cs] = 0


def _corners_only(rng, x, tile, t):
    out = np.zeros_like(x)
    if t < 1:
        return out
    for rs, cs in _tiles(x.shape[1:], tile):
        r1, c1 = min(rs.stop, x.shape[1]) - 1, min(cs.stop, x.shape[2]) - 1
        for r in (rs.start, r1):
            for c in (cs.start, c1):
                out[:, r, c] = rng.integers(1, t + 1, x.shape[0])
    return out


def level_operands(rng, pattern, j, m, k, n, t):
    """int32 levels a (J, m, k), b (J, k, n) for T = ``t`` thresholds in
    the named pattern; about half of the uniform levels are 0."""
    a = rng.integers(0, t + 1, (j, m, k)).astype(np.int32)
    b = rng.integers(0, t + 1, (j, k, n)).astype(np.int32)
    a[rng.random(a.shape) < 0.5] = 0
    b[rng.random(b.shape) < 0.5] = 0
    if pattern in ("a_tiles", "both_tiles"):
        _clear_tiles(rng, a, A_TILE, k_axis=2)
    if pattern in ("b_tiles", "both_tiles"):
        _clear_tiles(rng, b, B_TILE, k_axis=1)
    if pattern == "all_zero":
        a[:], b[:] = 0, 0
    if pattern == "corners":
        a, b = _corners_only(rng, a, A_TILE, t), _corners_only(rng, b, B_TILE, t)
    if pattern == "worst":
        a[:], b[:] = t, t
        b[:, :, ::32] = 0
    if pattern == "clamp":
        a = rng.integers(-5, t + 6, (j, m, k)).astype(np.int32)
        b = rng.integers(-5, t + 6, (j, k, n)).astype(np.int32)
    return a, b
