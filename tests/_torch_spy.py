"""A spy on the mesh executor's dispatches (tests/test_torch_mesh_layout.py,
and chip_smoke.py's phase 14 on the card): no ingest or delete dispatch
may build a whole adjacency or dist on one device, or move the adjacency
between devices. Imports only torch."""
import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves


class WholeSlabSpy(TorchDispatchMode):
    """Records every newly allocated floating-point tensor shaped as the
    whole (L, N, N) adjacency, or laid out as dist rows (its last axis K or
    N*K; the overflow table aside) holding at least a whole (Q, N, N, K)
    dist's elements (outputs
    that share storage with an input, views and in-place updates, are not
    new), and every ``.to(device)`` of a 3-D tensor shaped as an adjacency
    block (L, N, *) or (L, *, N)."""

    def __init__(self, l, n, q, k, table_rows=None):
        super().__init__()
        self.adj, self.dist_numel, self.l, self.n = (l, n, n), q * n * n * k, l, n
        self.row_widths = (k, n * k)
        self.table = (table_rows, n * k)
        self.new, self.moved = [], []
        self._to = None

    def _whole(self, t):
        # a row-sparse dist's overflow table (R, N*K) is not a dist slab,
        # even where R is every row (the table's default at small sizes)
        return tuple(t.shape) == self.adj or (
            t.dim() >= 2 and t.shape[-1] in self.row_widths
            and t.numel() >= self.dist_numel and tuple(t.shape) != self.table)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        seen = {t.untyped_storage().data_ptr()
                for t in tree_leaves((args, kwargs)) if isinstance(t, torch.Tensor)}
        for t in tree_leaves(out):
            if (isinstance(t, torch.Tensor) and t.is_floating_point()
                    and t.untyped_storage().data_ptr() not in seen
                    and self._whole(t)):
                self.new.append((str(func), tuple(t.shape)))
        return out

    def __enter__(self):
        to, spy = torch.Tensor.to, self

        def spied(t, *args, **kwargs):
            devices = [a for a in args if isinstance(a, (str, torch.device))]
            if (devices or "device" in kwargs) and t.dim() == 3 \
                    and t.shape[0] == spy.l and spy.n in t.shape[1:]:
                spy.moved.append(tuple(t.shape))
            return to(t, *args, **kwargs)

        self._to = to
        torch.Tensor.to = spied
        return super().__enter__()

    def __exit__(self, *exc):
        torch.Tensor.to = self._to
        return super().__exit__(*exc)


def spy_dispatches(ex) -> WholeSlabSpy:
    """Put every later ingest and delete dispatch of executor ``ex`` under
    one :class:`WholeSlabSpy` sized from its current state; returns it."""
    l, n, _ = ex.adj_shape
    q, _, _, k = ex.dist_shape
    spy = WholeSlabSpy(l, n, q, k, ex.dist_ovf_cap)
    for name in ("ingest_batch", "delete_batch"):
        fn = getattr(ex, name)

        def wrapped(*args, _fn=fn, **kwargs):
            with spy:
                return _fn(*args, **kwargs)

        setattr(ex, name, wrapped)
    return spy
