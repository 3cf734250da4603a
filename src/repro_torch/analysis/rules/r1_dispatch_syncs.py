"""R1 — host syncs on the dispatch path.

Invariant: the functions that do the work of a dispatch (the port's
counterparts of the JAX package's jitted entry points, and everything
they call) make no device->host sync that nobody reviewed. The JAX
package traces those functions, so a sync inside them cannot happen
there; eager PyTorch runs them op by op, and every read of a CUDA value
on the host (``bool(t)``, ``.item()``, ``.cpu()``, ``torch.nonzero``, a
blocking host-to-device copy) waits for the card to drain its queue. The
port makes some such reads on purpose where the JAX package keeps the
value on the device (its ``lax.while_loop`` fixpoint and ``lax.cond``
fallback are host loops and host decisions here): each carries
``# repro: noqa[R1]`` with its reason on the line, so the suppressed
findings are the reviewed inventory of the path's host syncs, and a new
one fails the gate.

Roots: :data:`DISPATCH_ROOTS` maps each root of the JAX package's call
graph (``repro.analysis``, ``load_project(["src/repro"]).callgraph()``)
to the port's counterparts, by (dotted module, qualname); a root with no
counterpart maps to the reason. Methods are keyed ``Class.method``, so a
method is rooted by listing it. Reachability is the analyzer's
(:class:`~repro_torch.analysis.analyzer.CallGraph`).

Flagged inside reachable functions (functions of ``repro_torch/device.py``
excepted: ``device_get`` and ``device_put`` are the explicit syncs
themselves, flagged where they are called):

* ``.item()``, ``.tolist()``, ``.cpu()``, ``.numpy()``, ``.to("cpu")``
* ``device_get(...)``, the port's explicit sync, and ``device_put(...)``,
  its blocking upload
* ``torch.nonzero`` / ``.nonzero()``, ``torch.argwhere``, one-argument
  ``torch.where``, ``torch.unique`` / ``.unique()``,
  ``torch.masked_select`` / ``.masked_select()``, ``torch.bincount`` /
  ``.bincount()``, ``repeat_interleave`` without ``output_size``,
  ``torch.cuda.synchronize``: operations whose output size or result the
  host must read
* ``float(x)`` / ``int(x)`` / ``bool(x)`` of a non-static expression
  (shape, ndim, numel and ``len`` arithmetic stays legal)
* ``len(x.attr)`` of a non-static attribute
* an ``if`` / ``while`` / conditional-expression / ``assert`` test that
  calls into ``torch.*`` (host queries under ``torch.cuda``, ``torch.is_*``
  and ``torch.get_*`` excepted), or is a bare ``x.any()`` / ``x.all()``:
  the truth value of a tensor
* a subscript by a 0-dim tensor: a local name bound to a full reduction
  (``x.argmax()``, ``x.sum()``, ``torch.argmax(x)``, ... with no dim) or
  such a call itself; PyTorch turns the index into ``select(item())``
* a blocking host-to-device copy: ``torch.tensor(..., device=...)``,
  ``torch.as_tensor(..., device=...)``, or a tensor built on the host
  (``torch.tensor`` / ``torch.as_tensor`` without a device,
  ``torch.from_numpy``) moved by ``.to(<device>)`` / ``.cuda()`` without
  ``non_blocking=True``: the copy waits until the stream drains

Host values are left alone: an expression rooted in ``np.*`` or in a
call of ``device_get``, ``int``, ``len``, ``.tolist()``, ``.numpy()``; a
local name bound only to such values; and, by the port's convention, a
name or attribute ending in ``_h`` or ``_host`` (``cnt_h``,
``mask_host``). Other names are unknowable statically and are flagged
only through the forms above.
"""
from __future__ import annotations

import ast
from typing import Dict, Iterator, Set, Tuple, Union

from ..analyzer import Finding, FuncKey, Project, dotted, is_static_expr, scan_region

RULE = "R1"
TITLE = "host syncs on the dispatch path"

_EX = "repro_torch.core.executor"
_SEMI = "repro_torch.core.semiring"
_MESH = "repro_torch.distributed.executor"
_DRY = "repro_torch.launch.dryrun_rpq"

#: the mesh executor's dispatch methods (one set for its ingest, delete
#: and relax steps) and the shard loops' rounds, which run_lockstep calls
#: as methods
_MESH_ROUND = ((_MESH, "MeshExecutor._shards"), (_MESH, "MeshExecutor._closures"),
               (_MESH, "MeshExecutor._valid"), (_MESH, "MeshExecutor._store"),
               (_SEMI, "_DenseLoop.step"), (_SEMI, "_FrontierLoop.step"))
_TF = "repro_torch.models.transformer"
_LAYERS = "repro_torch.models.layers"
#: the decoder's modules on the serving path, which the model calls as
#: modules (``self.attn(...)``, ``block(...)``): their forward methods
_LM_LAYERS = ((_TF, "Model._run_layers"), (_TF, "Model._embed_inputs"),
              (_TF, "Block.forward"), (_LAYERS, "RMSNorm.forward"),
              (_LAYERS, "Attention.forward"), (_LAYERS, "MLP.forward"),
              (_LAYERS, "Embedding.forward"), (_LAYERS, "LMHead.forward"),
              ("repro_torch.models.ssd", "SSD.forward"),
              ("repro_torch.models.moe", "MoE.forward"))
_LMDRY = "repro_torch.launch.dryrun"
#: the dry run's timed shares run the same decoder through the share
#: model's own embedding and MoE (modules) and inputs
_LM_SHARE = ((_LMDRY, "ShareModel._embed_inputs"), (_LMDRY, "ShareEmbedding.forward"),
             (_LMDRY, "ShareMoE.forward"))

#: the JAX package's call-graph roots -> the port's counterparts, or the
#: reason there is none
DISPATCH_ROOTS: Dict[FuncKey, Union[Tuple[FuncKey, ...], str]] = {
    ("repro.core.executor", "_ingest"): ((_EX, "_ingest"),),
    ("repro.core.executor", "_ingest_frontier"): ((_EX, "_ingest_frontier"),),
    ("repro.core.executor", "_delete"): ((_EX, "_delete"),),
    ("repro.core.executor", "_delete_frontier"): ((_EX, "_delete_frontier"),),
    ("repro.core.executor", "_expire"): ((_EX, "_expire"),),
    ("repro.core.executor", "_clear_slots"): ((_EX, "_clear_slots"),),
    ("repro.core.engine", "_conflict_possible"):
        (("repro_torch.core.engine", "_conflict_possible"),),
    ("repro.kernels.maxmin.maxmin", "maxmin_matmul_fused"):
        (("repro_torch.kernels.maxmin.maxmin", "maxmin_matmul_fused"),),
    ("repro.kernels.maxmin.maxmin", "maxmin_matmul"):
        (("repro_torch.kernels.maxmin.maxmin", "maxmin_matmul"),),
    ("repro.kernels.bucket.bucket", "bucket_maxmin_fused"):
        (("repro_torch.kernels.bucket.bucket", "bucket_maxmin_fused"),),
    ("repro.kernels.bucket.bucket", "bucket_maxmin"):
        (("repro_torch.kernels.bucket.bucket", "bucket_maxmin"),),
    ("repro.kernels.ell.ell", "ell_gather_contract_fused"):
        (("repro_torch.kernels.ell.ell", "ell_contract_rows"),
         ("repro_torch.kernels.ell.ell", "ell_gather_contract")),
    ("repro.kernels.rowsparse.rowsparse", "rowsparse_gather_fused"):
        (("repro_torch.kernels.rowsparse.rowsparse", "rowsparse_gather"),),
    ("repro.distributed.executor", "_mesh_step_fns.ingest_impl"): _MESH_ROUND,
    ("repro.distributed.executor", "_mesh_step_fns.delete_impl"): _MESH_ROUND,
    ("repro.distributed.executor", "_mesh_step_fns.relax_impl"): _MESH_ROUND,
    ("repro.distributed.executor", "_mesh_frontier_ingest.ingest_impl"): _MESH_ROUND,
    ("repro.distributed.executor", "_mesh_frontier_delete.delete_impl"): _MESH_ROUND,
    ("repro.launch.dryrun_rpq", "run_rpq_cell.round_fn"): (
        (_DRY, "make_ring_round.round_fn"), (_DRY, "vchunked_share"),
        (_DRY, "relax_round_vchunked"),
        (_MESH, "batched_round_lowering.round_fn"),
        (_MESH, "batched_round_lowering.share_fn"),
        (_MESH, "frontier_round_lowering.round_fn"),
        (_MESH, "frontier_round_lowering.share_fn"),
        # the lowerings call the rounds they build by local name
        (_MESH, "make_sharded_round.round_fn"),
        (_MESH, "make_sharded_frontier_round.round_fn")),
    ("repro.launch.dryrun", "lower_cell.prefill_step"):
        ((_TF, "Model.prefill"),) + _LM_LAYERS + _LM_SHARE + ((_LMDRY, "prefill_share"),),
    ("repro.launch.dryrun", "lower_cell.serve_step"):
        ((_TF, "Model.decode_step"),) + _LM_LAYERS + _LM_SHARE + ((_LMDRY, "decode_share"),),
}


def port_roots() -> Set[FuncKey]:
    """Every port function :data:`DISPATCH_ROOTS` names."""
    return {key for v in DISPATCH_ROOTS.values() if not isinstance(v, str)
            for key in v}


_SYNC_METHODS = ("item", "tolist", "cpu", "numpy")
#: tensor operations whose result size or value the host reads
_SYNC_OPS = ("nonzero", "argwhere", "unique", "unique_consecutive",
             "masked_select", "bincount")
_CAST_FUNCS = ("float", "int", "bool")
_HOST_FUNCS = ("int", "float", "bool", "len", "str", "range", "isinstance")
_HOST_QUERIES = ("torch.cuda.", "torch.is_", "torch.get_", "torch.backends.")
_H2D_CTORS = ("torch.tensor", "torch.as_tensor")
#: reductions whose result, called with no dim, is a 0-dim tensor
_REDUCTIONS = ("argmax", "argmin", "sum", "max", "min", "amax", "amin", "any",
               "all", "prod", "mean", "count_nonzero")
_EXEMPT_MODULE = "repro_torch/device.py"
_HOST_MODULES = ("np.", "numpy.", "math.")


def _host_suffix(name: str) -> bool:
    return name.endswith("_h") or name.endswith("_host")


def _is_host(node: ast.AST, host: Set[str]) -> bool:
    """True when the expression is evidently a host value (see the module
    docstring); False when unknown."""
    if isinstance(node, ast.Constant):
        return True
    if isinstance(node, ast.Name):
        return node.id in host or _host_suffix(node.id)
    if isinstance(node, ast.Attribute):
        return (_host_suffix(node.attr) or is_static_expr(node)
                or dotted(node).startswith(_HOST_MODULES)
                or _is_host(node.value, host))
    if isinstance(node, (ast.Subscript, ast.Starred)):
        return _is_host(node.value, host)
    if isinstance(node, ast.Call):
        f = dotted(node.func)
        if f.startswith(_HOST_MODULES) or f.rsplit(".", 1)[-1] == "device_get":
            return True
        if f in _HOST_FUNCS or is_static_expr(node):
            return True
        if isinstance(node.func, ast.Attribute):
            if node.func.attr in ("tolist", "numpy", "item"):
                return True
            return _is_host(node.func.value, host)
        return False
    if isinstance(node, ast.Compare):
        return _is_host(node.left, host)
    if isinstance(node, ast.BinOp):
        return _is_host(node.left, host) and _is_host(node.right, host)
    if isinstance(node, ast.BoolOp):
        return all(_is_host(v, host) for v in node.values)
    if isinstance(node, ast.UnaryOp):
        return _is_host(node.operand, host)
    if isinstance(node, (ast.Tuple, ast.List, ast.Set)):
        return all(_is_host(e, host) for e in node.elts)
    return isinstance(node, ast.JoinedStr)


def _bound_names(target: ast.AST) -> Iterator[str]:
    for n in ast.walk(target):
        if isinstance(n, ast.Name):
            yield n.id


def _host_names(fn: ast.AST) -> Set[str]:
    """Local names bound only to host values (assignments and loop
    targets, in source order, to a fixpoint)."""
    binds = []
    for n in scan_region(fn):
        if isinstance(n, ast.Assign):
            binds.extend((t, n.value) for t in n.targets)
        elif isinstance(n, (ast.AnnAssign, ast.AugAssign)) and n.value is not None:
            binds.append((n.target, n.value))
        elif isinstance(n, (ast.For, ast.comprehension)):
            binds.append((n.target, n.iter))
    host: Set[str] = set()
    while True:
        device = {name for t, v in binds if not _is_host(v, host)
                  for name in _bound_names(t)}
        new = {name for t, _v in binds for name in _bound_names(t)} - device
        if new == host:
            return host
        host = new


def _is_full_reduction(node: ast.AST) -> bool:
    """``x.argmax()`` / ``torch.argmax(x)`` and kin with no dim: 0-dim."""
    if not isinstance(node, ast.Call) or node.keywords:
        return False
    func = node.func
    if not isinstance(func, ast.Attribute) or func.attr not in _REDUCTIONS:
        return False
    if dotted(func).startswith("torch."):
        return len(node.args) == 1
    return not node.args


def _scalar_names(fn: ast.AST) -> Set[str]:
    """Local names bound (alone) to a full reduction."""
    return {t.id for n in scan_region(fn) if isinstance(n, ast.Assign)
            and _is_full_reduction(n.value)
            for t in n.targets if isinstance(t, ast.Name)}


def _zero_dim_index(sub: ast.Subscript, scalars: Set[str], host: Set[str]) -> bool:
    if _is_host(sub.value, host):
        return False
    items = sub.slice.elts if isinstance(sub.slice, ast.Tuple) else [sub.slice]
    return any(_is_full_reduction(i) or (isinstance(i, ast.Name) and i.id in scalars)
               for i in items)


def _finding(mod, node, qual, msg) -> Finding:
    """A finding at the node's line; a method call's at the line of the
    method's name, where Python's tracebacks and warnings place it."""
    line, col = node.lineno, node.col_offset
    if isinstance(node, ast.Call) and isinstance(node.func, ast.Attribute):
        line = node.func.end_lineno
        col = node.func.end_col_offset - len(node.func.attr)
    return Finding(RULE, mod.relpath, line, col,
                   f"{msg} inside dispatch-reachable function `{qual}`")


def _kw(call: ast.Call, name: str):
    for kw in call.keywords:
        if kw.arg == name:
            return kw.value
    return None


def _test_reads_tensor(test: ast.AST, host: Set[str]) -> bool:
    """A branch test that calls into torch.* (not a host query), or whose
    truth value is a bare ``x.any()`` / ``x.all()`` of a non-host x."""
    for n in ast.walk(test):
        if isinstance(n, ast.Call):
            d = dotted(n.func)
            if d.startswith("torch.") and not d.startswith(_HOST_QUERIES):
                return True
    tops = [test]
    while tops:
        t = tops.pop()
        if isinstance(t, ast.BoolOp):
            tops.extend(t.values)
        elif isinstance(t, ast.UnaryOp) and isinstance(t.op, ast.Not):
            tops.append(t.operand)
        elif (isinstance(t, ast.Call) and isinstance(t.func, ast.Attribute)
              and t.func.attr in ("any", "all") and not t.args
              and not _is_host(t.func.value, host)):
            return True
    return False


def _h2d(call: ast.Call, host: Set[str]) -> bool:
    """A blocking host-to-device copy (see the module docstring)."""
    f = dotted(call.func)
    dev = _kw(call, "device")
    if f in _H2D_CTORS and dev is not None:
        return not (isinstance(dev, ast.Constant) and dev.value == "cpu")
    if not isinstance(call.func, ast.Attribute) or call.func.attr not in ("to", "cuda"):
        return False
    nb = _kw(call, "non_blocking")
    if isinstance(nb, ast.Constant) and nb.value is True:
        return False
    recv = call.func.value
    built_on_host = (isinstance(recv, ast.Call)
                     and dotted(recv.func) in _H2D_CTORS + ("torch.from_numpy",)
                     and _kw(recv, "device") is None)
    if not built_on_host:
        return False
    if call.func.attr == "cuda":
        return True
    # .to(dtype) alone moves nothing
    args = list(call.args) + ([_kw(call, "device")] if _kw(call, "device") else [])
    return any(not dotted(a).startswith("torch.") for a in args)


def _to_cpu(call: ast.Call) -> bool:
    if not (isinstance(call.func, ast.Attribute) and call.func.attr == "to"):
        return False
    for a in list(call.args) + [kw.value for kw in call.keywords]:
        if isinstance(a, ast.Constant) and a.value == "cpu":
            return True
        if (isinstance(a, ast.Call) and dotted(a.func) == "torch.device" and a.args
                and isinstance(a.args[0], ast.Constant) and a.args[0].value == "cpu"):
            return True
    return False


def _call_finding(call: ast.Call, host: Set[str]) -> str:
    """The sync a call makes, or ''."""
    func = call.func
    d = dotted(func)
    if d.rsplit(".", 1)[-1] == "device_get":
        return "explicit host sync `device_get()`"
    if d.rsplit(".", 1)[-1] == "device_put":
        return "blocking host-to-device copy `device_put()`"
    if d == "torch.cuda.synchronize":
        return "`torch.cuda.synchronize()`"
    if d.startswith("torch.") and d[len("torch."):] in _SYNC_OPS:
        return f"`{d}` reads its result size on the host"
    if d == "torch.where" and len(call.args) == 1:
        return "one-argument `torch.where` reads its result size on the host"
    if _h2d(call, host):
        return "blocking host-to-device copy (pass non_blocking=True)"
    if isinstance(func, ast.Attribute) and not _is_host(func.value, host):
        if func.attr in _SYNC_METHODS and not d.startswith(("np.", "numpy.")):
            return f"host sync `.{func.attr}()`"
        if func.attr in _SYNC_OPS and not d.startswith(("np.", "numpy.", "torch.")):
            return f"`.{func.attr}()` reads its result size on the host"
        if func.attr == "repeat_interleave" and _kw(call, "output_size") is None:
            return "`repeat_interleave` without `output_size` reads its result size"
        if _to_cpu(call):
            return "host sync `.to(\"cpu\")`"
    if isinstance(func, ast.Name) and func.id in _CAST_FUNCS and len(call.args) == 1:
        arg = call.args[0]
        if is_static_expr(arg) or _is_host(arg, host):
            return ""
        # Name args are unknowable statically: only flag attribute chains
        # (state), call results and subscripts of state
        if isinstance(arg, (ast.Attribute, ast.Call)) or (
                isinstance(arg, ast.Subscript)
                and isinstance(arg.value, (ast.Attribute, ast.Call))):
            return f"`{func.id}()` of a non-static value is a host sync"
    if (isinstance(func, ast.Name) and func.id == "len" and len(call.args) == 1
            and isinstance(call.args[0], ast.Attribute)
            and not is_static_expr(call.args[0])
            and not _is_host(call.args[0], host)):
        return "`len()` of device state: use a static `.shape` dim"
    return ""


def check(project: Project) -> Iterator[Finding]:
    graph = project.callgraph(port_roots())
    for mod, qual, fn in graph.reachable_functions():
        if mod.relpath.endswith(_EXEMPT_MODULE):
            continue
        host = _host_names(fn)
        scalars = _scalar_names(fn) - host
        for n in scan_region(fn):
            if isinstance(n, ast.Subscript) and _zero_dim_index(n, scalars, host):
                yield _finding(mod, n, qual,
                               "indexing with a 0-dim tensor reads it on the host")
            test = getattr(n, "test", None)
            if (isinstance(n, (ast.If, ast.While, ast.IfExp, ast.Assert))
                    and _test_reads_tensor(test, host)):
                yield _finding(mod, n, qual,
                               "branch on a tensor's truth value reads it on "
                               "the host")
            if isinstance(n, ast.Call):
                msg = _call_finding(n, host)
                if msg:
                    yield _finding(mod, n, qual, msg)
