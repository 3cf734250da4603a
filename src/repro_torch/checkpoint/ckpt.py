"""Atomic, manifest-based checkpoints — the counterpart of
``repro.checkpoint.ckpt``, with the same on-disk layout, so either package
restores what the other wrote:

    <dir>/step_000123/
        manifest.json        tree structure + array metadata + status
        shard_00000.npz      the arrays (one host: the mesh executor is
                             single-process and saves logical tensors)
    <dir>/LATEST             text file: last COMMITTED step directory

* atomicity: the shard is written first, the manifest is written and
  fsynced last, then LATEST is atomically renamed — a crash mid-write can
  never yield a half-checkpoint that :func:`restore` would accept;
* leaves are a pytree of torch tensors, numpy arrays and scalars in dicts,
  lists, tuples and named tuples, flattened to the keys JAX's
  ``tree_flatten_with_path`` gives (sorted dict keys, ``[i]`` for a
  sequence index, ``.field`` for a named tuple's, ``None`` dropped), so
  the npz members and manifest keys are the JAX package's;
* ``bfloat16`` and the float8 leaves are stored as the JAX package stores
  them, as a ``uint16``/``uint8`` bit view tagged with the dtype's name,
  converted through torch's ``view`` (no ``ml_dtypes``);
* async save: the device->host copy happens on the caller's thread (an
  explicit copy, also of CPU tensors, whose numpy view would alias state
  the next dispatch mutates in place); the file IO runs on a background
  thread that makes no CUDA call (``async_save``).
"""
from __future__ import annotations

import io
import json
import os
import pickle
import shutil
import threading
from typing import Any, Callable, Dict, Optional, Tuple

import numpy as np
import torch

SEP = "/"


class SimulatedCrash(RuntimeError):
    """Raised by :func:`save` at an injected crash point (``_crash_after``)
    — the fault-injection harness's stand-in for the process dying mid-
    checkpoint. Everything written so far stays on disk exactly as a real
    kill would leave it; the commit protocol must make the partial state
    invisible to :func:`restore`."""


# dtype name -> (torch dtype, torch bit-view dtype, numpy bit-view dtype);
# npz cannot hold these, so they are stored as unsigned bit views
_VIEW_DTYPES: Dict[str, Tuple[torch.dtype, torch.dtype, type]] = {
    name: (getattr(torch, name), bits, np_bits)
    for name, bits, np_bits in (
        ("bfloat16", torch.int16, np.uint16),
        ("float8_e4m3fn", torch.uint8, np.uint8),
        ("float8_e5m2", torch.uint8, np.uint8),
    )
    if hasattr(torch, name)
}
_VIEW_NAME = {spec[0]: name for name, spec in _VIEW_DTYPES.items()}


def _is_namedtuple(x: Any) -> bool:
    return isinstance(x, tuple) and hasattr(x, "_fields")


def _items(node: Any):
    """(path entry, child) pairs of a container node in JAX's order, or
    None for a leaf."""
    if isinstance(node, dict):
        return [(str(k), node[k]) for k in sorted(node)]
    if _is_namedtuple(node):
        return [(f".{f}", getattr(node, f)) for f in node._fields]
    if isinstance(node, (list, tuple)):
        return [(f"[{i}]", x) for i, x in enumerate(node)]
    return None


def _flatten(tree: Any) -> Dict[str, Any]:
    flat: Dict[str, Any] = {}

    def walk(node: Any, path: Tuple[str, ...]) -> None:
        if node is None:
            return  # an empty subtree, as in JAX
        items = _items(node)
        if items is None:
            flat[SEP.join(path)] = node
            return
        for entry, child in items:
            walk(child, path + (entry,))

    walk(tree, ())
    return flat


def _map_leaves(tree: Any, fn: Callable[[str, Any], Any],
                path: Tuple[str, ...] = ()) -> Any:
    """``tree`` with every leaf replaced by ``fn(key, leaf)``, ``key`` as
    :func:`_flatten` names it (structure kept, ``None`` left as is)."""
    if tree is None:
        return None
    items = _items(tree)
    if items is None:
        return fn(SEP.join(path), tree)
    mapped = {entry: _map_leaves(child, fn, path + (entry,))
              for entry, child in items}
    if isinstance(tree, dict):
        return {k: mapped[str(k)] for k in tree}
    values = [mapped[entry] for entry, _child in items]
    return type(tree)(*values) if _is_namedtuple(tree) else type(tree)(values)


def gather_leaf(leaf: Any) -> Tuple[np.ndarray, str]:
    """One checkpoint leaf as the host array to store (a view of a CPU
    tensor's memory: the caller writes it at once) and the dtype name the
    manifest records (bit views for the dtypes npz cannot hold)."""
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach().cpu()
        name = _VIEW_NAME.get(t.dtype)
        if name is not None:
            _dt, bits, np_bits = _VIEW_DTYPES[name]
            return t.view(bits).numpy().view(np_bits), name
        arr = t.numpy()
        return arr, str(arr.dtype)
    arr = np.asarray(leaf)
    return arr, str(arr.dtype)


def _host_copy(leaf: Any) -> Any:
    """An explicit host copy of a leaf that no later dispatch can mutate."""
    if isinstance(leaf, torch.Tensor):
        return leaf.detach().to("cpu", copy=True)
    if isinstance(leaf, np.ndarray):
        return leaf.copy()
    return leaf


def save(
    directory: str,
    step: int,
    tree: Any,
    extra: Optional[Dict[str, Any]] = None,
    host_id: int = 0,
    _crash_after: Optional[str] = None,
) -> str:
    """Synchronous checkpoint of a pytree of tensors and arrays.

    An :func:`async_save` of ``directory`` still in flight finishes first:
    both would write the same tmp dir when they save the same step (the
    supervisor's breaker handover saves the step its periodic async
    snapshot just started; the JAX package's ``save`` does not wait, and
    the two writers race).

    ``_crash_after`` is a fault-injection hook (tests and the chaos
    harness only): raise :class:`SimulatedCrash` after the named stage
    completes — ``"shards"`` (array file written, no manifest),
    ``"manifest"`` (manifest fsynced inside the tmp dir, commit rename not
    taken), or ``"rename"`` (step dir renamed, LATEST not swung). Each
    partial state leaves :func:`latest_step_dir` at the previous committed
    step."""
    wait_pending(directory)
    return _write(directory, step, tree, extra, host_id, _crash_after)


def _write(directory: str, step: int, tree: Any,
           extra: Optional[Dict[str, Any]], host_id: int,
           _crash_after: Optional[str]) -> str:
    """:func:`save`'s commit protocol (the background thread's entry)."""
    flat = _flatten(tree)
    step_dir = os.path.join(directory, f"step_{step:09d}")
    tmp_dir = step_dir + f".tmp.{host_id}"
    os.makedirs(tmp_dir, exist_ok=True)

    arrays = {}
    meta = {}
    for key, leaf in flat.items():
        arr, dtype_name = gather_leaf(leaf)
        arrays[key.replace(SEP, "__")] = arr
        meta[key] = {"shape": list(arr.shape), "dtype": dtype_name}
    np.savez(os.path.join(tmp_dir, f"shard_{host_id:05d}.npz"), **arrays)
    if _crash_after == "shards":
        raise SimulatedCrash(f"injected crash after shard write: {tmp_dir}")

    manifest = {
        "step": step,
        "arrays": meta,
        "extra": extra or {},
        "n_hosts": 1,
        "status": "committed",
    }
    mpath = os.path.join(tmp_dir, "manifest.json")
    with open(mpath, "w") as f:
        json.dump(manifest, f)
        f.flush()
        os.fsync(f.fileno())
    if _crash_after == "manifest":
        raise SimulatedCrash(
            f"injected crash after manifest, before commit: {tmp_dir}")
    # commit: rename tmp dir, then swing LATEST atomically
    if os.path.exists(step_dir):
        shutil.rmtree(step_dir)
    os.rename(tmp_dir, step_dir)
    if _crash_after == "rename":
        raise SimulatedCrash(
            f"injected crash after rename, before LATEST: {step_dir}")
    latest_tmp = os.path.join(directory, ".LATEST.tmp")
    with open(latest_tmp, "w") as f:
        f.write(os.path.basename(step_dir))
        f.flush()
        os.fsync(f.fileno())
    os.replace(latest_tmp, os.path.join(directory, "LATEST"))
    return step_dir


# one in-flight save per directory, as in the JAX package's API
_pending: Dict[str, threading.Thread] = {}


def async_save(directory: str, step: int, tree: Any,
               extra: Optional[Dict[str, Any]] = None,
               _crash_after: Optional[str] = None) -> None:
    """Host copy now, on the caller's thread; file IO on a background
    thread (one in-flight save per directory).

    ``_crash_after`` rides through to :func:`save`; a
    :class:`SimulatedCrash` raised on the background thread is swallowed
    there — like a real process kill between ``async_save`` and
    ``wait_pending``, the save never commits and the partial tmp dir stays
    behind for the commit protocol to neutralize."""
    wait_pending(directory)
    host_tree = _map_leaves(tree, lambda _key, leaf: _host_copy(leaf))

    def _run() -> None:
        try:
            _write(directory, step, host_tree, extra, 0, _crash_after)
        except SimulatedCrash:
            pass  # the "process" died mid-save; partial state stays on disk

    t = threading.Thread(target=_run)
    t.start()
    _pending[directory] = t


def wait_pending(directory: str) -> None:
    t = _pending.pop(directory, None)
    if t is not None:
        t.join()


def _is_committed(step_dir: str) -> bool:
    mpath = os.path.join(step_dir, "manifest.json")
    if not os.path.exists(mpath):
        return False
    try:
        with open(mpath) as f:
            return json.load(f).get("status") == "committed"
    except (OSError, ValueError):
        return False


def latest_step_dir(directory: str) -> Optional[str]:
    """The last PUBLISHED step directory, or None. Publication is the
    atomic LATEST swing: while LATEST resolves to a committed dir, that
    dir wins (a newer step dir whose save crashed after the rename but
    before the swing stays invisible). Only a missing or dangling LATEST
    falls back to the highest committed ``step_*`` dir; tmp dirs are
    excluded by name, since a crash after the manifest fsync leaves a
    committed-looking manifest inside one."""
    latest = os.path.join(directory, "LATEST")
    if os.path.exists(latest):
        with open(latest) as f:
            name = f.read().strip()
        step_dir = os.path.join(directory, name)
        if _is_committed(step_dir):
            return step_dir
    if not os.path.isdir(directory):
        return None
    for name in sorted(os.listdir(directory), reverse=True):
        if name.startswith("step_") and ".tmp" not in name:
            step_dir = os.path.join(directory, name)
            if _is_committed(step_dir):
                return step_dir
    return None


def manifest_extra(directory: str) -> Dict[str, Any]:
    """The ``extra`` metadata of the latest committed checkpoint, without
    reading any array (e.g. a service's live query set,
    ``extra["dense"]["order"]``)."""
    step_dir = latest_step_dir(directory)
    if step_dir is None:
        raise FileNotFoundError(f"no committed checkpoint under {directory}")
    with open(os.path.join(step_dir, "manifest.json")) as f:
        return json.load(f)["extra"]


def _torch_dtype(np_dtype) -> torch.dtype:
    return torch.from_numpy(np.zeros((0,), np_dtype)).dtype


def _place_like(arr: np.ndarray, stored: str, leaf: Any) -> Any:
    """``arr`` (as read, ``stored`` its manifest dtype) where and as the
    ``like`` leaf is: a tensor on that tensor's device and dtype, numpy in
    the numpy leaf's dtype; a leaf without a dtype takes the stored one."""
    view = _VIEW_DTYPES.get(stored)
    if view is not None:
        t = torch.from_numpy(np.ascontiguousarray(arr)).view(view[1]).view(view[0])
        if isinstance(leaf, torch.Tensor):
            return t.to(device=leaf.device, dtype=leaf.dtype)
        if isinstance(leaf, np.ndarray):
            return t.to(_torch_dtype(leaf.dtype)).numpy()
        return t
    if isinstance(leaf, torch.Tensor):
        return torch.from_numpy(arr).to(device=leaf.device, dtype=leaf.dtype)
    want = getattr(leaf, "dtype", arr.dtype)
    if str(want) != str(arr.dtype):
        arr = arr.astype(want)
    return arr


def restore(directory: str, like: Any) -> Tuple[Any, Dict[str, Any]]:
    """Restore the latest committed checkpoint into the structure of
    ``like``. ``like`` fixes the tree structure, each leaf's dtype and
    placement (a tensor's device; numpy stays on the host); leaf shapes
    come from the file, so a restorer whose capacities differ from the
    writer's gets the writer's arrays back verbatim and re-pads them
    (``BatchedDenseRPQEngine.adopt_state``)."""
    step_dir = latest_step_dir(directory)
    if step_dir is None:
        raise FileNotFoundError(f"no committed checkpoint under {directory}")
    with open(os.path.join(step_dir, "manifest.json")) as f:
        manifest = json.load(f)
    if manifest.get("status") != "committed":
        raise IOError(f"checkpoint {step_dir} not committed")
    arrays: Dict[str, np.ndarray] = {}
    for fn in sorted(os.listdir(step_dir)):
        if fn.startswith("shard_") and fn.endswith(".npz"):
            with np.load(os.path.join(step_dir, fn)) as z:
                for k in z.files:
                    arrays[k.replace("__", SEP)] = z[k]

    flat_like = _flatten(like)
    missing = set(flat_like) - set(arrays)
    if missing:
        raise KeyError(f"checkpoint missing arrays: {sorted(missing)[:5]} ...")
    meta = manifest["arrays"]
    out_flat = {
        key: _place_like(arrays[key],
                         meta.get(key, {}).get("dtype", str(arrays[key].dtype)),
                         leaf)
        for key, leaf in flat_like.items()
    }
    tree = _map_leaves(like, lambda key, _leaf: out_flat[key])
    return tree, manifest["extra"]


# ---------------------------------------------------------------------------
# Opaque-object leaves: host engine state (the reference RPQ engines' pointer
# trees) rides the same manifest and shard as a uint8 leaf. Restore sites
# pass ``pickle_like()`` as the ``like`` leaf (stored shape wins at load).
# ---------------------------------------------------------------------------

# the JAX package's pickled classes and their twins in this package: the
# two core modules are copies (only docstrings differ), RSPQFallback has the
# same fields
_MODULE_TWINS = {
    "repro.core.reference": "repro_torch.core.reference",
    "repro.core.automaton": "repro_torch.core.automaton",
}
_CLASS_TWINS = {
    ("repro.streaming.service", "RSPQFallback"):
        ("repro_torch.streaming.service", "RSPQFallback"),
}


class _PortUnpickler(pickle.Unpickler):
    """Resolves the JAX package's class names to this package's twins, so
    unpickling a leaf the JAX package wrote imports neither ``repro`` nor
    JAX; any other ``repro`` name raises."""

    def find_class(self, module: str, name: str):
        if module in _MODULE_TWINS:
            module = _MODULE_TWINS[module]
        elif (module, name) in _CLASS_TWINS:
            module, name = _CLASS_TWINS[(module, name)]
        elif module == "repro" or module.startswith("repro."):
            raise pickle.UnpicklingError(
                f"{module}.{name} has no counterpart in repro_torch")
        return super().find_class(module, name)


def pickle_leaf(obj: Any) -> np.ndarray:
    """Serialize a python object into a checkpointable uint8 array."""
    return np.frombuffer(pickle.dumps(obj), dtype=np.uint8)


def unpickle_leaf(arr: Any) -> Any:
    """Inverse of :func:`pickle_leaf` (numpy or a tensor), also for leaves
    the JAX package wrote."""
    if isinstance(arr, torch.Tensor):
        arr = arr.detach().cpu().numpy()
    return _PortUnpickler(io.BytesIO(np.asarray(arr).tobytes())).load()


def pickle_like() -> np.ndarray:
    """A ``like`` placeholder for a pickled leaf (shape comes from the file)."""
    return np.zeros((0,), np.uint8)
