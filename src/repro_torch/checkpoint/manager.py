"""Checkpoints of the port's param trees, in the JAX package's format 3.

Counterpart of ``src/repro/checkpoint/manager.py``: the same directory
layout, manifest and ``.npy`` files, so each package restores what the
other saved, bit for bit.

* **Atomicity** — leaves are written to ``step_<N>.tmp/`` and the directory
  is renamed only after every array and the manifest are fsynced; restore
  only sees steps whose manifest is complete.
* **Async save** — ``save`` copies every leaf to the host, then a
  background thread writes it (a queue of one slot: a second save waits
  for the first rather than piling up host copies).
* **Retention** — keep the last ``keep`` checkpoints, never deleting the
  one a restore came from.
* **Names** — a leaf is named by its path as the JAX package names it:
  dict keys as they are, ``[i]`` for a list or tuple index, joined by
  ``/``, leaves listed in the order ``jax.tree_util`` flattens (dict keys
  sorted); a NamedTuple's entries by field name (a ``TrainState``'s
  ``params/...``, ``opt/m/...``, ``opt/step``, ``step``).  Restore reads
  entries by name, never by position.
* **Structure** — the manifest's ``structure`` descriptor keeps the
  containers that hold no leaf (``None`` slots, ``{}``, tuples), so
  ``restore_tree`` rebuilds the tree from the manifest alone.
* **Dtypes** — bf16 leaves are stored as ``u2`` views of their bits and
  the manifest names their logical dtype ``"bfloat16"``; the views go
  through ``torch.int16``, so nothing here needs ``ml_dtypes``.
* **Factorized banks** — a padded per-expert factor bank
  (``.../experts/<proj>/u`` (E, kmax, m) or ``.../v`` (E, n, kmax)) records
  ``rank_per_expert``: kmax less each expert's trailing slices whose BITS
  are all zero (a ``-0.0`` is not padding).  ``reslice_banks=True`` writes
  each expert's factors cut to that rank, one file an expert; restore pads
  them back with ``+0.0``.

Restore puts the tensors on the caller's device: the card unless
``device="cpu"`` (or another device) is given.
"""

from __future__ import annotations

import json
import os
import queue
import shutil
import threading
import time
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.device import resolve_device

PyTree = Any

MANIFEST_FORMAT = 3


def _flatten_with_paths(tree, prefix: Tuple[str, ...] = ()
                        ) -> List[Tuple[str, Any]]:
    """(name, leaf) in ``jax.tree_util``'s flatten order: dict keys sorted,
    sequences by index, ``None`` holding no leaf."""
    if tree is None:
        return []
    if isinstance(tree, dict):
        out = []
        for k in sorted(tree):
            out += _flatten_with_paths(tree[k], prefix + (str(k),))
        return out
    if isinstance(tree, (list, tuple)):
        out = []
        for key, v in zip(_seq_keys(tree), tree):
            out += _flatten_with_paths(v, prefix + (key,))
        return out
    return [("/".join(prefix), tree)]


def _seq_keys(seq) -> List[str]:
    """Path segments of a sequence's entries: a NamedTuple's field names
    (a train state's ``params`` / ``opt`` / ``step``, as the JAX package
    names them), else ``[i]``."""
    if hasattr(seq, "_fields"):
        return list(seq._fields)
    return [f"[{i}]" for i in range(len(seq))]


def _structure_desc(tree) -> Any:
    """JSON-able container descriptor: dicts / lists / tuples recurse,
    ``None`` maps to JSON null, anything else is a leaf."""
    if tree is None:
        return None
    if isinstance(tree, dict):
        return {"d": {str(k): _structure_desc(v) for k, v in tree.items()}}
    if isinstance(tree, (list, tuple)):
        tag = "l" if isinstance(tree, list) else "t"
        return {tag: [_structure_desc(v) for v in tree]}
    return "leaf"


def _build_from_desc(desc, node):
    """Rebuild a tree from its descriptor + nested name→tensor ``node``."""
    if desc is None:
        return None
    if desc == "leaf":
        return node
    if "d" in desc:
        sub = node if isinstance(node, dict) else {}
        return {k: _build_from_desc(v, sub.get(k))
                for k, v in desc["d"].items()}
    items = desc["l"] if "l" in desc else desc["t"]
    sub = node if isinstance(node, dict) else {}
    seq = [_build_from_desc(v, sub.get(f"[{i}]"))
           for i, v in enumerate(items)]
    return seq if "l" in desc else tuple(seq)


def _to_host(leaf) -> Tuple[np.ndarray, str]:
    """(storable numpy copy, logical dtype name).  Floats numpy has no
    builtin type for (bf16, fp8) are stored as unsigned views of their
    bits; numpy arrays of such types are handled the same way."""
    if torch.is_tensor(leaf):
        t = leaf.detach().to("cpu", copy=True).contiguous()
        name = str(t.dtype).replace("torch.", "")
        if t.dtype.is_floating_point and t.dtype not in (
                torch.float16, torch.float32, torch.float64):
            bits = {1: torch.uint8, 2: torch.int16}[t.element_size()]
            raw = t.view(bits).numpy()
            return raw.view(f"u{t.element_size()}"), name
        arr = t.numpy()
        return arr, str(arr.dtype)
    arr = np.array(leaf, copy=True)
    if arr.dtype.kind in "biufc" or arr.dtype == bool:
        return arr, str(arr.dtype)
    return (np.ascontiguousarray(arr).view(f"u{arr.dtype.itemsize}"),
            str(arr.dtype))


def _is_builtin(name: str) -> bool:
    """Whether numpy has ``name`` as a builtin type (an extension type such
    as ``ml_dtypes``' bfloat16, where registered, has kind ``V``)."""
    try:
        return np.dtype(name).kind in "biufc"
    except TypeError:
        return False


def _to_tensor(store: np.ndarray, logical: str, device) -> torch.Tensor:
    """A stored array back as a tensor of its logical dtype on ``device``."""
    if _is_builtin(logical):
        arr = store if store.dtype == np.dtype(logical) \
            else store.view(logical)
        return torch.from_numpy(np.ascontiguousarray(arr)).to(device)
    dtype = getattr(torch, logical)
    signed = {1: np.int8, 2: np.int16}[store.dtype.itemsize]
    bits = torch.from_numpy(np.ascontiguousarray(store).view(signed).copy())
    if store.dtype.itemsize == 1:
        bits = bits.view(torch.uint8)
    return bits.view(dtype).to(device)


def _bank_rank_axis(name: str, arr) -> Optional[int]:
    """Rank axis of a padded per-expert factor bank leaf, else ``None``:
    ``experts/<proj>/u`` (E, kmax, m) -> -2, ``experts/<proj>/v``
    (E, n, kmax) -> -1."""
    if getattr(arr, "ndim", 0) != 3 or "/experts/" not in name:
        return None
    if name.endswith("/u"):
        return -2
    if name.endswith("/v"):
        return -1
    return None


def _logical_ranks(store: np.ndarray, axis: int) -> List[int]:
    """Per-expert logical rank: kmax less the trailing slices whose bits
    are all zero (bits, not values: a ``-0.0`` in a live row is never
    mistaken for padding)."""
    bits = store if store.dtype.kind in "ui" else store.view(
        f"u{store.dtype.itemsize}")
    kmax = store.shape[axis]
    ranks = []
    for e in range(store.shape[0]):
        sub = np.moveaxis(bits[e], axis, 0)
        r = kmax
        while r > 0 and not sub[r - 1].any():
            r -= 1
        ranks.append(r)
    return ranks


class CheckpointManager:
    def __init__(self, directory: str, *, keep: int = 3,
                 async_save: bool = True):
        self.directory = directory
        self.keep = keep
        os.makedirs(directory, exist_ok=True)
        self._queue: "queue.Queue" = queue.Queue(maxsize=1)
        self._worker: Optional[threading.Thread] = None
        self._async = async_save
        self._restored_step: Optional[int] = None
        if async_save:
            self._worker = threading.Thread(target=self._drain, daemon=True)
            self._worker.start()

    # ------------------------------------------------------------------ save
    def save(self, step: int, state: PyTree, *, blocking: bool = False,
             meta: Optional[Dict[str, Any]] = None,
             reslice_banks: bool = False):
        """Copy every leaf to the host, then persist (in the background
        unless ``blocking`` or the manager is synchronous).  ``meta`` is
        stored verbatim in the manifest (``restore_tree`` returns it);
        ``reslice_banks`` writes per-expert factor banks cut to their
        logical ranks instead of the padded buffers."""
        host = [(name, *_to_host(leaf))
                for name, leaf in _flatten_with_paths(state)]
        job = (step, host, dict(meta or {}), reslice_banks,
               _structure_desc(state))
        if self._async and not blocking:
            self._queue.put(job)  # waits only while a save is in flight
        else:
            self._write(*job)

    def wait(self):
        self._queue.join()

    def _drain(self):
        while True:
            job = self._queue.get()
            try:
                self._write(*job)
            finally:
                self._queue.task_done()

    def _write(self, step: int, host, meta: Optional[Dict[str, Any]] = None,
               reslice_banks: bool = False, structure: Any = None):
        tmp = os.path.join(self.directory, f"step_{step:09d}.tmp")
        final = os.path.join(self.directory, f"step_{step:09d}")
        if os.path.exists(tmp):
            shutil.rmtree(tmp)
        os.makedirs(tmp)
        manifest = {"step": step, "created": time.time(),
                    "format": MANIFEST_FORMAT, "meta": meta or {},
                    "structure": structure, "leaves": []}
        for i, (name, store, logical) in enumerate(host):
            axis = _bank_rank_axis(name, store)
            entry: Dict[str, Any] = {"name": name,
                                     "shape": list(store.shape)}
            if axis is not None:
                entry["rank_per_expert"] = _logical_ranks(store, axis)
            entry["dtype"] = logical
            if axis is not None and reslice_banks:
                entry["bank_axis"] = axis
                entry["files"] = []
                for e, r in enumerate(entry["rank_per_expert"]):
                    sub = np.take(store[e], np.arange(r), axis=axis)
                    fname = f"leaf_{i:05d}_e{e:03d}.npy"
                    self._fsync_save(os.path.join(tmp, fname),
                                     np.ascontiguousarray(sub))
                    entry["files"].append(fname)
            else:
                fname = f"leaf_{i:05d}.npy"
                self._fsync_save(os.path.join(tmp, fname), store)
                entry["file"] = fname
            manifest["leaves"].append(entry)
        with open(os.path.join(tmp, "manifest.json"), "w") as f:
            json.dump(manifest, f)
            f.flush()
            os.fsync(f.fileno())
        if os.path.exists(final):
            shutil.rmtree(final)
        os.rename(tmp, final)
        self._gc()

    @staticmethod
    def _fsync_save(path: str, arr: np.ndarray):
        with open(path, "wb") as f:
            np.save(f, arr)
            f.flush()
            os.fsync(f.fileno())

    def _gc(self):
        steps = self.all_steps()
        protect = {self._restored_step}
        for s in steps[: max(0, len(steps) - self.keep)]:
            if s in protect:
                continue
            shutil.rmtree(os.path.join(self.directory, f"step_{s:09d}"),
                          ignore_errors=True)

    # --------------------------------------------------------------- restore
    def all_steps(self) -> List[int]:
        steps = []
        for name in os.listdir(self.directory):
            if name.startswith("step_") and not name.endswith(".tmp"):
                if os.path.exists(os.path.join(self.directory, name,
                                               "manifest.json")):
                    steps.append(int(name.split("_")[1]))
        return sorted(steps)

    def latest_step(self) -> Optional[int]:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def _step(self, step: Optional[int]) -> int:
        if step is None:
            step = self.latest_step()
        if step is None:
            raise FileNotFoundError(f"no checkpoints in {self.directory}")
        return step

    def manifest(self, step: Optional[int] = None) -> Dict[str, Any]:
        d = os.path.join(self.directory, f"step_{self._step(step):09d}")
        with open(os.path.join(d, "manifest.json")) as f:
            return json.load(f)

    def _load_entry(self, d: str, entry: Dict[str, Any],
                    device) -> torch.Tensor:
        if "files" in entry:  # re-sliced bank: pad the tails with +0.0
            out = None
            axis = entry["bank_axis"]
            for e, fname in enumerate(entry["files"]):
                sub = np.load(os.path.join(d, fname))
                if out is None:
                    out = np.zeros(entry["shape"], dtype=sub.dtype)
                idx: List[Any] = [slice(None)] * out[e].ndim
                idx[axis] = slice(0, sub.shape[axis])
                out[e][tuple(idx)] = sub
            return _to_tensor(out, entry["dtype"], device)
        return _to_tensor(np.load(os.path.join(d, entry["file"])),
                          entry["dtype"], device)

    def restore(self, step: Optional[int], like: PyTree, *,
                device=None) -> Tuple[int, PyTree]:
        """Restore into the structure of ``like`` (its leaves name the
        entries to read; their values are not used), on ``device``."""
        step = self._step(step)
        dev = resolve_device(device)
        d = os.path.join(self.directory, f"step_{step:09d}")
        by_name = {e["name"]: e for e in self.manifest(step)["leaves"]}

        def fill(node, prefix):
            if node is None:
                return None
            if isinstance(node, dict):
                return {k: fill(v, prefix + (str(k),))
                        for k, v in node.items()}
            if isinstance(node, (list, tuple)):
                items = [fill(v, prefix + (key,))
                         for key, v in zip(_seq_keys(node), node)]
                return (type(node)(*items) if hasattr(node, "_fields")
                        else type(node)(items))
            return self._load_entry(d, by_name["/".join(prefix)], dev)

        tree = fill(like, ())
        self._restored_step = step
        return step, tree

    def restore_tree(self, step: Optional[int] = None, *, device=None
                     ) -> Tuple[int, PyTree, Dict[str, Any]]:
        """Rebuild the saved tree from the manifest alone, on ``device``:
        its ``structure`` descriptor gives the containers (leafless slots
        included); a manifest without one falls back to nesting by path
        (``[i]`` segments become list entries).  Returns
        ``(step, tree, meta)``: the entry point for serving a checkpoint
        another process wrote."""
        step = self._step(step)
        dev = resolve_device(device)
        d = os.path.join(self.directory, f"step_{step:09d}")
        manifest = self.manifest(step)
        nested: Dict[str, Any] = {}
        for entry in manifest["leaves"]:
            parts = entry["name"].split("/")
            node = nested
            for p in parts[:-1]:
                node = node.setdefault(p, {})
            node[parts[-1]] = self._load_entry(d, entry, dev)

        structure = manifest.get("structure")
        if structure is not None:
            tree = _build_from_desc(structure, nested)
        else:
            def materialize(node):
                if not isinstance(node, dict):
                    return node
                if node and all(k.startswith("[") and k.endswith("]")
                                for k in node):
                    order = sorted(node, key=lambda k: int(k[1:-1]))
                    return [materialize(node[k]) for k in order]
                return {k: materialize(v) for k, v in node.items()}

            tree = materialize(nested)
        self._restored_step = step
        return step, tree, manifest.get("meta", {})
