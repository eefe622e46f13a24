"""Fault-tolerant checkpointing: atomic .npz + JSON manifest.

Counterpart of ``repro/checkpoint/ckpt.py``, with its design and its
on-disk layout, so a checkpoint either package writes the other restores:

- Layout: ``step_%010d/`` holds ``arrays_proc0.npz`` (one array a leaf)
  and ``manifest.json`` (``step``, ``time``, ``leaves`` {name: {shape,
  dtype}} and ``meta``).  Leaf names are the reference's: the path of
  the leaf in the tree, its parts joined by ``/``, a dict key as itself,
  a list or tuple index as its number, a NamedTuple field as ``.field``;
  dict keys are visited in sorted order and None leaves are left out.
- Atomicity: write into ``step_X.tmp/``, fsync the arrays, the manifest,
  the directory and the parent, then ``rename`` — a crash mid-save never
  corrupts the latest restorable state.  Overwriting a step renames the
  old directory aside first.
- Retention: keep-last-N GC; ``latest_step`` scans for the newest complete
  manifest, skipping torn ``.tmp`` dirs (crash-consistent resume).
- Async: ``CheckpointManager(async_save=True)`` copies the tree to host
  memory, then writes in a background thread, so the step is not blocked
  on disk; a failed background write re-raises from ``wait()`` or from
  the next ``save()``.

Leaves are torch tensors (on any device) or numpy arrays.  A bfloat16
leaf is stored as its 16-bit pattern (numpy has no bfloat16 without
``ml_dtypes``), with ``"bfloat16"`` in the manifest; restore views the
bits back.  ``restore_tree`` puts each leaf on the device and in the dtype
of the template's leaf.
"""

from __future__ import annotations

import json
import os
import re
import shutil
import threading
import time
from typing import Any, Dict, Optional

import numpy as np
import torch

Tree = Any

_SEP = "/"

# a pages_staging_* dir older than this is dead-process wreckage; younger
# ones may belong to a live trainer sharing the checkpoint directory
# (staging is written synchronously and renamed away within one save)
_STAGING_STALE_S = 3600.0


def map_with_names(fn, tree, path=()):
    """``tree`` with each leaf replaced by ``fn(name, leaf)``, in the
    reference's naming and order (None stays None)."""
    if tree is None:
        return None
    if isinstance(tree, dict):
        return {k: map_with_names(fn, tree[k], path + (str(k),))
                for k in sorted(tree)}
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(map_with_names(fn, getattr(tree, f),
                                            path + ("." + f,))
                            for f in tree._fields))
    if isinstance(tree, (list, tuple)):
        return type(tree)(map_with_names(fn, v, path + (str(i),))
                          for i, v in enumerate(tree))
    return fn(_SEP.join(path), tree)


def _flatten_with_names(tree: Tree) -> Dict[str, Any]:
    out: Dict[str, Any] = {}

    def keep(name, leaf):
        out[name] = leaf
        return leaf

    map_with_names(keep, tree)
    return out


def copy_tree_(dst: Tree, src: Tree) -> None:
    """Copy every leaf of ``src`` into the leaf of ``dst`` with the same
    name, in place (the trainers resume into their live tensors, whose
    addresses the kernels' tables keep)."""
    new = _flatten_with_names(src)
    for name, t in _flatten_with_names(dst).items():
        t.copy_(new[name])


def _to_host(leaf) -> np.ndarray:
    """A leaf as a numpy array that owns its memory (a copy: the trainers
    update their tensors in place); bfloat16 as its uint16 bits."""
    if torch.is_tensor(leaf):
        t = leaf.detach()
        if t.dtype == torch.bfloat16:
            t = t.view(torch.int16)
            return t.to("cpu", copy=True).numpy().view(np.uint16)
        return t.to("cpu", copy=True).numpy()
    return np.array(leaf, copy=True)


def _dtype_name(leaf, arr: np.ndarray) -> str:
    if torch.is_tensor(leaf) and leaf.dtype == torch.bfloat16:
        return "bfloat16"
    return str(arr.dtype)


def _fsync_path(path: str):
    """fsync a file or directory by path (directory fsync persists the
    entry names — the other half of the rename-atomicity recipe)."""
    fd = os.open(path, os.O_RDONLY)
    try:
        os.fsync(fd)
    finally:
        os.close(fd)


def _host_tree(tree: Tree):
    """(names -> host arrays, names -> manifest dtypes)."""
    named = _flatten_with_names(tree)
    arrays = {k: _to_host(v) for k, v in named.items()}
    dtypes = {k: _dtype_name(named[k], a) for k, a in arrays.items()}
    return arrays, dtypes


def save_tree(directory: str, step: int, tree: Tree,
              meta: Optional[Dict] = None,
              extras_dir: Optional[str] = None):
    """Atomically persist ``tree`` for ``step``. Returns the final dir.

    Crash-atomicity recipe: write arrays + manifest into ``step_X.tmp/``,
    fsync BOTH files and the tmp directory, then rename into place and
    fsync the parent.  Overwriting an existing ``step_X`` renames it aside
    (``step_X.old`` — invisible to ``latest_step``) instead of rmtree'ing
    it first, so a kill between the two renames still leaves every earlier
    checkpoint complete and restorable; the aside copy is deleted only
    after the replacement is in place.

    ``extras_dir``: a fully-written staging directory (the DiskStore's page
    snapshot) MOVED into ``step_X.tmp/pages`` by rename — it rides the same
    whole-directory atomicity as the arrays.
    """
    return _write_host(directory, step, _host_tree(tree), meta, extras_dir)


def _write_host(directory: str, step: int, host, meta, extras_dir):
    """``save_tree`` of a tree already copied to the host (``_host_tree``:
    its arrays and their manifest dtypes)."""
    os.makedirs(directory, exist_ok=True)
    final = os.path.join(directory, f"step_{step:010d}")
    tmp, aside = final + ".tmp", final + ".old"
    for stale in (tmp, aside):   # leftovers of a previously crashed save
        if os.path.exists(stale):
            shutil.rmtree(stale)
    os.makedirs(tmp)
    if extras_dir is not None:
        os.rename(extras_dir, os.path.join(tmp, "pages"))
    arrays, dtypes = host
    arrays_path = os.path.join(tmp, "arrays_proc0.npz")
    np.savez(arrays_path, **arrays)
    _fsync_path(arrays_path)   # array data durable BEFORE the manifest
    manifest = {
        "step": int(step),
        "time": time.time(),
        "leaves": {k: {"shape": list(a.shape), "dtype": dtypes[k]}
                   for k, a in arrays.items()},
        "meta": meta or {},
    }
    with open(os.path.join(tmp, "manifest.json"), "w") as f:
        json.dump(manifest, f)
        f.flush()
        os.fsync(f.fileno())
    _fsync_path(tmp)           # both directory entries durable
    if os.path.exists(final):
        os.rename(final, aside)
    os.rename(tmp, final)
    _fsync_path(directory)     # the renames durable
    if os.path.exists(aside):
        shutil.rmtree(aside)
    return final


def latest_step(directory: str) -> Optional[int]:
    if not os.path.isdir(directory):
        return None
    best = None
    for name in os.listdir(directory):
        m = re.fullmatch(r"step_(\d+)", name)
        if m and os.path.exists(os.path.join(directory, name, "manifest.json")):
            s = int(m.group(1))
            best = s if best is None else max(best, s)
    return best


def read_manifest(directory: str, step: int) -> Optional[Dict]:
    """The manifest of one checkpoint (leaves + meta), or None if absent."""
    path = os.path.join(directory, f"step_{step:010d}", "manifest.json")
    if not os.path.exists(path):
        return None
    with open(path) as f:
        return json.load(f)


def _leaf_like(arr: np.ndarray, saved_dtype: str, ref):
    """A stored array in the template leaf's kind, dtype and device."""
    if saved_dtype == "bfloat16":
        bits = torch.from_numpy(np.ascontiguousarray(arr).view(np.int16))
        t = bits.view(torch.bfloat16)
    else:
        t = torch.from_numpy(np.array(arr, copy=True))
    if torch.is_tensor(ref):
        return t.to(device=ref.device, dtype=ref.dtype)
    out = t.to(torch.float32) if t.dtype == torch.bfloat16 else t
    return out.numpy().astype(np.asarray(ref).dtype)


def restore_tree(directory: str, step: int, like: Tree) -> Tree:
    """Restore into the structure of ``like``: each leaf in the template
    leaf's dtype and on its device (tensors), or a numpy array (numpy
    leaves); raises on a shape mismatch."""
    path = os.path.join(directory, f"step_{step:010d}")
    man = read_manifest(directory, step) or {"leaves": {}}
    with np.load(os.path.join(path, "arrays_proc0.npz")) as data:
        def load(name, ref):
            arr = data[name]
            shape = tuple(ref.shape)
            if tuple(arr.shape) != shape:
                raise ValueError(f"shape mismatch for {name}: ckpt "
                                 f"{arr.shape} vs model {shape}")
            saved = man["leaves"].get(name, {}).get("dtype", str(arr.dtype))
            return _leaf_like(arr, saved, ref)

        return map_with_names(load, like)


class CheckpointManager:
    """Save cadence + retention + optional async writes."""

    def __init__(
        self,
        directory: str,
        keep_last: int = 3,
        save_every: int = 100,
        async_save: bool = False,
        spill_dir: Optional[str] = None,
    ):
        self.directory = directory
        self.keep_last = keep_last
        self.save_every = save_every
        self.async_save = async_save
        # a DiskStore spill directory to sweep for write-behind wreckage
        # (*.tmp page files) alongside checkpoint GC — see _gc
        self.spill_dir = spill_dir
        self._thread: Optional[threading.Thread] = None
        # _exc crosses the writer-thread/main boundary; _lock guards it
        self._lock = threading.Lock()
        self._exc: Optional[BaseException] = None
        os.makedirs(directory, exist_ok=True)
        # crash recovery for page-snapshot staging dirs, HERE and not in
        # _gc: THIS manager has no writer running at construction, so a
        # staging dir it sees is not its own (_gc runs on the writer
        # thread while the trainer may already stage the NEXT snapshot).
        # Age-gated: the directory may be shared with another live process,
        # and a trainer's staging dir lives seconds.
        now = time.time()
        for name in os.listdir(directory):
            if not re.fullmatch(r"pages_staging_\d+", name):
                continue
            path = os.path.join(directory, name)
            try:
                age = now - os.path.getmtime(path)
            except OSError:
                continue   # vanished under us: someone else is live here
            if age > _STAGING_STALE_S:
                shutil.rmtree(path, ignore_errors=True)

    def should_save(self, step: int) -> bool:
        return step > 0 and step % self.save_every == 0

    def _write(self, step: int, host, meta, extras_dir=None):
        _write_host(self.directory, step, host, meta, extras_dir)
        self._gc()

    def _write_async(self, step: int, host, meta, extras_dir=None):
        # A failed background save must not be silent: capture the
        # exception so wait() / the next save() re-raises it on the caller.
        try:
            self._write(step, host, meta, extras_dir=extras_dir)
        except BaseException as e:   # noqa: BLE001 — re-raised from wait()
            with self._lock:
                self._exc = e

    def save(self, step: int, tree: Tree, meta: Optional[Dict] = None,
             block: bool = False, extras_dir: Optional[str] = None):
        # Snapshot to host memory first, so the trainer may update its
        # tensors in place right after.  extras_dir must likewise already
        # be a complete host-side snapshot (the trainer writes it
        # synchronously) — the async thread only renames it in.
        host = _host_tree(tree)
        # drain the in-flight background writer first — EVERY path: a
        # blocking save must not race the previous async one, and a pending
        # failure is raised here instead of being deferred
        self.wait()
        if self.async_save and not block:
            self._thread = threading.Thread(
                target=self._write_async, args=(step, host, meta, extras_dir),
                daemon=True,
            )
            self._thread.start()
        else:
            self._write(step, host, meta, extras_dir=extras_dir)

    def wait(self):
        """Block until the in-flight background save lands; re-raise its
        failure (once) — a crashed writer never fails silently."""
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        with self._lock:
            exc, self._exc = self._exc, None
        if exc is not None:
            raise exc

    def _gc(self):
        names = os.listdir(self.directory)
        steps = sorted(
            int(m.group(1))
            for name in names
            if (m := re.fullmatch(r"step_(\d+)", name))
        )
        for s in steps[: -self.keep_last] if self.keep_last > 0 else []:
            shutil.rmtree(os.path.join(self.directory, f"step_{s:010d}"),
                          ignore_errors=True)
        # wreckage of crashed/failed saves: this manager's writes are
        # serialized (save() drains the writer first), so any .tmp/.old
        # dir still present when _gc runs is dead.  pages_staging_* dirs
        # are swept at construction only (see __init__).
        for name in names:
            if re.fullmatch(r"step_\d+\.(tmp|old)", name):
                shutil.rmtree(os.path.join(self.directory, name),
                              ignore_errors=True)
        if self.spill_dir and os.path.isdir(self.spill_dir):
            # DiskStore write-behind wreckage: a kill mid page write leaves
            # <page>.tmp next to the (still complete) old page
            for dirpath, _, files in os.walk(self.spill_dir):
                for fn in files:
                    if fn.endswith(".tmp"):
                        try:
                            os.remove(os.path.join(dirpath, fn))
                        except OSError:
                            pass

    def restore_latest(self, like: Tree):
        s = latest_step(self.directory)
        if s is None:
            return None, None
        return s, restore_tree(self.directory, s, like)
