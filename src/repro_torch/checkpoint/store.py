"""Atomic, asynchronous, ring-agnostic checkpoints.

Counterpart of ``repro/checkpoint/store.py``, with its directory layout
and file names, so a checkpoint written by either package restores in
the other::

    <dir>/step_00000123/
        manifest.json        # step, time, extra, leaf files/shapes/dtypes
        <leaf-path>.npy      # one file per leaf (host arrays)
    <dir>/LATEST             # pointer file, replaced by rename

* **Names**: :func:`leaf_files` gives every leaf of a tree of dicts,
  named tuples, tuples, tensors and ints the name the reference's
  ``_leaf_files`` gives the matching JAX pytree (``.params_embed_tok``,
  ``.opt_.mu``, ``.opt_.count``, ``.step``, ``.ef_0``...).
* **Atomicity**: a step is written into ``step_X.tmp-<pid>`` and renamed
  into place; ``LATEST`` is replaced by rename too. A crash mid-save
  leaves the previous checkpoint whole.
* **Async**: ``save_async`` copies every leaf to the host before it
  returns (a blocking ``.cpu()``), so the caller may change the state in
  place at once; only the file writes run on a thread. ``wait()`` joins
  it and raises what the write raised.
* **Rings**: the reference saves the global state, in which the
  ring-sharded leaves (ZeRO-1 flat moments, error feedback) carry a
  leading ring dim. Here each process holds its own row of those leaves,
  named by the ``rows`` predicate. On save they are all-gathered over
  ``group`` into the reference's ``(ring, ...)`` layout, rank 0 writes,
  and a barrier keeps every peer from reading ``LATEST`` before the
  write has landed. On restore every peer reads the global array,
  resolves a changed ring size through ``on_mismatch`` (elastic
  restore, ``launch/elastic.py``) and keeps its own row.
* **Meshes**: a DTensor leaf (the gspmd step's params and moments over a
  ``DeviceMesh``) is written in the reference's global layout, its
  ``full_tensor()``, under the same file name and with the same bytes.
  ``restore(..., shardings=)`` places each leaf at its
  ``launch/sharding.Sharding`` on the mesh it names: every peer reads
  only its own block of the file. A gspmd checkpoint is therefore
  mesh-agnostic, as the reference's is: saved on one mesh, it restores
  on another or on one peer.
* **bf16**: the reference's ``np.save`` of an ml_dtypes ``bfloat16``
  array writes raw 2-byte records (descr ``<V2``), manifest dtype
  ``bfloat16``. The port writes the same bytes from the int16 bit
  pattern and reads such records back as bf16 bit patterns, with no
  ``ml_dtypes`` import. (The reference cannot read them back: its
  ``astype(bfloat16)`` of the ``|V2`` array ``np.load`` returns raises.)
"""
from __future__ import annotations

import json
import os
import re
import shutil
import threading
import time
from typing import Any, Callable, Optional

import numpy as np
import torch
import torch.distributed as dist
from torch.distributed.tensor import DTensor

from repro_torch.compat import DeviceLike, resolve_device
from repro_torch.launch.sharding import block_slices

Tree = Any

_SAFE = re.compile(r"[^A-Za-z0-9_.-]")


def _flatten(tree: Tree, path: tuple = ()) -> list:
    """(key path, leaf) pairs in the order ``jax.tree`` flattens the
    matching pytree: dict keys sorted, named-tuple fields as ``.name``,
    sequence items by index; ``None`` holds no leaf."""
    if tree is None:
        return []
    if isinstance(tree, dict):
        return [x for k in sorted(tree)
                for x in _flatten(tree[k], path + (str(k),))]
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return [x for f in tree._fields
                for x in _flatten(getattr(tree, f), path + ("." + f,))]
    if isinstance(tree, (tuple, list)):
        return [x for i, v in enumerate(tree)
                for x in _flatten(v, path + (str(i),))]
    return [(path, tree)]


def _rebuild(like: Tree, leaves) -> Tree:
    """Inverse of :func:`_flatten`: ``like``'s structure, its leaves taken
    in order from the iterator ``leaves``."""
    if like is None:
        return None
    if isinstance(like, dict):
        return {k: _rebuild(like[k], leaves) for k in sorted(like)}
    if isinstance(like, tuple) and hasattr(like, "_fields"):
        return type(like)(*(_rebuild(getattr(like, f), leaves)
                            for f in like._fields))
    if isinstance(like, (tuple, list)):
        return type(like)(_rebuild(v, leaves) for v in like)
    return next(leaves)


def leaf_files(tree: Tree) -> list:
    """(file name, leaf) pairs, named as the reference's ``_leaf_files``
    names the matching JAX pytree."""
    return [(("_".join(_SAFE.sub("-", k) for k in path) or "leaf")
             + ".npy", leaf) for path, leaf in _flatten(tree)]


def _to_host(leaf) -> tuple:
    """(numpy array, manifest dtype) of one leaf, copied to the host
    before this returns (a copy even of a host tensor, which ``.cpu()``
    would return as it is). bf16 travels as its int16 bit pattern; a
    Python int (a step or Adam count) as the reference's 0-d int32."""
    if torch.is_tensor(leaf):
        t = leaf.detach().to("cpu", copy=True).contiguous()
        if t.dtype == torch.bfloat16:
            return t.view(torch.int16).numpy(), "bfloat16"
        a = t.numpy()
    elif isinstance(leaf, int) and not isinstance(leaf, bool):
        a = np.asarray(leaf, np.int32)
    else:
        a = np.array(leaf)
    return a, str(a.dtype)


def _save_npy(path: str, arr: np.ndarray, dtype: str) -> None:
    if dtype != "bfloat16":
        np.save(path, arr, allow_pickle=False)
        return
    # the header np.save writes for an ml_dtypes bfloat16 array
    with open(path, "wb") as f:
        np.lib.format.write_array_header_1_0(
            f, {"descr": "<V2", "fortran_order": False,
                "shape": arr.shape})
        f.write(np.ascontiguousarray(arr).data)


def _from_host(arr: np.ndarray, dtype: str) -> torch.Tensor:
    if dtype == "bfloat16" and arr.dtype.kind == "V" \
            and arr.dtype.itemsize == 2:
        return torch.from_numpy(np.array(arr).view(np.int16)).view(
            torch.bfloat16)
    return torch.from_numpy(np.array(arr))


class CheckpointStore:
    """Checkpoints under ``directory``, the last ``keep`` kept. ``group``
    is the ring's process group (None: this process alone); ``rows``
    names the leaves (by file name) that each peer holds one row of."""

    def __init__(self, directory: str, keep: int = 3, *, group=None,
                 rows: Optional[Callable[[str], bool]] = None):
        self.dir = directory
        self.keep = keep
        self.group = group
        self.rows = rows or (lambda name: False)
        self.rank = 0 if group is None else dist.get_rank(group)
        self.world = 1 if group is None else dist.get_world_size(group)
        self._thread: Optional[threading.Thread] = None
        self._pending = False
        self._error: Optional[BaseException] = None
        os.makedirs(directory, exist_ok=True)

    # -- paths ---------------------------------------------------------

    def step_dir(self, step: int) -> str:
        return os.path.join(self.dir, f"step_{step:08d}")

    def latest_step(self) -> Optional[int]:
        p = os.path.join(self.dir, "LATEST")
        if not os.path.exists(p):
            return None
        with open(p) as f:
            s = f.read().strip()
        return int(s) if s else None

    def available_steps(self) -> list:
        out = []
        for d in os.listdir(self.dir):
            m = re.fullmatch(r"step_(\d+)", d)
            if m and os.path.exists(os.path.join(self.dir, d,
                                                 "manifest.json")):
                out.append(int(m.group(1)))
        return sorted(out)

    # -- save ----------------------------------------------------------

    def _snapshot(self, tree: Tree) -> list:
        """Gather the ring rows, then copy every leaf to the host (on
        the writing peer only): [(file, array, manifest dtype)]."""
        host = []
        for name, leaf in leaf_files(tree):
            if isinstance(leaf, DTensor):       # every peer gathers
                leaf = leaf.full_tensor()
            elif self.rows(name):
                leaf = self._gather(leaf)
            if self.rank == 0:
                host.append((name, *_to_host(leaf)))
            del leaf
        return host

    def _gather(self, row: torch.Tensor) -> torch.Tensor:
        """This peer's row -> the ``(ring, ...)`` stack of every peer's."""
        if self.group is None:
            return row.unsqueeze(0)
        out = row.new_empty(self.world * row.numel())
        dist.all_gather_into_tensor(out, row.reshape(-1), group=self.group)
        return out.view(self.world, *row.shape)

    def save(self, step: int, tree: Tree, extra: Optional[dict] = None):
        """Blocking save: snapshot, write, then a barrier over the ring."""
        self.wait()
        host = self._snapshot(tree)
        if self.rank == 0:
            self._write(step, host, extra or {})
        self._barrier()

    def save_async(self, step: int, tree: Tree,
                   extra: Optional[dict] = None):
        """Snapshot now (every leaf on the host before this returns);
        the file writes run on a thread until :meth:`wait`."""
        self.wait()
        host = self._snapshot(tree)
        self._pending = True
        if self.rank == 0:
            self._thread = threading.Thread(
                target=self._write_catching, args=(step, host, extra or {}),
                daemon=True)
            self._thread.start()

    def wait(self):
        """Join a pending asynchronous save; every peer then meets at a
        barrier. Raises what the write raised."""
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._pending:
            self._pending = False
            self._barrier()
        err, self._error = self._error, None
        if err is not None:
            raise err

    def _barrier(self):
        if self.world > 1:
            dist.barrier(group=self.group)

    def _write_catching(self, step: int, host: list, extra: dict):
        try:
            self._write(step, host, extra)
        except BaseException as e:      # re-raised by wait()
            self._error = e

    def _write(self, step: int, host: list, extra: dict):
        final = self.step_dir(step)
        tmp = f"{final}.tmp-{os.getpid()}"
        os.makedirs(tmp, exist_ok=True)
        manifest = {"step": step, "time": time.time(), "extra": extra,
                    "leaves": []}
        for name, arr, dtype in host:
            _save_npy(os.path.join(tmp, name), arr, dtype)
            manifest["leaves"].append(
                {"file": name, "shape": list(arr.shape), "dtype": dtype})
        with open(os.path.join(tmp, "manifest.json"), "w") as f:
            json.dump(manifest, f)
        if os.path.exists(final):
            shutil.rmtree(final)
        os.rename(tmp, final)
        lp = os.path.join(self.dir, "LATEST")
        with open(lp + ".tmp", "w") as f:
            f.write(str(step))
        os.rename(lp + ".tmp", lp)
        self._gc()

    def _gc(self):
        steps = self.available_steps()
        for s in steps[: max(0, len(steps) - self.keep)]:
            shutil.rmtree(self.step_dir(s), ignore_errors=True)

    # -- restore -------------------------------------------------------

    def restore(self, step: int, like: Tree, on_mismatch=None, *,
                device: DeviceLike = None,
                shardings: Optional[Tree] = None) -> Tree:
        """Restore into the structure of ``like`` (tensors, ``meta``
        tensors or ints) on ``device`` (the card unless "cpu"), each
        leaf cast to ``like``'s dtype. A ring-row leaf's global array is
        ``(ring, *like.shape)``; when its shape differs (another ring
        size, or another layout), ``on_mismatch(name, arr, ref) -> arr``
        resolves it against ``ref``, a ``meta`` tensor of the wanted
        global shape (``launch/elastic.make_on_mismatch``); then this
        peer keeps its own row. ``shardings``: a tree like ``like`` of
        ``launch/sharding.Sharding`` leaves; a tensor leaf with one comes
        back a DTensor at it (this peer's block of the global array)."""
        dev = resolve_device(device)
        d = self.step_dir(step)
        with open(os.path.join(d, "manifest.json")) as f:
            manifest = json.load(f)
        files = {leaf["file"]: leaf for leaf in manifest["leaves"]}
        names = leaf_files(like)
        shs = ([None] * len(names) if shardings is None
               else [sh for _, sh in _flatten(shardings)])
        if len(shs) != len(names):
            raise ValueError(f"{len(shs)} shardings for {len(names)} "
                             "leaves")
        out = []
        for (name, ref), sh in zip(names, shs):
            if name not in files:
                raise KeyError(f"checkpoint missing leaf {name}")
            arr = np.load(os.path.join(d, name), mmap_mode="r",
                          allow_pickle=False)
            if not torch.is_tensor(ref):          # a step or a count
                out.append(type(ref)(arr))
                continue
            row = self.rows(name)
            want = ((self.world,) if row else ()) + tuple(ref.shape)
            if tuple(arr.shape) != want:
                if on_mismatch is None:
                    raise ValueError(f"{name}: checkpoint shape "
                                     f"{arr.shape} != {want}")
                arr = on_mismatch(name, arr, torch.empty(
                    want, dtype=ref.dtype, device="meta"))
                if tuple(arr.shape) != want:
                    raise ValueError(f"{name}: resolved to {arr.shape}, "
                                     f"expected {want}")
            if row:
                arr = arr[self.rank]
            if sh is not None:
                pls = sh.placements
                arr = arr[block_slices(arr.shape, sh.mesh, pls)]
            t = _from_host(arr, files[name]["dtype"]).to(dev)
            t = t if t.dtype == ref.dtype else t.to(ref.dtype)
            if sh is not None:
                t = DTensor.from_local(t, sh.mesh, pls, run_check=False)
            out.append(t)
            del arr
        return _rebuild(like, iter(out))

    def manifest(self, step: int) -> dict:
        with open(os.path.join(self.step_dir(step), "manifest.json")) as f:
            return json.load(f)
