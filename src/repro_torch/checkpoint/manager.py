"""Checkpointing with async writes (port of `repro.checkpoint.manager`),
in the reference's on-disk format.

Layout: one directory per step, ``step-%08d/``, holding ``leaf-<i>.npy``
per tree leaf (`repro_torch.tree` order, which is `jax.tree` order) and a
``manifest.json`` with the step and, per leaf, its ``name``, ``file``,
``shape`` and ``dtype``.  Leaves are whole logical arrays, so a run may
resume on another device.

bfloat16 needs no ``ml_dtypes``: a bf16 leaf is written as its 16-bit
patterns in a 2-byte void ``.npy`` with ``"dtype": "bfloat16"`` in the
manifest, which is the file numpy writes for an ``ml_dtypes`` bfloat16
array; on restore a void array takes the manifest's dtype back onto its
bits.  So the reference's `restore` reads the port's checkpoints and the
port reads the reference's.

Async: `save_async` snapshots to host memory synchronously and writes on a
worker thread, overlapping the I/O with the next steps; `wait` joins
before the next save or on exit.  Retention keeps the newest `keep`
checkpoints, and a ``latest`` symlink enables crash-restart discovery.
"""
from __future__ import annotations

import json
import os
import shutil
import threading

import numpy as np
import torch

from repro_torch import tree as T

# 2-byte torch dtypes numpy has no name for: stored as their bit patterns
_BITS = {torch.bfloat16: "bfloat16"}
_FROM_BITS = {v: k for k, v in _BITS.items()}


def _to_host(leaf):
    """(numpy array, manifest dtype name) of one leaf, bit for bit."""
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach().to("cpu", copy=True)  # a snapshot, even of a CPU tensor
        if t.dtype in _BITS:
            return t.view(torch.int16).numpy().view(np.dtype("V2")), _BITS[t.dtype]
        arr = t.numpy()
    else:
        arr = np.asarray(leaf)
    return arr, str(arr.dtype)


def _from_file(arr: np.ndarray, dtype: str) -> torch.Tensor:
    if arr.dtype.kind == "V":  # a 2-byte type numpy cannot name (bfloat16)
        return torch.from_numpy(arr.view(np.int16).copy()).view(_FROM_BITS[dtype])
    return torch.from_numpy(np.array(arr, copy=True))


def _snapshot(tree) -> list[tuple[str, np.ndarray, str]]:
    """(name, host array, dtype name) per leaf: a copy of the tree's values."""
    return [(name, *_to_host(leaf)) for name, leaf in T.leaves_with_names(tree)]


def save(path: str, tree, step: int) -> None:
    _write(path, _snapshot(tree), step)


def _write(path: str, entries, step: int) -> None:
    os.makedirs(path, exist_ok=True)
    manifest = {"step": step, "leaves": []}
    for i, (name, arr, dtype) in enumerate(entries):
        fn = f"leaf-{i}.npy"
        np.save(os.path.join(path, fn), arr)
        manifest["leaves"].append(
            {"name": name, "file": fn, "shape": list(arr.shape), "dtype": dtype})
    with open(os.path.join(path, "manifest.json"), "w") as f:
        json.dump(manifest, f)


def restore(path: str, target_tree):
    """Restore into the structure of `target_tree` (matching by leaf order);
    each leaf takes its target's dtype and device."""
    with open(os.path.join(path, "manifest.json")) as f:
        manifest = json.load(f)
    flat = T.leaves(target_tree)
    if len(flat) != len(manifest["leaves"]):
        raise ValueError(
            f"checkpoint has {len(manifest['leaves'])} leaves, target has {len(flat)}")
    out = []
    for leaf, meta in zip(flat, manifest["leaves"]):
        t = _from_file(np.load(os.path.join(path, meta["file"])), meta["dtype"])
        if tuple(t.shape) != tuple(leaf.shape):
            raise ValueError(f"leaf {meta['name']}: shape {tuple(t.shape)} != "
                             f"{tuple(leaf.shape)}")
        out.append(t.to(device=leaf.device, dtype=leaf.dtype))
    return T.unflatten(target_tree, out), manifest["step"]


class CheckpointManager:
    def __init__(self, root: str, keep: int = 3):
        self.root = root
        self.keep = keep
        self._thread: threading.Thread | None = None
        os.makedirs(root, exist_ok=True)

    def _step_dir(self, step: int) -> str:
        return os.path.join(self.root, f"step-{step:08d}")

    def save_async(self, tree, step: int) -> None:
        self.wait()
        # snapshot to host memory synchronously; write on a worker thread
        entries = _snapshot(tree)

        def work():
            tmp = self._step_dir(step) + ".tmp"
            _write(tmp, entries, step)
            final = self._step_dir(step)
            if os.path.exists(final):
                shutil.rmtree(final)
            os.rename(tmp, final)
            latest = os.path.join(self.root, "latest")
            if os.path.lexists(latest):
                os.remove(latest)
            os.symlink(os.path.basename(final), latest)
            self._gc()

        self._thread = threading.Thread(target=work, daemon=True)
        self._thread.start()

    def _gc(self):
        steps = sorted(
            d for d in os.listdir(self.root)
            if d.startswith("step-") and not d.endswith(".tmp")
        )
        for d in steps[: -self.keep]:
            shutil.rmtree(os.path.join(self.root, d), ignore_errors=True)

    def wait(self):
        if self._thread is not None:
            self._thread.join()
            self._thread = None

    def latest_dir(self) -> str | None:
        latest = os.path.join(self.root, "latest")
        if os.path.exists(latest):
            return os.path.realpath(latest)
        return None

    def restore_latest(self, target_tree):
        d = self.latest_dir()
        if d is None:
            return None, -1
        return restore(d, target_tree)
