"""Checkpoints of a train state: atomic, asynchronous, with the data
pipeline's state (port of ``repro.training.checkpoint``, one card).

Layout on disk, the JAX package's:
    <dir>/step_<N>/manifest.json     leaf paths, shapes, dtypes, mesh,
                                     data-pipeline state, step
    <dir>/step_<N>/arrays.npz        one entry per leaf (key = leaf path)

The contract:
  * atomic: written to ``step_<N>.tmp``, fsync'd, then renamed, so a crash
    mid-save never leaves a checkpoint that ``latest_step`` names;
  * async: ``save_async`` copies the state to host memory, then writes it
    in a thread while the card keeps stepping; ``wait_for_saves`` joins;
  * the data pipeline's state rides along, so a restart resumes the stream
    exactly (no repeated or skipped batches).

numpy has no bfloat16: a bf16 leaf is stored as its 16-bit pattern (int16)
with ``"bfloat16"`` in the manifest, and restored bit for bit. ``restore``
places leaves on one device; the JAX package's elastic restore onto
another mesh comes with the distribution slice (ROADMAP.md, queue 1,
slice 11).
"""
from __future__ import annotations

import json
import os
import shutil
import threading
import time

import numpy as np
import torch

from repro_torch.device import require_device
from repro_torch.training.tree import tree_leaves_with_path, tree_map

BF16 = "bfloat16"


def _leaf_paths(tree) -> tuple[list[str], list]:
    items = tree_leaves_with_path(tree)
    return ["/".join(str(k) for k in path) for path, _ in items], \
        [leaf for _, leaf in items]


def _host(leaf) -> tuple[np.ndarray, str]:
    """A leaf as a numpy array to store, and the dtype to restore."""
    t = torch.as_tensor(leaf).detach().cpu()
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy(), BF16
    a = t.numpy()
    return a, str(a.dtype)


def _fsync(path: str) -> None:
    fd = os.open(path, os.O_RDONLY)
    try:
        os.fsync(fd)
    finally:
        os.close(fd)


def save(state, ckpt_dir: str, step: int, data_state: dict | None = None,
         mesh_shape=None) -> str:
    """Write ``state`` (a tree of tensors) as ``step_<step>``; -> its path."""
    keys, leaves = _leaf_paths(state)
    final = os.path.join(ckpt_dir, f"step_{step:08d}")
    tmp = final + ".tmp"
    os.makedirs(tmp, exist_ok=True)
    arrays, dtypes = {}, {}
    for k, leaf in zip(keys, leaves):
        arrays[k], dtypes[k] = _host(leaf)
    npz = os.path.join(tmp, "arrays.npz")
    np.savez(npz, **arrays)
    _fsync(npz)
    manifest = {
        "step": step,
        "keys": keys,
        "shapes": {k: list(a.shape) for k, a in arrays.items()},
        "dtypes": dtypes,
        "mesh_shape": list(mesh_shape) if mesh_shape else None,
        "data_state": data_state or {},
        "time": time.time(),
    }
    with open(os.path.join(tmp, "manifest.json"), "w") as f:
        json.dump(manifest, f)
        f.flush()
        os.fsync(f.fileno())
    if os.path.exists(final):
        shutil.rmtree(final)
    os.rename(tmp, final)
    _fsync(ckpt_dir)
    return final


_SAVE_THREADS: list[threading.Thread] = []


def save_async(state, ckpt_dir: str, step: int, **kw) -> threading.Thread:
    """Snapshot to host synchronously, write in a background thread."""
    host = tree_map(lambda x: torch.as_tensor(x).detach().to(
        "cpu", copy=True), state)
    # daemon is safe: save() lands atomically (tmp dir + rename), so a
    # writer killed at interpreter exit leaves no partial checkpoint;
    # callers that need durability join via the handle / wait_for_saves()
    th = threading.Thread(target=save, args=(host, ckpt_dir, step),
                          kwargs=kw, name=f"ckpt-save-{step}", daemon=True)
    th.start()
    _SAVE_THREADS.append(th)
    return th


def wait_for_saves() -> None:
    for th in _SAVE_THREADS:
        th.join()
    _SAVE_THREADS.clear()


def latest_step(ckpt_dir: str) -> int | None:
    if not os.path.isdir(ckpt_dir):
        return None
    steps = [int(d.split("_")[1]) for d in os.listdir(ckpt_dir)
             if d.startswith("step_") and not d.endswith(".tmp")]
    return max(steps) if steps else None


def restore(ckpt_dir: str, step: int, template, *,
            device: str | torch.device = "cuda"):
    """-> (``template``'s tree with the saved leaves on ``device``, cast to
    the template's dtypes, manifest). Raises on a leaf of another shape."""
    dev = require_device(device)
    path = os.path.join(ckpt_dir, f"step_{step:08d}")
    with open(os.path.join(path, "manifest.json")) as f:
        manifest = json.load(f)
    it = iter(_leaf_paths(template)[0])

    def put(leaf):
        k = next(it)
        t = torch.from_numpy(arrays[k])
        if manifest["dtypes"][k] == BF16:
            t = t.view(torch.bfloat16)
        if tuple(t.shape) != tuple(leaf.shape):
            raise ValueError(f"shape mismatch for {k}: {tuple(t.shape)} vs "
                             f"{tuple(leaf.shape)}")
        return t.to(device=dev, dtype=leaf.dtype)

    with np.load(os.path.join(path, "arrays.npz")) as arrays:
        return tree_map(put, template), manifest
