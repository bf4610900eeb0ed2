"""Checkpoints of a train state: atomic, asynchronous, elastic, with the
data pipeline's state (port of ``repro.training.checkpoint``).

Layout on disk, the JAX package's:
    <dir>/step_<N>/manifest.json     leaf paths, shapes, dtypes, mesh,
                                     data-pipeline state, step
    <dir>/step_<N>/arrays.npz        one entry per leaf (key = leaf path)

The contract:
  * atomic: written to ``step_<N>.tmp``, fsync'd, then renamed, so a crash
    mid-save never leaves a checkpoint that ``latest_step`` names;
  * async: ``save_async`` copies the state to host memory, then writes it
    in a thread while the card keeps stepping; ``wait_for_saves`` joins;
  * elastic: leaves are saved as whole arrays, and ``restore(...,
    shardings=)`` places them under any target mesh: each leaf comes back
    as a ``DTensor`` of which this rank holds its own shard;
  * the data pipeline's state rides along, so a restart resumes the stream
    exactly (no repeated or skipped batches).

numpy has no bfloat16: a bf16 leaf is stored as its 16-bit pattern (int16)
with ``"bfloat16"`` in the manifest, and restored bit for bit.
"""
from __future__ import annotations

import json
import os
import shutil
import threading
import time

import numpy as np
import torch

from torch.distributed.tensor import DTensor, Shard

from repro_torch.device import require_device
from repro_torch.training.tree import (
    tree_leaves,
    tree_leaves_with_path,
    tree_map,
)

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


def _local_shard(t: torch.Tensor, mesh, placements) -> torch.Tensor:
    """This rank's block of the whole tensor ``t`` under ``placements``:
    each ``Shard(d)`` mesh dim cuts dim ``d`` into chunks of ceil(n/size)
    rows, as a ``DTensor`` lays them out."""
    coords = mesh.get_coordinate()
    for i, p in enumerate(placements):
        if isinstance(p, Shard):
            size, d = mesh.size(i), p.dim
            step = -(-t.shape[d] // size)
            t = t.narrow(d, min(coords[i] * step, t.shape[d]),
                         max(0, min(step, t.shape[d] - coords[i] * step)))
    return t


def _sharding(s):
    """A target sharding as (mesh, placements): a ``dist.hints.
    NamedSharding`` (what ``dist.ShardingRules`` gives) or the pair."""
    return (s.mesh, s.placements) if hasattr(s, "placements") else s


def restore(ckpt_dir: str, step: int, template, *,
            device: str | torch.device = "cuda", shardings=None):
    """-> (``template``'s tree with the saved leaves, cast to the
    template's dtypes, manifest). Raises on a leaf of another shape.

    Without ``shardings`` every leaf is placed whole on ``device``. With
    ``shardings``, one target for every leaf or a tree of them matching
    ``template`` (e.g. ``dist.ShardingRules(cfg, mesh).state_shardings``),
    each a ``NamedSharding`` or a ``(mesh, placements)`` pair, every leaf
    comes back as a ``DTensor`` on its mesh: this rank reads the whole leaf
    and moves only its own shard to ``device``."""
    dev = require_device(device)
    path = os.path.join(ckpt_dir, f"step_{step:08d}")
    with open(os.path.join(path, "manifest.json")) as f:
        manifest = json.load(f)
    keys, leaves = _leaf_paths(template)
    if shardings is None:
        targets = [None] * len(leaves)
    elif isinstance(shardings, (dict, list)):
        targets = [_sharding(s) for s in tree_leaves(shardings)]
    else:
        targets = [_sharding(shardings)] * len(leaves)
    if len(targets) != len(leaves):
        raise ValueError(f"{len(targets)} shardings for {len(leaves)} leaves")
    it = iter(zip(keys, targets))

    def put(leaf):
        k, target = next(it)
        t = torch.from_numpy(arrays[k])
        if manifest["dtypes"][k] == BF16:
            t = t.view(torch.bfloat16)
        if tuple(t.shape) != tuple(leaf.shape):
            raise ValueError(f"shape mismatch for {k}: {tuple(t.shape)} vs "
                             f"{tuple(leaf.shape)}")
        if target is None:
            return t.to(device=dev, dtype=leaf.dtype)
        mesh, placements = target
        local = _local_shard(t, mesh, placements).to(device=dev,
                                                    dtype=leaf.dtype)
        return DTensor.from_local(local, mesh, placements, run_check=False,
                                  shape=t.shape, stride=t.stride())

    with np.load(os.path.join(path, "arrays.npz")) as arrays:
        return tree_map(put, template), manifest
