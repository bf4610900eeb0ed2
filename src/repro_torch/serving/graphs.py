"""CUDA graphs of one serving engine: the port's counterpart of the JAX
package's jitted steps.

A :class:`Graphs` captures a function once per key (a decode step index, a
capacity bucket) and replays it afterwards. Every graph of one ``Graphs``
draws from one memory pool, so a dozen step graphs cost one step's
activations: that is safe because replays never overlap (one stream) and
the caller copies what a graph leaves in the pool out of it (or lets the
graph write into buffers it owns) before the next replay.

Capture runs on a side stream with ``capture_error_mode="thread_local"``:
another thread of the process (the previous wave's drain reading its
result back) may call CUDA while this one captures. The caller warms the
function up eagerly first, so that libraries load and workspaces exist
before capture. A capture collects garbage first and runs with the
collector off: a dead engine's graph freed mid-capture would invalidate it.

A replay runs kernels without calling their Python wrappers, so it ticks
no launch counter (``sspnna_fused.launches`` and the others). ``Graphs``
counts for them: ``captured`` holds the counters' ticks made while
capturing (launches recorded into a graph, not run), ``replayed`` the
launches that replays ran. A path's launches are its counters' ticks, less
``captured``, plus ``replayed``.

The engines time their device work with :func:`timing_event` s on the
stream and read them once the drain has waited on the wave's last one.
"""
from __future__ import annotations

import gc
from collections import Counter

import torch

from repro_torch.kernels.flash.flash import flash_attention
from repro_torch.kernels.moe_gemm.moe_gemm import grouped_gemm
from repro_torch.kernels.sspnna.sspnna import sspnna_fused, sspnna_tiles

#: the kernel wrappers whose ``launches`` a graph's capture records
COUNTED = {"sspnna_fused": sspnna_fused, "sspnna_tiles": sspnna_tiles,
           "flash_fwd": flash_attention, "moe_gemm": grouped_gemm}


def timing_event(device: torch.device, *, external: bool = False):
    """A CUDA timing event recorded now on the current stream, or None off
    the card. ``external`` records it as a node of a graph being captured,
    so that each replay records it again."""
    if device.type != "cuda":
        return None
    ev = torch.cuda.Event(enable_timing=True, external=external)
    ev.record()
    return ev


def _counts() -> Counter:
    return Counter({name: fn.launches for name, fn in COUNTED.items()})


class Graphs:
    """One engine's CUDA graphs, by key, in one memory pool on ``device``."""

    def __init__(self, device: torch.device):
        if device.type != "cuda":
            raise ValueError(f"CUDA graphs need a CUDA device, not {device}")
        self.device = device
        self.pool = torch.cuda.graph_pool_handle()
        self.stream = torch.cuda.Stream(device)
        self._graphs: dict = {}   # key -> (graph, output, launches per run)
        self.captured: Counter = Counter()
        self.replayed: Counter = Counter()
        self.replays = 0

    def __contains__(self, key) -> bool:
        return key in self._graphs

    def __len__(self) -> int:
        return len(self._graphs)

    def keys(self) -> list:
        """The keys of the captured graphs, in capture order."""
        return list(self._graphs)

    def launches(self, key) -> Counter:
        """The kernel launches one replay of ``key``'s graph runs."""
        return Counter(self._graphs[key][2])

    def capture(self, key, fn) -> None:
        """Capture ``fn()`` (already run eagerly once) as ``key``'s graph.
        A capture that fails raises: nothing runs eagerly instead."""
        if key in self._graphs:
            raise ValueError(f"graph {key!r} is already captured")
        graph = torch.cuda.CUDAGraph()
        before = _counts()
        # An engine dropped in a reference cycle (its scheduler holds its
        # bound stages) keeps its graphs until the collector runs; freeing
        # a graph's memory during this capture would invalidate it. So
        # collect first, and keep the collector off while capturing.
        gc.collect()
        collecting = gc.isenabled()
        gc.disable()
        try:
            with torch.cuda.graph(graph, pool=self.pool, stream=self.stream,
                                  capture_error_mode="thread_local"):
                out = fn()
        finally:
            if collecting:
                gc.enable()
        launched = _counts() - before
        self.captured += launched
        self._graphs[key] = (graph, out, launched)

    def replay(self, key):
        """Run ``key``'s graph on the current stream; returns what its
        function returned at capture (tensors the replay overwrote)."""
        graph, out, launched = self._graphs[key]
        graph.replay()
        self.replays += 1
        self.replayed += launched
        return out
