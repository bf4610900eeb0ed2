"""ShardingRules: named shardings for params, state, batches and caches
(port of ``repro.dist.sharding``).

One rules object per (config, mesh) pair. Mesh dims follow
``launch.mesh.make_production_mesh``: ``("data", "model")`` single pod or
``("pod", "data", "model")`` multi-pod. By default parameters are
tensor-parallel over ``"model"`` and replicated over the DP axes, while
batches shard their leading dimension over the DP axes (optimizer state
rides the same per-leaf rule as the parameters it mirrors).
``full_dp=True`` folds the model axis into data parallelism: parameters
are replicated and batches shard over every mesh axis. Every rule is a
divisibility-checked heuristic, never an error: a dimension that no axis
divides is left unsharded.

Each method returns a tree of ``hints.NamedSharding`` (``spec`` and
``placements``) matching its input. The JAX rules read the JAX package's
layout, which stacks the layers of each cycle position on a leading axis:
the parameter rule never shards dim 0 of a leaf of rank >= 2, since there
it is the stack, and the cache rule considers every dim, the stack's too.
The port holds one tensor per layer (``models.transformer.
params_from_jax``), so each leaf's rule is evaluated on the shape its leaf
has in the JAX layout (``training.train_loop.layout_groups`` says which
port leaves form one stacked leaf) and the stack's entry is then dropped.
Where the JAX rule would shard the stack itself, the port cannot split one
layer's tensor over layers. For a parameter the entry is dropped all the
same, and the leaf is replicated over that axis. For a decode cache the
DP entry moves to the first other dim that the DP size divides and that
is not the model dim (the batch dim, as a rule), so a rank holds the same
1/dp share of the cache as under the JAX layout; where no such dim
exists, the leaf is replicated over DP.
"""
from __future__ import annotations

import math
from collections import Counter

import torch

from repro_torch.dist.hints import NamedSharding, mesh_axes
from repro_torch.training.tree import tree_leaves, tree_map

_STACKED = "stacked"


class ShardingRules:
    def __init__(self, cfg, mesh, *, full_dp: bool = False):
        self.cfg = cfg
        self.mesh = mesh
        self.full_dp = full_dp
        self.axes = axes = mesh_axes(mesh)
        has_model = "model" in axes
        self.model_axis = "model" if (has_model and not full_dp) else None
        dp = tuple(a for a in axes if a != "model")
        if full_dp and has_model:
            dp = dp + ("model",)
        # axes of size 1 contribute nothing; dropping them keeps specs tidy
        self.dp_axes = tuple(a for a in dp if axes[a] > 1)
        self.model_size = (axes["model"] if self.model_axis
                           and axes["model"] > 1 else 1)
        self.dp_size = math.prod(axes[a] for a in self.dp_axes)

    # -- helpers ------------------------------------------------------------

    def _named(self, spec) -> NamedSharding:
        return NamedSharding(self.mesh, tuple(spec))

    def replicated(self) -> NamedSharding:
        return self._named(())

    def _dp_entry(self):
        if not self.dp_axes:
            return None
        return self.dp_axes if len(self.dp_axes) > 1 else self.dp_axes[0]

    @staticmethod
    def _divides(dim: int, size: int) -> bool:
        return size > 1 and dim >= size and dim % size == 0

    def _layout_shapes(self, tree):
        """Each leaf's shape in the JAX layout, and whether the JAX package
        stacks it: a subtree holding ``"layers"`` (parameters, optimizer
        moments, a decode cache) is read through ``layout_groups``."""
        from repro_torch.training.train_loop import layout_groups

        def shape(x):
            return tuple(x.shape) if isinstance(x, torch.Tensor) else ()

        if isinstance(tree, dict) and isinstance(tree.get("layers"), list):
            groups = layout_groups(tree, self.cfg)
            n = Counter(k for k in tree_leaves(groups) if k is not None)
            return tree_map(
                lambda x, k: ((n[k],) + shape(x), _STACKED) if k is not None
                else (shape(x), None), tree, groups)
        if isinstance(tree, dict):
            return {k: self._layout_shapes(tree[k]) for k in sorted(tree)}
        if isinstance(tree, list):
            return [self._layout_shapes(x) for x in tree]
        return shape(tree), None

    def _per_leaf(self, rule, tree, restack=None):
        """``rule`` on each leaf's JAX-layout shape; a stacked leaf's spec
        loses its stack entry, after ``restack(spec, shape)`` where given."""
        def one(shape_stacked):
            shape, stacked = shape_stacked
            spec = rule(shape)
            if stacked and spec and restack is not None:
                spec = restack(spec, shape)
            return self._named(spec[1:] if stacked and spec else spec)

        return tree_map(one, self._layout_shapes(tree))

    # -- parameters / optimizer state --------------------------------------

    def param_spec(self, shape) -> tuple:
        """Tensor-parallel over "model" on the innermost divisible dim of a
        JAX-layout shape; dim 0 of a leaf of rank >= 2 is never sharded."""
        if self.model_size > 1 and shape:
            start = 0 if len(shape) == 1 else 1
            for d in range(len(shape) - 1, start - 1, -1):
                if self._divides(shape[d], self.model_size):
                    entries = [None] * len(shape)
                    entries[d] = "model"
                    return tuple(entries)
        return ()

    def params_shardings(self, params):
        """Tree of NamedShardings matching a params (or grads) tree."""
        return self._per_leaf(self.param_spec, params)

    def state_shardings(self, state):
        """Train-state tree: params, optimizer moments, step, EF residual.
        The moments mirror the parameters, so the parameter rule applies to
        the whole tree; scalars (``step``) come out replicated."""
        return self._per_leaf(self.param_spec, state)

    # -- batches ------------------------------------------------------------

    def batch_spec(self, shape) -> tuple:
        entries = [None] * len(shape)
        if shape and self._divides(shape[0], self.dp_size):
            entries[0] = self._dp_entry()
        return tuple(entries)

    def batch_shardings(self, batch):
        """Input batches shard dim 0 (global batch) over the DP axes."""
        return self._per_leaf(self.batch_spec, batch)

    # -- decode caches -------------------------------------------------------

    def cache_spec(self, shape) -> tuple:
        """KV/state caches: heads over "model" when they divide, else the
        longest divisible dim (ties to the rightmost); batch over DP. On a
        JAX-layout shape, the stack dim included."""
        if not shape:
            return ()
        entries = [None] * len(shape)
        model_dim = None
        if self.model_size > 1:
            head_sizes = {self.cfg.n_kv_heads, self.cfg.n_heads}
            cands = [d for d in range(len(shape))
                     if self._divides(shape[d], self.model_size)]
            heads = [d for d in cands if shape[d] in head_sizes]
            pick = heads if heads else cands
            if pick:
                model_dim = max(pick, key=lambda d: (shape[d], d))
                entries[model_dim] = "model"
        if self.dp_size > 1:
            for d in range(len(shape)):
                if d != model_dim and self._divides(shape[d], self.dp_size):
                    entries[d] = self._dp_entry()
                    break
        return tuple(entries)

    def _move_dp_off_stack(self, spec, shape) -> tuple:
        """A cache spec whose DP entry sits on the stack (dim 0), with that
        entry moved to the first other dim the DP size divides that the
        model entry does not hold; unchanged where there is none."""
        dp = self._dp_entry()
        if dp is None or spec[0] != dp:
            return spec
        for d in range(1, len(shape)):
            if spec[d] is None and self._divides(shape[d], self.dp_size):
                entries = list(spec)
                entries[0], entries[d] = None, dp
                return tuple(entries)
        return spec

    def cache_shardings(self, cache):
        return self._per_leaf(self.cache_spec, cache,
                              restack=self._move_dp_off_stack)
