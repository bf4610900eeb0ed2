"""Sharded scenes: one scene's capacity axis split over shards (port of
``repro.engine.shard``).

**Plan.** Shard ``s`` owns the contiguous capacity rows ``[s*Vs,
(s+1)*Vs)`` at every U-Net level (levels keep the full capacity, so one
split serves all). The host pass (numpy, so it runs on the scheduler's
planner threads) builds each conv's global COIR block as the unsharded
planner does, then splits it with ``core.host_meta.shard_halo_tables_np``
into per-shard local blocks and the send tables of the halo, the rows a
shard's receptive fields read from other shards.

**Execution.** Each conv does one halo exchange, appends the received
rows to its own block and runs the conv on the shard. BatchNorm's
statistics are global: each shard sums its rows in chunks of ``bn_chunk``,
the partial sums are gathered (``V/bn_chunk`` rows, not ``V``) and reduced
in a fixed order. Two forms run the same per-shard code:

* the **loop** form (``mesh=None``): all shards on one device, each step
  of the forward a loop over the shards, the exchange a gather
  (``dist.collectives.halo_exchange_local``'s), the partials concatenated
  in shard order. The counterpart of the JAX package's single-device
  ``vmap(axis_name=...)`` path; on the card and on the CPU;
* the **process** form (an ``ExecutionContext(mesh=...)`` naming the
  shard axis): one process a shard, the exchange one ``all_to_all_single``
  (``dist.collectives.halo_exchange``), the partials one ``all_gather``,
  and the logits gathered to every process at the end. The counterpart of
  the JAX package's ``shard_map``.

**Bitwise contract** (the JAX package's): cross-shard traffic moves rows
and adds nothing, and every float reduction has a fixed order and shape.
A conv sums its per-plane ``(Vo, C) @ (C, N)`` products plane by plane in
order, at the same shapes in both forms; the BatchNorm sums are folds of
elementwise adds in a fixed pairwise order (``_fold_sum``), chunk rows
first, then the gathered partials, so no reduction kernel picks an order.
The loop form therefore equals the process form bit for bit (on the CPU
at one ``torch.set_num_threads``: a CPU matmul's sums can follow the
thread count), and both agree with the unsharded ``reference`` backend
within float tolerance. No kernel wrapper runs: the JAX package's sharded
path is plain XLA ops, and the port's is plain PyTorch ops.
"""
from __future__ import annotations

import math
from dataclasses import dataclass, replace
from typing import NamedTuple

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.core.hashgrid import kernel_offsets
from repro_torch.core.host_meta import (
    build_cirf_np,
    shard_halo_tables_np,
    transposed_coir_np,
)
from repro_torch.device import require_device
from repro_torch.dist.collectives import halo_exchange, halo_exchange_local
from repro_torch.engine.backends import Backend, default_registry
from repro_torch.engine.context import mesh_axes
from repro_torch.engine.plan import level_geometry
from repro_torch.sparse.tensor import SparseVoxelTensor

SHARDED = "sharded"


@dataclass(frozen=True)
class ShardLayout:
    """How a scene's capacity axis is sharded.

    ``halo`` is the row budget of each (owner, consumer) pair of a conv's
    send tables: 0 sizes it per scene (a new signature per scene), a
    positive value pins it (one signature, the serving mode; an overflow
    raises at plan build, rows are never dropped). ``bn_chunk`` is the
    BatchNorm partial-sum chunk, snapped down to a divisor of the shard
    size at plan build.
    """

    n_shards: int
    axis: str = "shard"
    halo: int = 0
    bn_chunk: int = 256

    def shard_size(self, capacity: int) -> int:
        if self.n_shards < 1 or capacity % self.n_shards:
            raise ValueError(
                f"capacity {capacity} not divisible into {self.n_shards} "
                "equal shards")
        return capacity // self.n_shards


class ShardedConvPlan(NamedTuple):
    """One conv's sharded tables (leading dim: the shard).

    ``indices`` ``(S, Vs, K)``: the COIR block in local coding, ``[0, Vs)``
    own rows, ``Vs + d*H + j`` halo slot ``j`` from shard ``d``, ``-1``
    holes. ``mask`` ``(S, Vs)``: the active output rows. ``send_rows``
    ``(S, S, H)``: ``send_rows[d, s]`` the rows shard ``d`` sends shard
    ``s``, local to ``d``, ``-1`` pads.
    """

    indices: np.ndarray | torch.Tensor
    mask: np.ndarray | torch.Tensor
    send_rows: np.ndarray | torch.Tensor


class ShardedLevelPlan(NamedTuple):
    """One U-Net level, sharded: its active mask and its three conv sites."""

    mask: np.ndarray | torch.Tensor
    sub: ShardedConvPlan
    down: ShardedConvPlan | None
    up: ShardedConvPlan | None


def _map_convs(fn, lvl: ShardedLevelPlan) -> ShardedLevelPlan:
    def conv(cp):
        return None if cp is None else ShardedConvPlan(*(fn(x) for x in cp))

    return ShardedLevelPlan(fn(lvl.mask), conv(lvl.sub), conv(lvl.down),
                            conv(lvl.up))


@dataclass
class ShardedScenePlan:
    """One scene's sharded plan: numpy tables on the host, tensors after
    ``device_upload``. ``stats`` is host-only (per-shard occupancy, halo
    rows and budgets of each conv)."""

    levels: tuple[ShardedLevelPlan, ...]
    layout: ShardLayout
    stats: list[dict] | None = None

    #: ``engine.apply_unet`` sends plans carrying this attribute to the
    #: named scene-level backend's ``run_unet``
    scene_backend = SHARDED

    @property
    def n_shards(self) -> int:
        return self.layout.n_shards

    @property
    def device(self) -> torch.device | None:
        """Device of the plan's tables; None for a host (numpy) plan."""
        mask = self.levels[0].mask
        return mask.device if isinstance(mask, torch.Tensor) else None

    def halo_rows(self) -> int:
        """The real cross-shard rows one forward exchanges (0 without
        stats)."""
        if not self.stats:
            return 0
        return sum(sum(lvl["halo_rows"].values()) for lvl in self.stats)

    def leaves(self) -> list:
        """The plan's tables in a fixed order (level by level: mask, then
        each conv's indices, mask and send rows)."""
        out: list = []
        for lvl in self.levels:
            _map_convs(lambda x: out.append(x) or x, lvl)
        return out

    def signature(self) -> tuple:
        """What a forward depends on: the layout, which convs exist, and
        each table's shape. Plans of one pinned layout and capacity share
        it."""
        convs = tuple(cp is not None for lvl in self.levels
                      for cp in (lvl.down, lvl.up))
        return self.layout, convs, tuple(tuple(x.shape)
                                         for x in self.leaves())

    def device_upload(self, device: str | torch.device = "cuda"
                      ) -> "ShardedScenePlan":
        """A copy of a host plan's tables on ``device`` (``PlanCache``
        memoizes it)."""
        return upload_sharded_scene_plan(self, device)


# ---------------------------------------------------------------------------
# Plan building (host, numpy)
# ---------------------------------------------------------------------------

def _shard_conv(indices, out_mask, n_shards: int, halo: int):
    local_idx, send_rows, n_halo = shard_halo_tables_np(
        indices, n_shards, halo)
    mask = np.asarray(out_mask).reshape(n_shards, -1)
    return ShardedConvPlan(local_idx, mask, send_rows), n_halo


def build_sharded_scene_plan_host(t: SparseVoxelTensor, cfg, *,
                                  layout: ShardLayout) -> ShardedScenePlan:
    """AdMAC metadata and the halo split of one scene -> host (numpy) plan.

    Each level's global COIR blocks come from the numpy builders the
    unsharded planner uses (the same tables), then split into per-shard
    local blocks and send tables. Safe on planner threads; pair with
    :func:`upload_sharded_scene_plan`."""
    vs = layout.shard_size(t.capacity)
    layout = replace(layout,
                     bn_chunk=math.gcd(max(int(layout.bn_chunk), 1), vs))
    offs2 = kernel_offsets(2, centered=False)
    offs3 = kernel_offsets(3)
    geometry = level_geometry(t, cfg)
    levels: list[ShardedLevelPlan] = []
    stats: list[dict] = []
    for li, (coords, mask, res) in enumerate(geometry):
        sub_coir = build_cirf_np(coords, mask, coords, mask, offs3, res)
        sub, halo_sub = _shard_conv(sub_coir.indices, mask,
                                    layout.n_shards, layout.halo)
        down = up = None
        halo_rows = {"sub": halo_sub}
        halo_budget = {"sub": int(sub.send_rows.shape[-1])}
        if li < len(cfg.widths) - 1:
            dn_coords, dn_mask, _ = geometry[li + 1]
            down_coir = build_cirf_np(
                dn_coords, dn_mask, coords, mask, offs2, res, stride=2)
            up_coir = transposed_coir_np(dn_coords, dn_mask, coords, mask,
                                         res, 2, 2)
            down, halo_rows["down"] = _shard_conv(
                down_coir.indices, dn_mask, layout.n_shards, layout.halo)
            up, halo_rows["up"] = _shard_conv(
                up_coir.indices, mask, layout.n_shards, layout.halo)
            halo_budget["down"] = int(down.send_rows.shape[-1])
            halo_budget["up"] = int(up.send_rows.shape[-1])
        shard_active = np.asarray(mask).reshape(layout.n_shards, -1).sum(1)
        stats.append({
            "level": li,
            "n_active": int(shard_active.sum()),
            "shard_active": [int(n) for n in shard_active],
            "halo_rows": halo_rows,
            "halo_budget": halo_budget,
        })
        levels.append(ShardedLevelPlan(
            np.asarray(mask).reshape(layout.n_shards, -1), sub, down, up))
    return ShardedScenePlan(tuple(levels), layout, stats)


def upload_sharded_scene_plan(plan: ShardedScenePlan,
                              device: str | torch.device = "cuda"
                              ) -> ShardedScenePlan:
    """A host plan's tables as tensors on ``device`` (same dtypes: int32
    tables, bool masks), keeping the host-only stats."""
    dev = require_device(device)
    levels = tuple(
        _map_convs(lambda x: torch.as_tensor(np.asarray(x), device=dev), lvl)
        for lvl in plan.levels)
    return ShardedScenePlan(levels, plan.layout, plan.stats)


def build_sharded_scene_plan(t: SparseVoxelTensor, cfg, *,
                             layout: ShardLayout,
                             device: str | torch.device = "cuda"
                             ) -> ShardedScenePlan:
    """Host build and upload to ``device`` in one step."""
    return upload_sharded_scene_plan(
        build_sharded_scene_plan_host(t, cfg, layout=layout), device)


def pin_halo(scenes, cfg, layout: ShardLayout,
             margin: float = 1.5) -> ShardLayout:
    """The halo budget frozen from representative scenes (serving mode):
    ``margin`` times the worst per-(owner, consumer) halo row count of any
    conv of ``scenes``, plus one, so every plan built from the returned
    layout has one signature (the sharded counterpart of
    ``build_plan_spec`` pinning tile counts)."""
    worst = 0
    probe = replace(layout, halo=0)
    for t in scenes:
        plan = build_sharded_scene_plan_host(t, cfg, layout=probe)
        for lvl in plan.stats:
            worst = max(worst, *lvl["halo_budget"].values())
    return replace(layout, halo=int(np.ceil(margin * worst)) + 1)


# ---------------------------------------------------------------------------
# Execution: per-shard math, the same in both forms
# ---------------------------------------------------------------------------

def _plane_conv(buf, idx, weight):
    """Plane-by-plane contraction -> (Vo, N) f32: buffer rows gathered by
    ``idx`` (``-1`` reads a zero row appended to ``buf``), one ``(Vo, C) @
    (C, N)`` product a weight plane, summed in plane order. Each shard's
    products have the same shapes in both forms, so their sums are the
    same bits."""
    zero = torch.zeros((1, buf.shape[1]), dtype=buf.dtype, device=buf.device)
    buf = torch.cat([buf, zero]).float()
    rows = torch.where(idx >= 0, idx, buf.shape[0] - 1).long()
    w = weight.float()
    out = buf[rows[:, 0]] @ w[0]
    for k in range(1, w.shape[0]):
        out = out + buf[rows[:, k]] @ w[k]
    return out


def _fold_sum(x: torch.Tensor, dim: int = 0) -> torch.Tensor:
    """Sum over ``dim`` in a fixed order: halves added elementwise until one
    row is left (an odd row carried to the next round). Elementwise adds
    give the same bits on every device and thread count, where a
    reduction kernel may pick its own order; a sequential scan would be
    one launch a row."""
    while x.shape[dim] > 1:
        n = x.shape[dim]
        half = n // 2
        head = x.narrow(dim, 0, half) + x.narrow(dim, half, half)
        x = (torch.cat([head, x.narrow(dim, 2 * half, 1)], dim) if n % 2
             else head)
    return x.squeeze(dim)


def _chunk_sums(x, chunk: int):
    """(rows, F) -> (rows // chunk, F) column sums of each chunk of rows."""
    return _fold_sum(x.reshape(x.shape[0] // chunk, chunk, x.shape[-1]), 1)


class _Loop:
    """The loop form's collectives: every shard on this device."""

    def __init__(self, n_shards: int):
        self.shards = list(range(n_shards))

    def exchange(self, xs, send_rows):
        return list(halo_exchange_local(torch.stack(xs), send_rows))

    def gather(self, parts):
        return torch.cat(parts)


class _Group:
    """The process form's collectives: this process's shard in ``group``."""

    def __init__(self, group, rank: int):
        self.group, self.shards = group, [rank]

    def exchange(self, xs, send_rows):
        (x,), (s,) = xs, self.shards
        return [halo_exchange(self.group, x, send_rows[s])]

    def gather(self, parts):
        (part,) = parts
        parts = [torch.empty_like(part)
                 for _ in range(dist.get_world_size(self.group))]
        dist.all_gather(parts, part.contiguous(), group=self.group)
        return torch.cat(parts)


def _sharded_bn_relu(xs, masks, scale, offset, comm, chunk: int,
                     eps: float = 1e-5):
    """Masked BatchNorm and ReLU with statistics over every shard, formula
    for formula ``core.sparse_conv.masked_batchnorm_relu``'s; only the
    chunks' partial sums cross shards."""
    mms = [m[:, None].to(x.dtype) for x, m in zip(xs, masks)]
    tot = _fold_sum(comm.gather(
        [_chunk_sums(torch.cat([x * mm, mm], 1), chunk)
         for x, mm in zip(xs, mms)]))
    n = tot[-1].clamp(min=1.0)
    mean = tot[:-1] / n
    var = _fold_sum(comm.gather(
        [_chunk_sums((x - mean).square() * mm, chunk)
         for x, mm in zip(xs, mms)])) / n
    inv = torch.rsqrt(var + eps)
    return [torch.relu((x - mean) * inv * scale + offset) * mm
            for x, mm in zip(xs, mms)]


def _sharded_conv(xs, cp: ShardedConvPlan, params, comm):
    """One conv site on each shard's rows: the halo exchange, then the
    local conv."""
    recv = comm.exchange(xs, cp.send_rows)
    out = []
    for x, r, s in zip(xs, recv, comm.shards):
        buf = torch.cat([x, r.reshape(-1, x.shape[-1])])
        y = _plane_conv(buf, cp.indices[s], params.weight)
        y = y.to(x.dtype) + params.bias.to(x.dtype)
        out.append(y * cp.mask[s][:, None].to(y.dtype))
    return out


def _local_apply_unet(model, xs, levels, layout: ShardLayout, comm):
    """The U-Net forward of the shards ``comm.shards``: their blocks ``xs``
    (Vs, C_in) each -> their logits (Vs, n_classes) each."""
    chunk = layout.bn_chunk

    def block(xs, lvl, blk):
        ys = _sharded_conv(xs, lvl.sub, blk.conv.params, comm)
        masks = [lvl.mask[s] for s in comm.shards]
        return _sharded_bn_relu(ys, masks, blk.bn_scale, blk.bn_offset,
                                comm, chunk)

    xs = _sharded_conv(xs, levels[0].sub, model.stem.params, comm)
    skips = []
    for lvl, p in zip(levels, model.levels):
        for blk in p.enc:
            xs = block(xs, lvl, blk)
        if lvl.down is not None:
            skips.append(xs)
            xs = _sharded_conv(xs, lvl.down, p.down.params, comm)
    for li in range(len(levels) - 2, -1, -1):
        lvl, p = levels[li], model.levels[li]
        ups = _sharded_conv(xs, lvl.up, p.up.params, comm)
        xs = [torch.cat([sk, up], -1) for sk, up in zip(skips[li], ups)]
        for blk in p.dec:
            xs = block(xs, lvl, blk)
    return [x @ model.head.w + model.head.b for x in xs]


def apply_unet_sharded(model, feats, plan: ShardedScenePlan, *, mesh=None,
                       axis: str | None = None,
                       device: str | torch.device = "cuda") -> torch.Tensor:
    """U-Net forward off an uploaded ShardedScenePlan -> (V, n_classes)
    logits.

    ``model`` is a ``models.scn.SCNUNet`` on ``device``; ``feats`` (V,
    C_in) is copied there if it lies elsewhere. Without ``mesh`` the
    shards run as a loop on this device. With ``mesh`` (a
    ``torch.distributed`` ``DeviceMesh`` whose dims include the shard
    axis, ``axis`` or the layout's), this process runs the shard of its
    rank on that axis, the collectives go through the axis's process
    group, and every process returns the whole logits."""
    dev = require_device(device)
    if plan.device is None or plan.device.type != dev.type:
        raise ValueError(f"plan tables are on {plan.device}, not {dev}: "
                         "upload the plan with plan.device_upload(device)")
    layout = plan.layout
    n = layout.n_shards
    feats = torch.as_tensor(feats, dtype=model.head.w.dtype, device=dev)
    vs = layout.shard_size(feats.shape[0])
    if plan.levels[0].mask.shape[-1] != vs:
        raise ValueError(
            f"plan shard size {plan.levels[0].mask.shape[-1]} != "
            f"feats shard size {vs}")
    blocks = feats.reshape(n, vs, feats.shape[-1])
    if mesh is None:
        comm = _Loop(n)
    else:
        axis = axis or layout.axis
        axes = mesh_axes(mesh)
        if axis not in axes:
            raise ValueError(
                f"mesh axes {tuple(axes)} lack shard axis {axis!r}")
        if axes[axis] != n:
            raise ValueError(f"plan has {n} shards but mesh axis {axis!r} "
                             f"has size {axes[axis]}")
        comm = _Group(mesh.get_group(axis), mesh.get_local_rank(axis))
    out = _local_apply_unet(model, [blocks[s] for s in comm.shards],
                            plan.levels, layout, comm)
    return (comm.gather(out) if mesh is not None else torch.cat(out))


# ---------------------------------------------------------------------------
# Backend registration
# ---------------------------------------------------------------------------

class ShardedBackend(Backend):
    """Scene-level backend: sharded execution with halo exchange.

    Reached through ``engine.apply_unet`` on a ``ShardedScenePlan`` (the
    plan names it through ``scene_backend``); the mesh comes from the
    call's ``ExecutionContext``. A per-conv ``run`` raises: a sharded conv
    only makes sense inside the scene's forward."""

    name = SHARDED
    scene_level = True

    def supports(self, plan) -> bool:
        return isinstance(plan, ShardedScenePlan)

    def run(self, x, params, plan, *, use_kernel: bool = True):
        raise ValueError(
            "the sharded backend executes whole scenes; call "
            "engine.apply_unet with a ShardedScenePlan")

    def run_unet(self, model, feats, plan, *, ctx, device="cuda", **kw):
        return apply_unet_sharded(model, feats, plan,
                                  mesh=None if ctx is None else ctx.mesh,
                                  device=device)


default_registry().register(SHARDED, ShardedBackend(), overwrite=True)
