"""Batched 3D-scene serving: fixed-capacity slots, cached plans, one CUDA
graph per capacity bucket (port of ``repro.serving.scene_engine``; the
streaming and sharded modes come with later slices).

The 3D face of the shared ``serving.scheduler.WaveScheduler``: the host
packs up to ``batch`` scene requests per wave, builds (or cache-hits) each
scene's plan, and runs the wave through one U-Net forward. The engine runs
under an :class:`~repro_torch.engine.context.ExecutionContext` (``ctx=``),
which owns the device, the plan cache (topology mixed into every key), the
backend registry and the default admission policy. Two modes:

* **batched** (default): every scene at the config's capacity; a pinned
  ``PlanSpec`` (``spec=``) fixes the plans' dispatches and tile budgets,
  and without one every conv runs on ``reference``.
* **bucketed** (``family=SignatureFamily(...)``): each request takes the
  smallest capacity bucket its active voxels fit at submit time (a scene
  over every bucket is shed with reason ``"capacity"``); the plan stage
  re-packs it to that capacity, admission fills each wave from one bucket,
  and the drain scatters the logits back to the request's rows.

The wave forward is the counterpart of the JAX package's ``vmap`` over
stacked plans: the B plans are concatenated (``engine.stack_plans``) and
``engine.apply_unet`` runs the B x capacity rows in one pass, one kernel
launch per conv for the whole wave. On the card each bucket's forward is a
CUDA graph (``serving.graphs``), the counterpart of one jit signature per
bucket: captured on the bucket's first wave, it reads per-bucket buffers
that each later wave fills with its plans' tables and features before the
replay. A plan whose signature differs from the wave's or the bucket's (a
scene over a pinned tile budget) raises; it never runs eagerly instead. On
the CPU the same forward runs eagerly.

Stage split, as in the JAX package: **plan** builds the host plan
(``PlanCache.get_or_build(device=False)``) on planner threads; **dispatch**
fetches each plan's memoized upload and enqueues the forward without a
host sync; **drain** reads the wave's logits back. ``sync=False``
pipelines them. Short waves are padded with the first scene's plan and
zero features; padding slots are dropped.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass

import numpy as np
import torch

from repro_torch.device import require_device
from repro_torch.engine import api as engine_api
from repro_torch.engine.context import ExecutionContext
from repro_torch.engine.plan import (
    PlanCache,
    PlanSpec,
    SignatureFamily,
    plan_signature,
    stack_plans,
)
from repro_torch.serving.api import AdmissionPolicy, ServeRequest, ServingBase
from repro_torch.serving.graphs import Graphs
from repro_torch.serving.scheduler import WaveScheduler
from repro_torch.sparse.tensor import SparseVoxelTensor, compact_to_capacity


@dataclass
class SceneRequest(ServeRequest):
    """One scene to segment; SLO fields (tenant/priority/deadline_ms) come
    from :class:`~repro_torch.serving.api.ServeRequest` as keyword-only
    args."""

    scene: SparseVoxelTensor = None
    logits: np.ndarray | None = None   # (capacity, n_classes)
    pred: np.ndarray | None = None     # (capacity,) argmax classes
    done: bool = False


class SceneEngine(ServingBase):
    """Host-side batched scene driver (fixed shapes, plan-cached).

    ``model`` is a ``models.scn.SCNUNet`` on the engine's device.
    ``spec=None`` serves every scene on the reference backend; pass
    ``spec=build_plan_spec(rep_scenes, cfg)`` to serve SPADE's
    reference/SSpNNA mix at pinned tile budgets, or
    ``family=build_signature_family(rep_scenes, cfg)`` for bucketed
    serving. ``use_kernel`` (default on, as ``apply_unet``'s) runs tiled
    convs through the fused kernel. The engine serves on ``ctx.device``
    (the card unless the context says otherwise; without ``ctx`` the
    card). ``sync`` / ``depth`` / ``planner_threads`` / ``policy`` default
    to the context's.
    """

    def __init__(self, cfg, model, batch: int, spec: PlanSpec | None = None,
                 *, ctx: ExecutionContext | None = None, layout=None,
                 family: SignatureFamily | None = None,
                 policy: AdmissionPolicy | None = None,
                 backend: str = "auto", use_kernel: bool = True,
                 plan_cache_size: int | None = None,
                 order: str = "soar", soar_chunk: int = 512,
                 sync: bool | None = None, depth: int | None = None,
                 planner_threads: int | None = None, faults=None):
        if layout is not None:
            raise NotImplementedError(
                "layout= (sharded scenes) comes with ROADMAP.md, queue 1, "
                "slice 9")
        if ctx is None:
            ctx = ExecutionContext(
                plan_cache=PlanCache(plan_cache_size or 128))
        elif plan_cache_size is not None:
            raise ValueError(
                "plan_cache_size only applies when the engine builds its "
                "own context; size ctx.plan_cache when passing ctx=")
        self.device = require_device(ctx.device)
        if model.head.w.device.type != self.device.type:
            raise ValueError(f"model is on {model.head.w.device}, the engine "
                             f"serves on {self.device}")
        if family is not None and spec is not None:
            raise ValueError(
                "spec= and family= are mutually exclusive: the family "
                "carries a pinned spec per capacity bucket")
        self.cfg, self.model, self.batch, self.spec = cfg, model, batch, spec
        self.ctx, self.family = ctx, family
        self.backend, self.use_kernel = backend, use_kernel
        self.cache = ctx.plan_cache
        self._topology = ctx.topology_key()
        if family is not None:
            # per-bucket configs share the model; only the capacity differs
            self._bucket_cfgs = {
                cap: dataclasses.replace(cfg, capacity=cap)
                for cap in family.capacities}
            self._bucket_kw = {
                cap: dict(spec=family.spec_for(cap),
                          plan_tiles=family.spec_for(cap) is not None,
                          order=order, soar_chunk=soar_chunk)
                for cap in family.capacities}
        else:
            self._plan_kw = dict(spec=spec, plan_tiles=spec is not None,
                                 order=order, soar_chunk=soar_chunk)
        # bucket capacity -> the plan signature its forward is held to and,
        # on the card, the buffers its graph reads
        self._buckets: dict[int, dict] = {}
        self.graphs = Graphs(self.device) if self.device.type == "cuda" else None
        self.scheduler = WaveScheduler(
            batch=batch, plan=self._plan_stage, dispatch=self._dispatch_stage,
            drain=self._drain_stage,
            sync=ctx.sync if sync is None else sync,
            depth=ctx.depth if depth is None else depth,
            planner_threads=(ctx.planner_threads if planner_threads is None
                             else planner_threads),
            policy=ctx.admission if policy is None else policy,
            bucket_of=((lambda r: getattr(r, "_bucket", None))
                       if family is not None else None),
            faults=faults)

    # -- introspection -------------------------------------------------------

    @property
    def n_compilations(self) -> int:
        """Bucket signatures pinned so far, one per bucket served: on the
        card each is a captured CUDA graph; on the CPU the signature the
        eager forward is held to."""
        return len(self._buckets)

    # -- streaming (slice 6) -------------------------------------------------

    def open_stream(self, *args, **kw):
        raise NotImplementedError(
            "streams come with ROADMAP.md, queue 1, slice 6 (streaming)")

    def serve_stream(self, *args, **kw):
        raise NotImplementedError(
            "streams come with ROADMAP.md, queue 1, slice 6 (streaming)")

    # -- admission -----------------------------------------------------------

    def _prepare(self, req: SceneRequest) -> str | None:
        """Bucket assignment at submit time (bucketed mode): the smallest
        family capacity the scene's active voxels fit; a scene over every
        bucket is shed with reason ``"capacity"``."""
        if self.family is None:
            return None
        n_active = int(np.asarray(req.scene.mask).sum())
        cap = self.family.bucket_for(n_active)
        if cap is None:
            return "capacity"
        req._bucket = cap
        return None

    # -- pipeline stages -----------------------------------------------------

    def _plan_stage(self, req: SceneRequest):
        """Host plan build (numpy leaves) on a planner thread. The payload
        carries the cache key, so dispatch never re-hashes the scene.
        Bucketed mode re-packs the scene to its bucket first (active rows in
        their order) and keeps the row mapping for the drain."""
        if self.family is not None:
            cap = req._bucket
            scene, req._active_idx = compact_to_capacity(req.scene, cap)
            cfg, plan_kw = self._bucket_cfgs[cap], self._bucket_kw[cap]
        else:
            scene, cfg, plan_kw = req.scene, self.cfg, self._plan_kw
        key = self.cache.key_for(scene, cfg, topology=self._topology,
                                 **plan_kw)
        plan = self.cache.get_or_build(scene, cfg, device=False, key=key,
                                       **plan_kw)
        return key, plan, scene.feats

    @torch.inference_mode()
    def _dispatch_stage(self, reqs: list[SceneRequest], payloads, stats):
        # the plan stage built (and counted) these host plans; adopt fetches
        # the memoized upload without rebuilding or counting
        plans = [self.cache.adopt(key, host, device=self.device)
                 for key, host, _ in payloads]
        for r, p in zip(reqs, plans):
            over = [s["level"] for s in p.stats or () if s.get("tile_overflow")]
            if over:
                raise RuntimeError(
                    f"scene {r.rid}: needs more tiles than the pinned budget "
                    f"at level {over}, so its plan signature diverged from "
                    "the bucket's; raise tile_margin in build_plan_spec")
        if self.family is not None:
            # admission admits one bucket a wave; a mixed wave means the
            # bucket hook was bypassed
            caps = {r._bucket for r in reqs}
            if len(caps) != 1:
                raise RuntimeError(
                    f"wave mixes capacity buckets {sorted(caps)}; bucketed "
                    "serving admits one bucket per wave")
            cap = caps.pop()
        else:
            cap = self.cfg.capacity
        dtype = self.model.head.w.dtype
        feats = [torch.as_tensor(f, dtype=dtype, device=self.device)
                 for _, _, f in payloads]
        return self.run_wave(feats, plans, cap, rids=[r.rid for r in reqs],
                             notes=stats.notes)

    def _apply(self, feats, plan) -> torch.Tensor:
        return engine_api.apply_unet(
            self.model, feats, plan, backend=self.backend,
            registry=self.ctx.registry, use_kernel=self.use_kernel,
            device=self.device)

    @torch.inference_mode()
    def run_wave(self, feats: list, plans: list, capacity: int, *,
                 rids=None, notes: dict | None = None) -> torch.Tensor:
        """Logits ``(batch * capacity, n_classes)`` of one wave: up to
        ``batch`` scenes' features (on the device) and uploaded plans, all
        of bucket ``capacity``; a short wave is padded with the first
        scene's plan and zero features. On the CPU the forward runs
        eagerly; on the card it is a replay of the bucket's graph, captured
        on its first wave, and ``notes["graph_launches"]`` receives the
        kernel launches it ran. A plan whose signature differs from the
        wave's or the bucket's raises."""
        rids = list(range(len(plans))) if rids is None else rids
        want = (capacity, self.model.stem.weight.shape[1])
        for rid, f in zip(rids, feats):
            if tuple(f.shape) != want:
                raise ValueError(f"scene {rid}: features {tuple(f.shape)}, "
                                 f"the bucket takes {want}")
        sig = plan_signature(plans[0])
        for rid, p in zip(rids, plans):
            if plan_signature(p) != sig:
                raise RuntimeError(
                    f"scene {rid}: plan signature diverged from the wave "
                    "(tile-budget overflow?); raise tile_margin in "
                    "build_plan_spec")
        bucket = self._buckets.setdefault(capacity, {"sig": sig})
        if bucket["sig"] != sig:
            raise RuntimeError(
                f"plan signature diverged from bucket {capacity}'s pinned "
                "signature (another spec or capacity?)")
        plans, feats = list(plans), list(feats)
        while len(plans) < self.batch:  # pad the wave to fixed batch
            plans.append(plans[0])
            feats.append(torch.zeros_like(feats[0]))
        notes = {} if notes is None else notes
        notes["graph_launches"] = {}
        if self.graphs is None:
            return self._apply(torch.cat(feats), stack_plans(plans))
        if capacity not in self.graphs:
            bucket["plan"] = stack_plans(plans)
            bucket["feats"] = torch.cat(feats)
            self._apply(bucket["feats"], bucket["plan"])  # warm-up
            self.graphs.capture(
                capacity,
                lambda: self._apply(bucket["feats"], bucket["plan"]))
        else:
            stack_plans(plans, out=bucket["plan"])
            torch.cat(feats, out=bucket["feats"])
        logits = self.graphs.replay(capacity)
        notes["graph_launches"] = dict(self.graphs.launches(capacity))
        # a copy: the next wave's replay overwrites the graph's output
        return logits.clone()

    def _drain_stage(self, reqs: list[SceneRequest], logits) -> None:
        logits = logits.cpu().numpy()
        logits = logits.reshape(self.batch, -1, logits.shape[-1])
        for i, r in enumerate(reqs):
            if self.family is not None:
                # scatter the bucket's rows back to the request's rows
                # (padding rows stay zero-logit)
                idx = r._active_idx
                out = np.zeros((r.scene.capacity, logits.shape[-1]),
                               logits.dtype)
                out[idx] = logits[i][: len(idx)]
                r.logits = out
            else:
                r.logits = logits[i]
            r.pred = r.logits.argmax(-1)
            r.done = True

    def _health_extra(self) -> dict:
        # circuit breakers come with slice 7
        return {"breakers": {}}
