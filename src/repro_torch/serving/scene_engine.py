"""Batched 3D-scene serving: fixed-capacity slots, cached plans, one CUDA
graph per (capacity bucket, plan signature) (port of
``repro.serving.scene_engine``).

The 3D face of the shared ``serving.scheduler.WaveScheduler``: the host
packs up to ``batch`` scene requests per wave, builds (or cache-hits) each
scene's plan, and runs the wave through one U-Net forward. The engine runs
under an :class:`~repro_torch.engine.context.ExecutionContext` (``ctx=``),
which owns the device, the plan cache (topology mixed into every key), the
backend registry and the default admission policy. Three modes:

* **batched** (default): every scene at the config's capacity; a pinned
  ``PlanSpec`` (``spec=``) fixes the plans' dispatches and tile budgets,
  and without one every conv runs on ``reference``.
* **bucketed** (``family=SignatureFamily(...)``): each request takes the
  smallest capacity bucket its active voxels fit at submit time (a scene
  over every bucket is shed with reason ``"capacity"``); the plan stage
  re-packs it to that capacity, admission fills each wave from one bucket,
  and the drain scatters the logits and classes back to the request's
  rows.
* **sharded** (``layout=pin_halo(rep_scenes, cfg, ShardLayout(...))``):
  each scene's capacity split over the layout's shards
  (``engine.shard``). The plan stage builds the per-shard tables; a wave
  runs each scene's sharded forward eagerly, as a loop over the shards
  (``ctx.mesh=None``) or one shard a process (a ``ctx.mesh`` whose shard
  axis has the layout's size), and its ``WaveStats.notes`` count the
  shards, the plan builds and the halo rows. The pinned halo budget gives
  every plan one signature; a plan that diverges raises.

On top of the batched mode, ``open_stream()`` / ``serve_stream()`` serve
LiDAR sweeps: frames submitted through a :class:`StreamHandle` are planned
*incrementally* (``engine.StreamPlanState``): each frame diffs against the
stream's previous frame after ego-motion re-basing and patches the cached
host plan's tables instead of rebuilding them, with a full rebuild under
heavy churn or after a lost frame. Admission keeps a stream's frames in
order while the policy still arbitrates between streams and one-shot
requests. A frame's plan is uploaded through its stream's per-leaf memo
(only the tables the delta touched are copied), its features are re-packed
into the stream's canonical rows, and its wave runs the same bucket graph
as one-shot scenes of that capacity; the drain scatters the logits and
classes back to the caller's rows. Each wave's ``WaveStats.notes`` counts
``stream_reused`` / ``stream_patched`` / ``stream_rebuilt`` frames, with
the mean ``stream_overlap`` and the summed ``stream_plan_ms``.

The wave forward is the counterpart of the JAX package's ``vmap`` over
stacked plans: the B plans are concatenated (``engine.stack_plans``) and
``engine.apply_unet`` runs the B x capacity rows in one pass, one kernel
launch per conv for the whole wave. On the card the forward of each
(capacity, plan signature) pair is a CUDA graph (``serving.graphs``), the
counterpart of the JAX package's one jit compile per distinct plan
signature: captured on the pair's first wave, it reads buffers of its own
that each later wave fills with its plans' tables and features before the
replay. A new signature (every scene of a wave over a pinned tile budget
at the same level, or plans a tripped circuit breaker rerouted) captures
a new graph; a wave whose plans disagree among themselves raises, as in
the JAX package, and never runs eagerly instead. On the CPU the same
forward runs eagerly. Each row's class is the argmax of its logits, taken
in the same graph (eagerly with the eager forward), narrowed to the smallest
integer dtype that holds ``n_classes`` (``uint8`` for up to 256 classes):
the drain reads back the logits and a byte a row of classes, and the host
computes none.

Circuit breakers and measured dispatch, as in the JAX package: the
context registry's ``BreakerBoard`` is fed by contained wave failures
(``on_wave_error``: the exception's ``backend``, else the non-reference
backends of the wave's plans) and by drained waves (successes), and plan
builds consult it, so a failing backend's new plans reroute along its
fallback chain; ``ctx.autotune`` (a ``CostTable``) reaches the plan
builds, and with ``ctx.autotune_reprofile_ms > 0`` the scheduler's idle
gap re-profiles it (``engine.autotune.reprofile``).

Stage split, as in the JAX package: **plan** builds the host plan
(``PlanCache.get_or_build(device=False)``) on planner threads; **dispatch**
fetches each plan's memoized upload and enqueues the forward without a
host sync; **drain** reads the wave's logits and classes back. ``sync=False``
pipelines them. Short waves are padded with the first scene's plan and
zero features; padding slots are dropped.

Each wave's ``WaveStats`` carries the engine's spans inside the
scheduler's (``serving.scheduler``): in ``serve.dispatch``,
``scene.upload`` (plan adoption, features to the device), ``scene.stage``
(the wave's plans and features stacked into the bucket's buffers) and
``scene.replay`` (the graph's replay; on the CPU, or a new bucket, the
forward itself); in ``serve.drain``, ``scene.wait`` (the host waits on an
event recorded after the replay's output was copied), ``scene.readback``
(the logits' and the classes' copies to the host) and ``scene.finish``
(reshape, scatter, breakers). The drain counts its ``readback_bytes`` and,
in ``notes["pred_device_rows"]``, the rows the device classified. On
the card, CUDA events around the replay give ``event_ms["forward"]``, and
events captured in the bucket's graph at ``apply_unet``'s level
boundaries give ``event_ms["rows"]`` (the wave's tables moved to each
scene's rows), ``["stem"]``, ``["level<i>"]`` (encoder and decoder of
level i) and ``["head"]``; these are read only where no later replay of
the graph was enqueued before the drain (always in sync mode).
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass

import numpy as np
import torch

from repro_torch.analysis.runtime import ordered_lock
from repro_torch.core.host_meta import pack_stream_frame_np
from repro_torch.device import host_array, require_device
from repro_torch.engine import api as engine_api
from repro_torch.engine.context import ExecutionContext, mesh_axes
from repro_torch.engine.plan import (
    REFERENCE,
    PlanCache,
    PlanSpec,
    SignatureFamily,
    StreamPlanState,
    plan_signature,
    stack_plans,
)
from repro_torch.engine.shard import ShardLayout, build_sharded_scene_plan_host
from repro_torch.serving.api import AdmissionPolicy, ServeRequest, ServingBase
from repro_torch.serving.graphs import Graphs, timing_event
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


@dataclass
class StreamFrameRequest(SceneRequest):
    """One frame of an open LiDAR stream (made by ``StreamHandle.submit``).

    Carries the stream handle, its monotonically assigned ``frame_no`` and
    the ``ego_shift`` from the previous frame. After serving, ``logits`` /
    ``pred`` are in the *caller's* row layout (the drain stage scatters the
    stream's canonical rows back through ``frame_rows``), and
    ``plan_info`` records how the frame was planned: ``mode`` in
    {``reused``, ``patched``, ``rebuilt``}, voxel ``overlap`` fraction with
    the previous frame, host ``plan_ms``, and the bytes its upload copied
    (``upload``, from ``StreamPlanState.last_upload``). ``plan_key`` is the
    frame's host plan's key in the engine's ``PlanCache``."""

    stream: "StreamHandle | None" = None
    frame_no: int = -1
    ego_shift: tuple = (0, 0, 0)
    plan_info: dict | None = None
    plan_key: str | None = None

    # scheduler hooks: per-stream FIFO admission keys
    @property
    def _stream_key(self):
        return None if self.stream is None else self.stream.stream_id

    @property
    def _stream_frame(self) -> int:
        return self.frame_no


class StreamHandle:
    """Client view of one open stream on a :class:`SceneEngine`.

    ``submit(scene, ego_shift)`` queues the stream's next frame (frame
    numbers are assigned monotonically; admission keeps them FIFO within
    the stream even under an urgency policy) and returns the usual
    :class:`~repro_torch.serving.api.RequestHandle`. ``stats()`` reports
    the stream's plan-reuse counters."""

    def __init__(self, engine: "SceneEngine", state: StreamPlanState):
        self.engine = engine
        self.state = state
        self._next_frame = 0
        self._lock = ordered_lock("stream.handle")

    @property
    def stream_id(self) -> str:
        return self.state.stream_id

    def submit(self, scene: SparseVoxelTensor, ego_shift=(0, 0, 0), *,
               rid: int | None = None, **slo):
        """Queue the next frame of this stream; ``ego_shift`` is the ego
        translation (in voxels) since the *previous* submitted frame.
        SLO kwargs (tenant/priority/deadline_ms) pass through."""
        with self._lock:
            frame_no = self._next_frame
            self._next_frame += 1
        req = StreamFrameRequest(
            rid=frame_no if rid is None else rid, scene=scene,
            stream=self, frame_no=frame_no, ego_shift=tuple(ego_shift),
            **slo)
        return self.engine.submit(req)

    def stats(self) -> dict:
        """Aggregate plan-reuse stats: frames, reused/patched/rebuilt
        counts, mean overlap, mean host plan ms."""
        return self.state.stats()


def class_dtype(n_classes: int) -> torch.dtype:
    """The smallest integer dtype that holds every class index below
    ``n_classes``: the dtype a wave's classes travel to the host in."""
    for dtype in (torch.uint8, torch.int16, torch.int32):
        if n_classes - 1 <= torch.iinfo(dtype).max:
            return dtype
    return torch.int64


class SceneEngine(ServingBase):
    """Host-side batched scene driver (fixed shapes, plan-cached).

    ``model`` is a ``models.scn.SCNUNet`` on the engine's device.
    ``spec=None`` serves every scene on the reference backend; pass
    ``spec=build_plan_spec(rep_scenes, cfg)`` to serve SPADE's
    reference/SSpNNA mix at pinned tile budgets, or
    ``family=build_signature_family(rep_scenes, cfg)`` for bucketed
    serving, or ``layout=pin_halo(rep_scenes, cfg, ShardLayout(...))`` for
    sharded scenes; ``open_stream`` serves LiDAR streams on the batched
    mode.
    ``use_kernel`` (default on, as ``apply_unet``'s) runs tiled
    convs through the fused kernel. The engine serves on ``ctx.device``
    (the card unless the context says otherwise; without ``ctx`` the
    card). ``sync`` / ``depth`` / ``planner_threads`` / ``policy`` default
    to the context's.
    """

    def __init__(self, cfg, model, batch: int, spec: PlanSpec | None = None,
                 *, ctx: ExecutionContext | None = None,
                 layout: ShardLayout | None = None,
                 family: SignatureFamily | None = None,
                 policy: AdmissionPolicy | None = None,
                 backend: str = "auto", use_kernel: bool = True,
                 plan_cache_size: int | None = None,
                 order: str = "soar", soar_chunk: int = 512,
                 sync: bool | None = None, depth: int | None = None,
                 planner_threads: int | None = None, faults=None):
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
        if layout is not None:
            self._check_layout(layout, ctx, spec, family)
        self.cfg, self.model, self.batch, self.spec = cfg, model, batch, spec
        self.ctx, self.family, self.layout = ctx, family, layout
        self.backend, self.use_kernel = backend, use_kernel
        self._class_dtype = class_dtype(cfg.n_classes)
        self.cache = ctx.plan_cache
        self._topology = ctx.topology_key()
        #: the context registry's circuit breakers: contained dispatch and
        #: drain failures feed them and plan builds consult them
        self._breakers = ctx.registry.breakers
        # the table's and the board's generations are repr'd into every
        # cache key, so a winner flip or a breaker state change rotates
        # keys (and their hooks clear the cache)
        tuning = dict(breakers=self._breakers)
        if ctx.autotune is not None:
            tuning["autotune"] = ctx.autotune
        if family is not None:
            # per-bucket configs share the model; only the capacity differs
            self._bucket_cfgs = {
                cap: dataclasses.replace(cfg, capacity=cap)
                for cap in family.capacities}
            self._bucket_kw = {
                cap: dict(spec=family.spec_for(cap),
                          plan_tiles=family.spec_for(cap) is not None,
                          order=order, soar_chunk=soar_chunk, **tuning)
                for cap in family.capacities}
        elif layout is not None:
            self._plan_kw = dict(layout=layout)
        else:
            self._plan_kw = dict(spec=spec, plan_tiles=spec is not None,
                                 order=order, soar_chunk=soar_chunk, **tuning)
        # (capacity, plan signature) -> on the card, the buffers its graph
        # reads
        self._buckets: dict[tuple, dict] = {}
        self._streams: dict[str, StreamHandle] = {}
        self.graphs = Graphs(self.device) if self.device.type == "cuda" else None
        self.scheduler = WaveScheduler(
            batch=batch, plan=self._plan_stage, dispatch=self._dispatch_stage,
            drain=self._drain,
            sync=ctx.sync if sync is None else sync,
            depth=ctx.depth if depth is None else depth,
            planner_threads=(ctx.planner_threads if planner_threads is None
                             else planner_threads),
            policy=ctx.admission if policy is None else policy,
            bucket_of=((lambda r: getattr(r, "_bucket", None))
                       if family is not None else None),
            on_shed=self._on_shed,
            on_idle=self._make_idle_hook(ctx),
            faults=faults,
            on_wave_error=self._on_wave_error)

    @staticmethod
    def _check_layout(layout: ShardLayout, ctx, spec, family) -> None:
        """The JAX package's guards of the sharded mode: no ``spec=`` or
        ``family=``, a pinned halo budget, and a ctx mesh (if any) whose
        shard axis has the layout's size."""
        if family is not None:
            raise ValueError(
                "family= and layout= are mutually exclusive: sharded "
                "serving pins a single halo-budget signature")
        if spec is not None:
            raise ValueError(
                "spec= and layout= are mutually exclusive: sharded "
                "serving plans its own per-shard metadata")
        if layout.halo < 1:
            raise ValueError(
                "sharded serving needs a pinned halo budget for a single "
                "signature; pin one with engine.pin_halo")
        if ctx.mesh is not None:
            axes = mesh_axes(ctx.mesh)
            if axes.get(layout.axis) != layout.n_shards:
                raise ValueError(
                    f"layout needs mesh axis {layout.axis!r} of size "
                    f"{layout.n_shards}; ctx mesh has axes {axes}")

    # -- introspection -------------------------------------------------------

    @property
    def n_compilations(self) -> int:
        """Distinct (capacity, plan signature) pairs served so far, the
        JAX package's jit-cache count: on the card each is a captured CUDA
        graph."""
        return len(self._buckets)

    @staticmethod
    def graph_key(capacity: int, plan) -> tuple:
        """The key of the graph a wave of ``plan``'s signature at bucket
        ``capacity`` runs on (``graphs.launches(key)`` and the like)."""
        return capacity, plan_signature(plan)

    # -- streaming -----------------------------------------------------------

    def open_stream(self, stream_id: str | None = None, *,
                    min_overlap: float = 0.5,
                    wait_s: float = 5.0) -> StreamHandle:
        """Open a LiDAR stream: frames submitted through the returned
        :class:`StreamHandle` are planned *incrementally* — each frame
        diffs against the previous one (after ``ego_shift`` re-basing) and
        patches the cached host plan instead of rebuilding it, falling back
        to a full rebuild when voxel overlap drops below ``min_overlap``.
        Streams need the fixed-capacity batched mode: ``family=`` re-packs
        rows per bucket and ``layout=`` pins a sharded signature, which a
        per-stream canonical row layout cannot follow."""
        if self.family is not None or self.layout is not None:
            raise ValueError(
                "open_stream needs the fixed-capacity batched mode; "
                "family= and layout= engines cannot serve streams")
        if stream_id is not None and stream_id in self._streams:
            raise ValueError(f"stream {stream_id!r} is already open")
        state = StreamPlanState(
            self.cfg, cache=self.cache, spec=self.spec,
            plan_tiles=self._plan_kw["plan_tiles"],
            order=self._plan_kw["order"],
            soar_chunk=self._plan_kw["soar_chunk"],
            min_overlap=min_overlap, stream_id=stream_id,
            topology=self._topology, wait_s=wait_s, device=self.device)
        handle = StreamHandle(self, state)
        self._streams[state.stream_id] = handle
        return handle

    def serve_stream(self, frames, ego_shifts=None, *,
                     stream: StreamHandle | None = None,
                     min_overlap: float = 0.5,
                     **slo) -> list[StreamFrameRequest]:
        """Serve a whole sweep through one stream: submit every frame in
        order (``ego_shifts[i]`` is frame *i*'s ego translation since
        frame *i−1*), pump the queue, and return the fulfilled requests.
        Pass ``stream=`` to continue an already-open stream; otherwise a
        fresh one is opened with ``min_overlap``."""
        frames = list(frames)
        if ego_shifts is None:
            ego_shifts = [(0, 0, 0)] * len(frames)
        ego_shifts = [tuple(s) for s in ego_shifts]
        if len(ego_shifts) != len(frames):
            raise ValueError(
                f"{len(frames)} frames but {len(ego_shifts)} ego_shifts")
        if stream is None:
            stream = self.open_stream(min_overlap=min_overlap)
        handles = [stream.submit(t, shift, **slo)
                   for t, shift in zip(frames, ego_shifts)]
        self.serve()
        return [h.result() for h in handles]

    def _on_shed(self, req) -> None:
        # a shed (or terminally failed) stream frame must not wedge its
        # successors: advance the stream's frame gate (the next planned
        # frame rebuilds)
        if isinstance(req, StreamFrameRequest) and req.stream is not None:
            req.stream.state.skip_frame(req.frame_no)

    def _make_idle_hook(self, ctx):
        """Idle-gap re-profiling hook for the wave scheduler, or ``None``.

        Installed only when the context carries a cost table *and* a
        positive ``autotune_reprofile_ms`` budget. The scheduler calls it
        after a ``run`` drains the queue, on the serving thread between
        waves, so it never runs inside a graph capture."""
        table = ctx.autotune
        budget_ms = float(ctx.autotune_reprofile_ms or 0.0)
        if table is None or budget_ms <= 0.0:
            return None

        def _idle(scheduler) -> None:
            from repro_torch.engine.autotune import reprofile

            reprofile(table, registry=ctx.registry, ctx=ctx,
                      budget_ms=budget_ms)

        return _idle

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
        ``(key, host plan, features, stream state or None)`` carries the
        cache key, so dispatch never re-hashes the scene. Bucketed mode
        re-packs the scene to its bucket first (active rows in their order)
        and keeps the row mapping for the drain.

        Stream frames take the incremental path: ``StreamPlanState`` blocks
        until the stream's previous frame has been planned, diffs against
        it, and patches (or reuses) the cached host plan; features are
        re-packed into the stream's canonical row layout here so dispatch
        stays a plain upload."""
        if isinstance(req, StreamFrameRequest):
            scene = req.scene
            inj = self.scheduler.faults
            if inj is not None:
                # corrupt-frame seam: scribble garbage over the frame's
                # coords before planning — exercises the stream's
                # gap/rebuild recovery (and plan-stage containment when
                # the corruption makes the build raise)
                coords = host_array(scene.coords)
                corrupted = inj.corrupt_coords(coords, rid=req.rid)
                if corrupted is not coords:
                    scene = SparseVoxelTensor(corrupted, scene.feats,
                                              scene.mask)
            state = req.stream.state
            key, plan, frame_rows, info = state.plan_frame(
                scene, req.frame_no, req.ego_shift)
            req.plan_info, req.plan_key = info, key
            req._frame_rows = frame_rows
            req._backends = self._plan_backends(plan)
            feats = pack_stream_frame_np(frame_rows, host_array(scene.feats))
            return key, plan, feats, state
        if self.family is not None:
            cap = req._bucket
            scene, req._active_idx = compact_to_capacity(req.scene, cap)
            cfg, plan_kw = self._bucket_cfgs[cap], self._bucket_kw[cap]
        else:
            scene, cfg, plan_kw = req.scene, self.cfg, self._plan_kw
        key = self.cache.key_for(scene, cfg, topology=self._topology,
                                 **plan_kw)
        builder = (build_sharded_scene_plan_host if self.layout is not None
                   else None)
        plan = self.cache.get_or_build(scene, cfg, device=False, key=key,
                                       builder=builder, **plan_kw)
        req._backends = self._plan_backends(plan)
        return key, plan, scene.feats, None

    @staticmethod
    def _plan_backends(plan) -> tuple:
        """Non-reference backends this plan dispatches to — the circuit
        breakers a failure of the request's wave is attributed to (when
        the exception itself doesn't name one)."""
        names = set()
        for info in plan.stats or ():
            name = getattr(info.get("dispatch"), "backend", None)
            if name is not None and name != REFERENCE:
                names.add(name)
        return tuple(sorted(names))

    def _on_wave_error(self, exc, reqs, stage: str) -> None:
        """Contained-wave-failure observer (scheduler ``on_wave_error``):
        attribute dispatch/drain failures to backend circuit breakers —
        the exception's ``backend`` attribute when it names one (e.g. an
        injected ``DeviceFaultError``), else every non-reference backend
        the wave's plans dispatch to."""
        board = self._breakers
        if stage not in ("dispatch", "drain"):
            return
        name = getattr(exc, "backend", None)
        names = ((name,) if name else
                 sorted({b for r in reqs
                         for b in getattr(r, "_backends", ())}))
        for n in names:
            board.record_failure(n)

    @torch.inference_mode()
    def _dispatch_stage(self, reqs: list[SceneRequest], payloads, stats):
        """The wave's device work, enqueued -> its logits and classes on
        the device."""
        with stats.span("scene.upload"):
            # the plan stage built (and counted) these host plans; adopt
            # fetches the memoized upload without rebuilding or counting.
            # Stream frames upload through their StreamPlanState's per-leaf
            # identity memo instead, so a patched frame copies only the
            # tables it changed.
            plans = []
            for r, (key, host, _, state) in zip(reqs, payloads):
                if state is None:
                    plans.append(self.cache.adopt(key, host,
                                                  device=self.device))
                else:
                    plans.append(state.device_plan(host))
                    r.plan_info["upload"] = dict(state.last_upload)
            if self.layout is None:
                feats, cap = self._upload_feats(reqs, payloads, stats)
        if self.layout is None:
            return self.run_wave(feats, plans, cap,
                                 rids=[r.rid for r in reqs],
                                 notes=stats.notes, stats=stats)
        with stats.span("scene.replay"):
            out = self._classify(self._sharded_wave(reqs, plans, stats))
            stats.pending["done"] = timing_event(self.device)
        return out

    def _upload_feats(self, reqs, payloads, stats) -> tuple:
        """A batched or bucketed wave's features on the device, and its
        bucket's capacity."""
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
        s_infos = [r.plan_info for r in reqs
                   if isinstance(r, StreamFrameRequest)]
        if s_infos:
            for mode in ("reused", "patched", "rebuilt"):
                stats.notes[f"stream_{mode}"] = sum(
                    1 for i in s_infos if i["mode"] == mode)
            stats.notes["stream_overlap"] = float(
                sum(i["overlap"] for i in s_infos) / len(s_infos))
            stats.notes["stream_plan_ms"] = float(
                sum(i["plan_ms"] for i in s_infos))
        dtype = self.model.head.w.dtype
        feats = [torch.as_tensor(f, dtype=dtype, device=self.device)
                 for _, _, f, _ in payloads]
        return feats, cap

    def _apply(self, feats, plan, mark=None) -> torch.Tensor:
        return engine_api.apply_unet(
            self.model, feats, plan, backend=self.backend,
            registry=self.ctx.registry, use_kernel=self.use_kernel,
            device=self.device, ctx=self.ctx, mark=mark)

    def _classify(self, logits: torch.Tensor) -> tuple:
        """``(logits, classes)``: each row's argmax (the first of tied
        maxima, as numpy's), in the engine's narrow class dtype."""
        return logits, logits.argmax(-1).to(self._class_dtype)

    def _sharded_wave(self, reqs, plans, stats) -> torch.Tensor:
        """A sharded wave: each scene's sharded forward, eagerly, after
        checking that its plan has the pinned layout's one signature ->
        logits ``(batch * capacity, n_classes)`` (zero rows for the
        wave's empty slots)."""
        for r, p in zip(reqs, plans):
            key = ("sharded", p.signature())
            if not self._buckets:
                self._buckets[key] = {}
            elif key not in self._buckets:
                raise RuntimeError(
                    f"scene {r.rid}: sharded plan signature diverged from "
                    "the pinned layout (capacity mismatch or a re-pinned "
                    "halo budget?); re-pin with engine.pin_halo")
        stats.notes["plan_shards"] = self.layout.n_shards
        stats.notes["plan_builds"] = len(plans)
        stats.notes["halo_rows"] = sum(p.halo_rows() for p in plans)
        dtype = self.model.head.w.dtype
        out = [self._apply(torch.as_tensor(r.scene.feats, dtype=dtype,
                                           device=self.device), p)
               for r, p in zip(reqs, plans)]
        out += [torch.zeros_like(out[0])] * (self.batch - len(out))
        return torch.cat(out)

    @torch.inference_mode()
    def run_wave(self, feats: list, plans: list, capacity: int, *,
                 rids=None, notes: dict | None = None,
                 stats=None) -> tuple:
        """Logits ``(batch * capacity, n_classes)`` and classes
        ``(batch * capacity,)`` (``_classify``) of one wave: up to
        ``batch`` scenes' features (on the device) and uploaded plans, all
        of bucket ``capacity`` and of one plan signature; a short wave is
        padded with the first scene's plan and zero features. On the CPU
        the forward runs eagerly; on the card it is a replay of the graph
        of (``capacity``, the plans' signature), captured on that pair's
        first wave, and ``notes["graph_launches"]`` receives the kernel
        launches it ran. A plan whose signature differs from the wave's
        raises. With ``stats`` (the wave's ``WaveStats``) the staging and
        the replay are its spans ``scene.stage`` and ``scene.replay``."""
        if stats is None:
            return self._replay(*self._stage(feats, plans, capacity, rids),
                                notes=notes)
        with stats.span("scene.stage"):
            staged = self._stage(feats, plans, capacity, rids)
        with stats.span("scene.replay"):
            return self._replay(*staged, notes=notes, stats=stats)

    def _stage(self, feats: list, plans: list, capacity: int,
               rids=None) -> tuple:
        """Check a wave (``run_wave``) and put its padded plans and
        features where its forward reads them -> ``(graph key, buffers)``:
        on the card the bucket's buffers (filled in place once its graph
        exists), on the CPU the stacked wave."""
        rids = list(range(len(plans))) if rids is None else rids
        want = (capacity, self.model.stem.weight.shape[1])
        for rid, f in zip(rids, feats):
            if tuple(f.shape) != want:
                raise ValueError(f"scene {rid}: features {tuple(f.shape)}, "
                                 f"the bucket takes {want}")
        key = self.graph_key(capacity, plans[0])
        sig = key[1]
        for rid, p in zip(rids, plans):
            if plan_signature(p) != sig:
                raise RuntimeError(
                    f"scene {rid}: plan signature diverged from the wave "
                    "(tile-budget overflow?); raise tile_margin in "
                    "build_plan_spec")
        bucket = self._buckets.setdefault(key, {})
        plans, feats = list(plans), list(feats)
        while len(plans) < self.batch:  # pad the wave to fixed batch
            plans.append(plans[0])
            feats.append(torch.zeros_like(feats[0]))
        if self.graphs is None:
            return key, {"plan": stack_plans(plans), "feats": torch.cat(feats)}
        if key not in self.graphs:
            bucket["plan"] = stack_plans(plans)
            bucket["feats"] = torch.cat(feats)
        else:
            stack_plans(plans, out=bucket["plan"])
            torch.cat(feats, out=bucket["feats"])
        return key, bucket

    def _replay(self, key, bucket: dict, *, notes: dict | None = None,
                stats=None) -> tuple:
        """The forward and classes (``_classify``) of a staged wave
        (``_stage``): eagerly on the CPU, else the replay of ``key``'s
        graph, captured first if new. With ``stats``, the replay's timing
        events go to ``stats.pending``."""
        notes = {} if notes is None else notes
        notes["graph_launches"] = {}

        def forward(mark=None) -> tuple:
            return self._classify(
                self._apply(bucket["feats"], bucket["plan"], mark))

        if self.graphs is None:
            return forward()
        if key not in self.graphs:
            forward()  # warm-up
            marks = []

            def mark(name: str) -> None:
                marks.append((name, timing_event(self.device, external=True)))

            self.graphs.capture(key, lambda: forward(mark))
            bucket["marks"] = marks
        start = timing_event(self.device)
        out = self.graphs.replay(key)
        end = timing_event(self.device)
        notes["graph_launches"] = dict(self.graphs.launches(key))
        # copies: the next wave's replay overwrites the graph's outputs
        out = tuple(t.clone() for t in out)
        if stats is not None:
            stats.pending.update(start=start, end=end, marks=bucket["marks"],
                                 replays=self.graphs.replays,
                                 done=timing_event(self.device))
        return out

    def _read_events(self, stats) -> None:
        """The wave's device ms from its events (``event_ms``), once the
        drain has waited on the last of them."""
        p = stats.pending
        if p.get("start") is None:
            return
        stats.event_ms["forward"] = p["start"].elapsed_time(p["end"])
        marks = p["marks"]
        if not marks or self.graphs.replays != p["replays"]:
            return  # a later replay has re-recorded the graph's events
        prev = marks[0][1]
        for name, ev in marks[1:]:
            seg = (name if name in ("rows", "stem", "head")
                   else f"level{name[3:]}")
            stats.event_ms[seg] = (stats.event_ms.get(seg, 0.0)
                                   + prev.elapsed_time(ev))
            prev = ev

    def _drain(self, reqs: list[SceneRequest], out, stats) -> None:
        """The scheduler's drain: wait for the wave, copy its logits and
        then its classes (the device's argmax, ``_classify``) to the host,
        finish its requests (``_drain_stage``)."""
        with stats.span("scene.wait"):
            done = stats.pending.get("done")
            if done is not None:
                done.synchronize()
            self._read_events(stats)
        with stats.span("scene.readback"):
            logits, pred = (t.cpu().numpy() for t in out)
            stats.readback_bytes += logits.nbytes + pred.nbytes
        stats.notes["pred_device_rows"] = pred.size
        with stats.span("scene.finish"):
            self._drain_stage(reqs, (logits, pred))

    def _drain_stage(self, reqs: list[SceneRequest], out) -> None:
        """Each request's logits and classes (``int64``) from the wave's
        ``out = (logits, classes)`` on the host."""
        logits, pred = out
        n_classes = logits.shape[-1]
        logits = logits.reshape(self.batch, -1, n_classes)
        # widened into one array for the wave: numpy asks the kernel for
        # huge pages for a large array, so this faults in far fewer pages
        # than an array a request would
        pred = pred.astype(np.int64).reshape(self.batch, -1)
        for i, r in enumerate(reqs):
            if isinstance(r, StreamFrameRequest):
                # the stream's canonical rows back to the caller's rows
                dst = r._frame_rows >= 0
                src = r._frame_rows[dst]
            elif self.family is not None:
                # the bucket's rows back to the request's rows
                dst = r._active_idx
                src = slice(len(dst))
            else:
                r.logits, r.pred = logits[i], pred[i]
                r.done = True
                continue
            # the other rows stay zero-logit, of class 0 (numpy's argmax of
            # a zero row)
            r.logits = np.zeros((r.scene.capacity, n_classes), logits.dtype)
            r.logits[dst] = logits[i][src]
            r.pred = np.zeros(r.scene.capacity, np.int64)
            r.pred[dst] = pred[i][src]
            r.done = True
        # a drained wave is a success for every backend it exercised: closes
        # HALF_OPEN probes and resets consecutive-failure counts
        for n in sorted({b for r in reqs for b in r._backends}):
            self._breakers.record_success(n)

    def _health_extra(self) -> dict:
        return {"breakers": self._breakers.states()}
