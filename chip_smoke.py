#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA card.

    python3 chip_smoke.py

1. Prints the card's name and power limit, turns TF32 off, and builds the
   CUDA kernels from ``src/repro_torch/kernels/csrc`` with nvcc, one
   process per source, all at once.
2. Holds the fused SSpNNA kernel against its plain PyTorch version on random
   tile tables (holes, dead tiles, pad slots, C=4, N=48, C and N not
   multiples of 4).
3. Drives the SCN path three times: the U-Net at its published widths
   (16, 32, 48, 64; two blocks per level; 20 classes) with random weights
   from a seeded generator, on ScanNet-scale synthetic rooms (resolution
   256, capacity 131072, seeds 0-2): host plan, upload, ``apply_unet`` with
   ``backend="auto"``. The kernel's launch count must equal the number of
   convs the planner sent to ``sspnna``, and the logits must match the same
   plan run with ``backend="reference"``.
4. Replays every SSpNNA launch of seed 0's forward against the plain
   version at its real inputs, and times kernel, plain version and the
   end-to-end forward with CUDA events / synchronized host clocks.
5. Holds the flash attention kernel against its plain version on random
   q, k, v (``kernels/flash/ref.FLASH_CASES``: causal and not, sq < skv,
   windows, softcaps, D 32-256, f32 and bf16, GQA groups 1 and 2, ragged
   lengths).
6. Drives the LM serving path: Gemma-2 2B at its published widths (26
   layers, d_model 2304, 8/4 heads of 256, d_ff 9216, vocab 256000, window
   4096, softcaps 50 and 30), bf16, random weights from
   ``torch.Generator().manual_seed(0)``. An ``Engine`` (batch 2, prompt
   length 6144, 16 new tokens) serves four ``TokenStream`` prompts in two
   waves, once with ``sync=True`` and once with ``sync=False``: each wave's
   prefill must launch the kernel once per layer, the tokens of both runs
   must be equal, and each wave's last-position logits must match the same
   weights with the attention's plain version, in f32 (the weights cast up)
   and in bf16 (first tokens equal).
7. Replays every flash launch of one wave's prefill against the plain
   version and times kernel, plain version and bound; at the global-layer
   shape it also times the kernel without softcap beside
   ``scaled_dot_product_attention`` (a yardstick the port never calls).
   Then times one wave's prefill and its decode steps.

Each path runs with every launch count set to 0 just before it and read
just after. Prints each phase's seconds. Exits non-zero on any failure, and
when no card is present. The line before the last is a JSON object with
the kernels' numbers; the last line is ``{"ok": true, "device": {...}}``.
"""
from __future__ import annotations

import dataclasses
import json
import statistics
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

import numpy as np  # noqa: E402
import torch  # noqa: E402

# published peaks of one H100 SXM (NVIDIA data sheet; the card's power limit
# is printed beside every measurement)
PEAK_FP32_FLOPS = 67e12
PEAK_BF16_FLOPS = 989e12
PEAK_BYTES_PER_S = 3.35e12
# f32 sums of up to K*C = 27*96 products, taken in another order than the
# plain version's matmul
KERNEL_TOL = 1e-4
# end-to-end: 17 convs, each followed by a BatchNorm that divides by the
# per-channel std, so per-conv reorderings of ~1e-6 grow layer by layer
LOGITS_TOL = 1e-3
SEEDS = (0, 1, 2)
RESOLUTION, CAPACITY, POINTS_PER_UNIT = 256, 131072, 2e6
DEVICE = "cuda"
# the LM path: Gemma-2 2B at full width, one engine shape, four prompts of
# lengths above the 4096 window (left-padded to PROMPT_LEN with token 0)
LM_ARCH, BATCH, PROMPT_LEN, MAX_NEW = "gemma2-2b", 2, 6144, 16
PROMPT_LENS = (6144, 5120, 6144, 4500)
# last-position logits (f32, softcapped at 30) of the kernel's prefill
# against the same weights with the attention's plain version, max
# |got - want| / max(|want|, 1). In f32 (the weights cast up) the two differ
# only by the order of f32 sums in 26 attention layers: 1e-3. In bf16, the
# working dtype, each layer rounds the residual stream, the attention output
# and (in the kernel only) p to bf16, and 26 layers of random weights carry
# those roundings on; so the kernel may move the bf16 logits at most
# LM_BF16_FACTOR times as far as bf16 itself moves the plain path's logits
# from its f32 evaluation, which the run measures beside it.
LM_F32_TOL = 1e-3
LM_BF16_FACTOR = 2.0


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise RuntimeError(msg)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60).stdout
    return out.strip().splitlines()[0]


def max_err(got: torch.Tensor, want: torch.Tensor) -> tuple[float, float]:
    """(max abs error, max of abs error / max(|want|, 1))."""
    diff = (got - want).abs()
    return float(diff.max()), float((diff / want.abs().clamp(min=1.0)).max())


def time_ms(fn, reps: int) -> float:
    """Median device time of ``fn`` over ``reps`` launches (CUDA events,
    after one warm-up call)."""
    fn()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def host_ms(fn, reps: int) -> float:
    """Median wall time of ``fn`` ending in a device synchronize."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times)


def sspnna_bound(feats, weights, out_rows, in_rows, local_idx, counts, n_out):
    """Least time (ms) the card could take for one launch's work, and what
    bounds it: the FLOPs of the pairs this plan holds over the fp32 peak,
    against the bytes the function must move (each referenced input row,
    the weights and the tables read once, the output written once) over the
    memory rate."""
    c, n = feats.shape[1], weights.shape[2]
    live = counts > 0
    flops = 2.0 * float(counts.sum()) * c * n
    rows_in = int(torch.unique(in_rows[live]).numel())
    nbytes = 4.0 * (rows_in * c + weights.numel() + out_rows.numel()
                    + in_rows.numel() + local_idx.numel() + counts.numel()
                    + n_out * n)
    t_ops, t_bytes = flops / PEAK_FP32_FLOPS, nbytes / PEAK_BYTES_PER_S
    return max(t_ops, t_bytes) * 1e3, ("operations" if t_ops > t_bytes else "bytes")


def leaves(tree):
    """The tensors of a parameter tree (dicts and lists of tensors)."""
    if isinstance(tree, (dict, list)):
        for x in (tree.values() if isinstance(tree, dict) else tree):
            yield from leaves(x)
    else:
        yield tree


def to_float32(tree):
    """A copy of a parameter tree (dicts and lists of tensors) in f32."""
    if isinstance(tree, dict):
        return {k: to_float32(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [to_float32(v) for v in tree]
    return tree.float()


def flash_bound(q, k, v, causal, window):
    """Least time (ms) for one attention launch, and what bounds it: 4*D
    FLOPs per unmasked (q, k) pair and query head over the bf16 dense peak,
    against Q, K, V read once and O written once over the memory rate."""
    from repro_torch.kernels.flash.ref import attention_mask

    b, sq, hq, d = q.shape
    pairs = int(attention_mask(sq, k.shape[1], causal=causal, window=window,
                               device=q.device).sum())
    flops = 4.0 * d * pairs * b * hq
    nbytes = float(q.element_size() * (2 * q.numel() + k.numel() + v.numel()))
    t_ops, t_bytes = flops / PEAK_BF16_FLOPS, nbytes / PEAK_BYTES_PER_S
    return max(t_ops, t_bytes) * 1e3, ("operations" if t_ops > t_bytes else "bytes")


class Phases:
    """Prints the seconds each phase of the run took."""

    def __init__(self):
        self.name, self.t0 = None, 0.0

    def __call__(self, name: str) -> None:
        self.end()
        self.name, self.t0 = name, time.perf_counter()

    def end(self) -> None:
        if self.name is not None:
            print(f"phase {self.name}: {time.perf_counter() - self.t0:.1f} s",
                  flush=True)
        self.name = None


def scn_path(dev: torch.device, phase: Phases) -> dict:
    """Phases 2-4: ``sspnna_fused`` on random tables, the SCN forward on
    three scenes, and the replay of seed 0's launches. Returns the kernel's
    JSON entry."""
    from repro_torch import engine
    from repro_torch.data.scenes import make_scene
    from repro_torch.kernels.flash.flash import flash_attention
    from repro_torch.kernels.sspnna import ops, sspnna
    from repro_torch.kernels.sspnna.ref import random_tile_tables
    from repro_torch.models.scn import SCNUNet, UNetConfig, miou
    from repro_torch.sparse.tensor import SparseVoxelTensor

    fused, plain = sspnna.sspnna_fused, sspnna.sspnna_fused_plain

    phase("sspnna random tables")
    worst_abs = 0.0
    rng = np.random.default_rng(0)
    for v, c, n, t, d_i, d_o in [(96, 4, 48, 7, 32, 8), (16384, 16, 16, 24, 160, 512),
                                 (4096, 96, 48, 60, 64, 32), (512, 32, 64, 20, 4, 1),
                                 (8192, 6, 18, 30, 48, 300)]:
        args = [torch.from_numpy(a).to(dev) for a in random_tile_tables(
            rng, v=v, c=c, n=n, t=t, d_i=d_i, d_o=d_o)]
        got, want = fused(*args, n_out=v), plain(*args, n_out=v)
        torch.cuda.synchronize()
        abs_err, rel_err = max_err(got, want)
        dead = int((args[5] == 0).sum())
        print(f"random tables V={v} C={c} N={n} T={t} dI={d_i} dO={d_o} "
              f"dead={dead}: max abs {abs_err:.3g} rel {rel_err:.3g} "
              f"(tol {KERNEL_TOL})")
        check(rel_err <= KERNEL_TOL, "kernel disagrees with its plain version")
        worst_abs = max(worst_abs, abs_err)

    phase("SCN path")
    cfg = UNetConfig(resolution=RESOLUTION, capacity=CAPACITY)
    model = SCNUNet(cfg, device=dev, generator=torch.Generator().manual_seed(0))
    requests = []
    for seed in SEEDS:
        coords, feats, labels, mask = make_scene(seed, RESOLUTION, CAPACITY,
                                                 points_per_unit=POINTS_PER_UNIT)
        t0 = time.perf_counter()
        host = engine.build_scene_plan_host(
            SparseVoxelTensor(coords, feats, mask), cfg)
        plan_s = time.perf_counter() - t0
        levels = ", ".join(
            f"L{s['level']} {s['n_active']} {s['dispatch'].backend}"
            + (f" (dO={s['dispatch'].delta_o} dI={s['dispatch'].delta_i} "
               f"T={s['dispatch'].n_tiles})"
               if s['dispatch'].backend == engine.SSPNNA else "")
            for s in host.stats)
        print(f"scene {seed}: {int(mask.sum())} active voxels, host plan "
              f"{plan_s:.1f} s: {levels}")
        requests.append((seed, feats, labels, mask, host))

    def sspnna_convs(plan) -> int:
        """Convs of one forward that the planner sent to the kernel."""
        n = 0
        for li, lvl in enumerate(plan.levels):
            if lvl.sub.dispatch.backend == engine.SSPNNA and lvl.sub.tiles is not None:
                n += ((li == 0) + cfg.reps
                      + (cfg.reps if li < len(plan.levels) - 1 else 0))
        return n

    fused.launches = flash_attention.launches = 0
    uploaded = {}
    with torch.inference_mode():
        for seed, feats, labels, mask, host in requests:
            plan = engine.upload_scene_plan(host, dev)
            uploaded[seed] = plan
            expected = sspnna_convs(plan)
            before = fused.launches
            logits = engine.apply_unet(model, feats, plan, device=dev)
            torch.cuda.synchronize()
            launched = fused.launches - before
            ref = engine.apply_unet(model, feats, plan, backend="reference",
                                    device=dev)
            torch.cuda.synchronize()
            check(fused.launches - before == launched,
                  "the reference backend launched the kernel")
            check(logits.shape == (CAPACITY, cfg.n_classes),
                  f"logits shape {tuple(logits.shape)}")
            check(bool(torch.isfinite(logits).all()), "non-finite logits")
            abs_err, rel_err = max_err(logits, ref)
            pred = logits.argmax(-1).cpu().numpy()
            agree = float((pred == ref.argmax(-1).cpu().numpy())[mask].mean())
            print(f"request seed={seed}: sspnna launches {launched} "
                  f"(planned {expected}); logits vs reference max abs "
                  f"{abs_err:.3g} rel {rel_err:.3g} (tol {LOGITS_TOL}); argmax "
                  f"agreement {agree:.6f}; mIoU vs labels (random weights) "
                  f"{miou(pred, labels, mask, cfg.n_classes):.4f}")
            check(launched == expected and launched > 0,
                  f"kernel launched {launched} times for {expected} sspnna convs")
            check(rel_err <= LOGITS_TOL, "auto and reference logits disagree")
    total_launches = fused.launches
    check(flash_attention.launches == 0, "the SCN path launched flash")

    phase("SCN replay")
    calls = []

    def record(*args, **kw):
        calls.append((args, kw))
        return fused(*args, **kw)

    seed0, feats0 = requests[0][0], requests[0][1]
    plan0 = uploaded[seed0]
    ops.sspnna_fused = record
    try:
        with torch.inference_mode():
            engine.apply_unet(model, feats0, plan0, device=dev)
    finally:
        ops.sspnna_fused = fused
    rows = []  # one per launch: level, kernel ms, plain ms, bound ms, bound by
    with torch.inference_mode():
        for i, (args, kw) in enumerate(calls):
            got, want = fused(*args, **kw), plain(*args, **kw)
            abs_err, rel_err = max_err(got, want)
            check(rel_err <= KERNEL_TOL, f"launch {i}: kernel disagrees")
            worst_abs = max(worst_abs, abs_err)
            ms = time_ms(lambda: fused(*args, **kw), 20)
            pms = time_ms(lambda: plain(*args, **kw), 5)
            b_ms, b_by = sspnna_bound(*args, kw["n_out"])
            feats, weights, out_rows, in_rows, local_idx, counts = args
            t, d_o, _ = local_idx.shape
            level = next(li for li, lvl in enumerate(plan0.levels)
                         if lvl.sub.tiles is not None
                         and lvl.sub.tiles.local_idx is local_idx)
            print(f"launch {i} L{level} C={feats.shape[1]} N={weights.shape[2]} "
                  f"T={t} dO={d_o} dI={in_rows.shape[1]} "
                  f"pairs={int(counts.sum())}: kernel {ms:.4f} ms, plain "
                  f"{pms:.4f} ms, bound {b_ms:.4f} ms ({b_by}), max abs "
                  f"{abs_err:.3g}")
            rows.append((level, ms, pms, b_ms, b_by))
    for level in sorted({r[0] for r in rows}):
        mine = [r for r in rows if r[0] == level]
        print(f"level {level}: {len(mine)} launches, kernel "
              f"{sum(r[1] for r in mine):.4f} ms, plain "
              f"{sum(r[2] for r in mine):.4f} ms, bound "
              f"{sum(r[3] for r in mine):.4f} ms per forward")
    by_bytes = sum(r[3] for r in rows if r[4] == "bytes")
    by_ops = sum(r[3] for r in rows if r[4] == "operations")

    with torch.inference_mode():
        fwd_auto = host_ms(lambda: engine.apply_unet(
            model, feats0, plan0, device=dev), 5)
        fwd_ref = host_ms(lambda: engine.apply_unet(
            model, feats0, plan0, backend="reference", device=dev), 5)
    print(f"forward seed={seed0}: auto {fwd_auto:.3f} ms, reference "
          f"{fwd_ref:.3f} ms (median of 5, host clock after synchronize); "
          f"peak memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    return {
        "name": "sspnna_fused",
        "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/sspnna_fused.cu",
        "replaces": "src/repro/kernels/sspnna/sspnna.py:151",
        "launches": total_launches,
        "max_abs_err": worst_abs,
        # times and bound summed over the launches of one forward (seed 0)
        "ms": sum(r[1] for r in rows),
        "plain_ms": sum(r[2] for r in rows),
        "bound_ms": by_bytes + by_ops,
        "bound_by": "bytes" if by_bytes >= by_ops else "operations",
        "library_ms": None,
    }


def lm_path(dev: torch.device, phase: Phases) -> dict:
    """Phases 5-7: the flash kernel on random shapes, Gemma-2 2B served at
    full width, and the replay of one wave's launches. Returns the kernel's
    JSON entry."""
    from repro_torch.configs import get_config
    from repro_torch.data.tokens import TokenStream
    from repro_torch.kernels.flash.flash import (
        flash_attention,
        flash_attention_plain,
    )
    from repro_torch.kernels.flash.ref import FLASH_CASES, FLASH_TOL, random_qkv
    from repro_torch.kernels.sspnna.sspnna import sspnna_fused
    from repro_torch.models import attention, transformer
    from repro_torch.serving.engine import Engine, Request, make_prefill, make_serve_step

    phase("flash random shapes")
    worst_abs = 0.0
    rng = np.random.default_rng(0)
    for b, sq, skv, hq, hkv, d, causal, window, cap, dt in FLASH_CASES:
        q, k, v = (x.to(dev) for x in random_qkv(
            rng, b=b, sq=sq, skv=skv, hq=hq, hkv=hkv, d=d, dtype=dt))
        kw = dict(causal=causal, window=window, softcap=cap)
        got = flash_attention(q, k, v, **kw)
        want = flash_attention_plain(q, k, v, **kw)
        torch.cuda.synchronize()
        abs_err, rel_err = max_err(got.float(), want.float())
        print(f"flash B={b} Sq={sq} Skv={skv} H={hq}/{hkv} D={d} "
              f"causal={causal} window={window} softcap={cap} "
              f"{str(dt).removeprefix('torch.')}: max abs {abs_err:.3g} rel "
              f"{rel_err:.3g} (tol {FLASH_TOL[dt]})")
        check(rel_err <= FLASH_TOL[dt], "flash kernel disagrees with its "
              "plain version")
        worst_abs = max(worst_abs, abs_err)

    phase("LM init")
    cfg = get_config(LM_ARCH)
    published = (26, 2304, 8, 4, 256, 9216, 256000, 4096, 50.0, 30.0)
    check((cfg.n_layers, cfg.d_model, cfg.n_heads, cfg.n_kv_heads,
           cfg.head_dim, cfg.d_ff, cfg.vocab_size, cfg.window,
           cfg.attn_softcap, cfg.final_softcap) == published,
          f"{LM_ARCH} is not at its published widths")
    check(cfg.torch_dtype == torch.bfloat16, "the LM path runs in bf16")
    torch.cuda.reset_peak_memory_stats()
    params = transformer.init_lm(cfg, device=dev,
                                 generator=torch.Generator().manual_seed(0))
    n_params = sum(p.numel() for p in leaves(params))
    stream = TokenStream(cfg.vocab_size, len(PROMPT_LENS), PROMPT_LEN, seed=0)
    tokens = next(stream)["tokens"]
    prompts = [tokens[i, :n] for i, n in enumerate(PROMPT_LENS)]
    print(f"{LM_ARCH}: {n_params / 1e9:.3f} B parameters in bf16, "
          f"{cfg.n_layers} layers {cfg.attn_pattern}, prompts of "
          f"{PROMPT_LENS} tokens in slots of {PROMPT_LEN}, batch {BATCH}, "
          f"{MAX_NEW} new tokens each")

    phase("LM serving")

    def serve(sync: bool):
        eng = Engine(cfg, params, BATCH, PROMPT_LEN, MAX_NEW, sync=sync,
                     device=dev)
        waves = []   # (tokens, last-position logits, flash launches)
        inner = eng.prefill

        def prefill(p, toks):
            before = flash_attention.launches
            logits, cache = inner(p, toks)
            waves.append((toks, logits, flash_attention.launches - before))
            return logits, cache

        eng.prefill = prefill
        handles = eng.submit([Request(i, p, max_new=MAX_NEW)
                              for i, p in enumerate(prompts)])
        t0 = time.perf_counter()
        eng.serve()
        torch.cuda.synchronize()
        wall_s = time.perf_counter() - t0
        out = {h.request.rid: h.result().out for h in handles}
        eng.close()
        return out, waves, wall_s

    flash_attention.launches = sspnna_fused.launches = 0
    by_sync, waves, sync_s = serve(sync=True)
    by_async, async_waves, async_s = serve(sync=False)
    total_launches = flash_attention.launches
    check(sspnna_fused.launches == 0, "the LM path launched sspnna_fused")
    n_new = sum(len(o) for o in by_sync.values())
    for name, w, s in (("sync", waves, sync_s), ("async", async_waves, async_s)):
        print(f"serve sync={name == 'sync'}: {len(w)} waves, flash launches "
              f"per wave {[n for _, _, n in w]}, {s:.3f} s, "
              f"{n_new / s:.2f} new tokens/s, "
              f"{sum(PROMPT_LENS) / s:.1f} prompt tokens/s")
        check(len(w) == len(prompts) // BATCH, f"{len(w)} waves")
        check(all(n == cfg.n_layers for _, _, n in w),
              "a wave's prefill did not launch the kernel once per layer")
    print(f"tokens sync={by_sync}")
    check(by_sync == by_async, "sync and async serving emitted other tokens")
    check(all(len(o) == MAX_NEW and all(0 <= t < cfg.vocab_size for t in o)
              for o in by_sync.values()), "emitted tokens out of range")

    # the same weights with the attention's plain version
    prefill = make_prefill(cfg, cache_pad=MAX_NEW)
    step = make_serve_step(cfg)

    def greedy(logits, cache) -> torch.Tensor:
        """MAX_NEW greedy tokens (B, MAX_NEW) from a prefill's output."""
        tok = logits[:, :cfg.vocab_size].argmax(-1).to(torch.int32)[:, None]
        out = [tok]
        for _ in range(MAX_NEW - 1):
            nxt, _, cache = step(params, tok, cache)
            tok = nxt[:, None]
            out.append(tok)
        return torch.cat(out, 1)

    cfg32 = dataclasses.replace(cfg, dtype="float32")
    params32 = to_float32(params)
    prefill32 = make_prefill(cfg32, cache_pad=MAX_NEW)
    kernel_bshd = attention.flash_attention_bshd
    with torch.inference_mode():
        for wi, (toks, logits, _) in enumerate(waves):
            before = flash_attention.launches
            attention.flash_attention_bshd = flash_attention_plain
            try:
                want, cache = prefill(params, toks)
                plain_tokens = greedy(want, cache).tolist()
                del cache
                want32 = prefill32(params32, toks)[0]
            finally:
                attention.flash_attention_bshd = kernel_bshd
            torch.cuda.synchronize()
            check(flash_attention.launches == before,
                  "the plain prefill launched the kernel")
            got32 = prefill32(params32, toks)[0]
            check(bool(torch.isfinite(logits).all())
                  and logits.shape == (BATCH, cfg.vocab_padded),
                  "prefill logits not finite or of the wrong shape")
            _, err32 = max_err(got32, want32)
            _, err = max_err(logits, want)
            _, noise = max_err(want, want32)
            first = logits[:, :cfg.vocab_size].argmax(-1).tolist()
            plain_first = [t[0] for t in plain_tokens]
            rids = range(wi * BATCH, (wi + 1) * BATCH)
            later = [sum(a == b for a, b in zip(by_sync[r][1:], t[1:]))
                     for r, t in zip(rids, plain_tokens)]
            print(f"wave {wi}: last-position logits, kernel vs plain "
                  f"attention: f32 rel {err32:.3g} (tol {LM_F32_TOL}), bf16 "
                  f"rel {err:.3g} (tol {LM_BF16_FACTOR} x {noise:.3g}, the "
                  f"plain path's bf16 vs f32); first tokens {first} plain "
                  f"{plain_first}; later tokens equal to the plain path's: "
                  f"{later} of {MAX_NEW - 1}")
            check(err32 <= LM_F32_TOL,
                  "f32 prefill logits disagree with the plain attention")
            check(err <= LM_BF16_FACTOR * noise,
                  "bf16 prefill logits disagree with the plain attention")
            check(first == plain_first and first == [
                by_sync[r][0] for r in rids], "first tokens disagree")
    del params32

    phase("flash replay")
    calls = []

    def record(q, k, v, **kw):
        calls.append((q, k, v, kw))
        return kernel_bshd(q, k, v, **kw)

    toks0 = waves[0][0]
    attention.flash_attention_bshd = record
    try:
        with torch.inference_mode():
            prefill(params, toks0)
    finally:
        attention.flash_attention_bshd = kernel_bshd
    check(len(calls) == cfg.n_layers, f"{len(calls)} flash calls")
    rows = []   # per launch: kernel ms, plain ms, bound ms, bound by
    with torch.inference_mode():
        for i, (q, k, v, kw) in enumerate(calls):
            got = flash_attention(q, k, v, **kw)
            want = flash_attention_plain(q, k, v, **kw)
            abs_err, rel_err = max_err(got.float(), want.float())
            check(rel_err <= FLASH_TOL[q.dtype], f"flash launch {i} disagrees")
            worst_abs = max(worst_abs, abs_err)
            ms = time_ms(lambda: flash_attention(q, k, v, **kw), 3)
            pms = time_ms(lambda: flash_attention_plain(q, k, v, **kw), 2)
            b_ms, b_by = flash_bound(q, k, v, kw["causal"], kw["window"])
            print(f"flash launch {i} ({cfg.layer_kind(i)}) q {tuple(q.shape)} "
                  f"kv {tuple(k.shape)} {kw}: kernel {ms:.3f} ms, plain "
                  f"{pms:.3f} ms, bound {b_ms:.4f} ms ({b_by}), max abs "
                  f"{abs_err:.3g} rel {rel_err:.3g}")
            rows.append((ms, pms, b_ms, b_by))
        # the global layer's inputs without softcap, beside the library call
        glob = next(i for i in range(cfg.n_layers)
                    if cfg.layer_kind(i) != "local")
        q, k, v, _ = calls[glob]
        nocap_ms = time_ms(lambda: flash_attention(q, k, v, causal=True), 5)
        qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
        sdpa = torch.nn.functional.scaled_dot_product_attention
        lib_ms = time_ms(lambda: sdpa(qt, kt, vt, is_causal=True,
                                      enable_gqa=True), 5)
        _, lib_err = max_err(
            sdpa(qt, kt, vt, is_causal=True, enable_gqa=True).transpose(
                1, 2).float(), flash_attention(q, k, v, causal=True).float())
        print(f"layer {glob} inputs without softcap: kernel {nocap_ms:.3f} ms, "
              f"scaled_dot_product_attention {lib_ms:.3f} ms (rel diff "
              f"{lib_err:.3g}; a yardstick the port never calls)")
        wave_ms = sum(r[0] for r in rows)
        print(f"one wave's prefill: {len(rows)} flash launches, kernel "
              f"{wave_ms:.3f} ms, plain {sum(r[1] for r in rows):.3f} ms, bound "
              f"{sum(r[2] for r in rows):.4f} ms")

        prefill_ms = host_ms(lambda: prefill(params, toks0), 3)
        decode_ms = []
        for _ in range(2):   # the second run is warm
            logits, cache = prefill(params, toks0)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            greedy(logits, cache)
            torch.cuda.synchronize()
            decode_ms.append((time.perf_counter() - t0) * 1e3 / (MAX_NEW - 1))
    print(f"wave: prefill {prefill_ms:.3f} ms (median of 3; flash "
          f"{100 * wave_ms / prefill_ms:.1f}% of it), decode "
          f"{decode_ms[-1]:.3f} ms per token ({BATCH} sequences, "
          f"{1e3 * BATCH / decode_ms[-1]:.1f} tokens/s); peak memory "
          f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    ms, pms, b_ms, b_by = rows[glob]
    return {
        "name": "flash_attention",
        "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/flash_fwd.cu",
        "replaces": "src/repro/kernels/flash/flash.py:30",
        "launches": total_launches,
        "max_abs_err": worst_abs,
        # one global-layer launch of a wave's prefill (B=2, S=6144, 8/4
        # heads of 256, causal, softcap 50); library_ms is SDPA on the same
        # inputs without softcap, beside the kernel's ms_no_softcap
        "ms": ms,
        "plain_ms": pms,
        "bound_ms": b_ms,
        "bound_by": b_by,
        "library_ms": lib_ms,
        "ms_no_softcap": nocap_ms,
        # summed over the 26 launches of one wave's prefill
        "wave_ms": wave_ms,
        "wave_plain_ms": sum(r[1] for r in rows),
        "wave_bound_ms": sum(r[2] for r in rows),
    }


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    from repro_torch.kernels import build
    from repro_torch.kernels.flash import flash
    from repro_torch.kernels.sspnna import sspnna

    card = card_line()
    print(f"card: {card}")
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"device {torch.cuda.get_device_name(0)}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device(DEVICE)
    phase = Phases()

    phase("build")
    kernels = (sspnna.KERNEL, flash.KERNEL)
    with ThreadPoolExecutor(len(kernels)) as pool:  # one nvcc per source
        list(pool.map(build.build, kernels))
    print(f"build: {', '.join(kernels)} for sm_90a")

    results = [scn_path(dev, phase)]
    torch.cuda.empty_cache()
    results.append(lm_path(dev, phase))
    phase.end()

    print(f"card: {card}")
    print(json.dumps({"kernels": results}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
