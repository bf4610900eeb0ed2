#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA card.

    python3 chip_smoke.py

1. Prints the card's name and power limit, turns TF32 off, and builds the
   CUDA kernels from ``src/repro_torch/kernels/csrc`` with nvcc, one
   process per source, all at once; prints the registers and spills
   ``ptxas -v`` reports for the bf16 flash kernels (the tensor-core
   ``wgmma`` design), for every instantiation of the SSpNNA tile kernel
   (``mma.sync``) and for every instantiation of the expert GEMM's kernels
   (bf16 ``wgmma`` tiles and ``mma.sync`` slabs, f32 CUDA cores), and fails
   if any of them spills.
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
   version at its real inputs, and times kernel and plain version as one
   call through the wrapper (``time_ms``: CUDA events, host included, as
   every earlier run reported them) and on the device (``device_ms``: CUDA
   events around calls queued behind a spinning kernel), and the
   end-to-end forward (synchronized host clock); each launch line gives
   its blocks and the TFLOP/s of its useful pairs, and its bound at the
   fp32 peak and at 3xTF32 on the tensor cores. Then splits the kernel's
   device time over those launches with three timing builds of its tile
   body (``SSPNNA_BREAKDOWN`` in ``sspnna_tile.cuh``): without the plane
   feed's copies, without the products, and with one TF32 product of the
   three.
4b. Plans each level's submanifold conv of the three scenes with the
   paper's dataflow optimizers ("SCN dataflow"): input-row fetches at tiles
   of 256 outputs (Fig 23's cost model) for the engine's SOAR order, the
   raster order and hierarchical SOAR (chunks of 128 inside 2048); the
   surface-ratio fit of SA_I (Fig 15); an offline SPADE table per level
   from the three scenes' meta-attributes (64 KiB budget), looked up at
   each scene's ARF against ``explore`` on the scene's own attributes (the
   DA ratio, and the host time of each). Then launches ``sspnna_fused`` on
   the plans ``conv_plan_for_layer`` builds from (a) the hierarchical order
   with its own attributes and (b) the SOAR order with the looked-up
   dataflow, on every level whose dispatch maps to ``sspnna`` (each
   level's mapping printed beside the engine's own dispatch): each launch
   against its plain version (1e-4) and the conv against ``reference`` on
   the same plan (1e-4), timed on the device beside the engine's own plan
   of the level and the launch's bound. (a) must launch on some level.
5. Holds the pre-gathered tile-stack kernel (``sspnna_tiles``) against its
   plain version on random stacks (``kernels/sspnna/ref.TILE_STACK_CASES``:
   f32 and bf16, K 27 and 8, ragged C and N, all-hole tiles).
6. Drives the pre-gathered path on seed 0's scene: the standalone layer
   path (COIR, strided and transposed tables built on the card and held
   equal to the host planner's, ``conv_plan_for_layer``, ``sparse_conv``),
   each of the forward's recorded fused calls through
   ``run_sspnna_conv(fused=False)`` (held against the fused output), and at
   each level a plane-split plan (``delta_i`` one below the level's
   largest working set, ``n_row_splits > 0``) held against the reference
   product. The tile-stack kernel's launch count must equal the calls
   made. Each launch is held against the plain version at its real inputs
   and timed beside its bound, the whole pre-gathered conv and
   ``torch.matmul`` of the already-gathered block (a yardstick the port
   never calls); then the whole forward runs with ``use_kernel=False``,
   launching no kernel, and its logits must match ``auto``'s.
7. Serves seeds 0-2 as one wave of 3 through ``SceneEngine`` with a spec
   pinned from the same scenes (``build_plan_spec``) and the kernel on,
   blocking and then pipelined on one context: the second serve must hit
   the plan cache, both must give the same logits, each engine captures
   one CUDA graph (its bucket's) and the wave's ``sspnna_fused`` launches
   run inside it (a replay ticks no counter: the engine's ``graphs``
   count what replays ran). The wave's logits must match each scene's own
   ``apply_unet`` on the same pinned plan (1e-4) and ``reference``
   (1e-3); the wave is timed eagerly and as a graph replay (host clock,
   and device time with the busy share), each of its kernel launches held
   against the plain version and timed on the device.
8. Tunes the SCN dispatch by measurement: for seed 0's adaptive plan, times
   each level's submanifold conv through every registered backend
   (``engine.measure_backends``: CUDA events, median of 5) beside the
   level's shape signature, records the times in a ``CostTable``, builds
   the plan again with ``autotune=`` the table (each level's analytical
   backend against the tuned one), holds the tuned forward against
   ``reference`` (1e-3) and times it against the analytical plan's, and
   saves and reloads the table (``ok``; ``fingerprint-mismatch`` under
   another card's fingerprint). Then a cold table records seed 0's
   signatures as misses, a ``SceneEngine`` on the pinned spec serves seeds
   0-2 with ``autotune_reprofile_ms`` set, and its idle hook profiles
   every miss on synthetic workloads (``sspnna_fused`` launched outside
   any graph); each synthetic winner is printed beside the real plan's.
9. Trips a circuit breaker: a ``SceneEngine`` on the pinned spec (batch 2,
   seeds 0-1, the board at 3 failures on a fake clock) serves a fault-free
   wave, then three injected dispatch faults attributed to ``sspnna``: the
   breaker opens once, the retried requests' plans are rerouted to
   ``reference`` and run on a second graph without ``sspnna_fused``, their
   logits within 1e-3 of a reference engine's. Past the cooldown seed 2
   probes and closes the breaker (its generation bumps) and seeds 0-1
   replay the ``sspnna`` graph again (1e-4 against the fault-free wave).
   Times a rerouted wave against the ``sspnna`` graph's. Every phase that
   injects no fault requires an empty breaker board and no wave error.
10. Serves two LiDAR sweeps (``make_lidar_sweep``, seeds 0-1, 3 frames of
   ~78.6k voxels at resolution 256, ego step 8) as two streams through
   ``SceneEngine.open_stream`` with a spec pinned from their first frames,
   one frame of each stream a wave, blocking and then pipelined: modes
   rebuilt then patched, equal bits in both serves, every wave a replay of
   the bucket's one graph running ``sspnna_fused`` once per sspnna conv
   and no other kernel. Stream 0's patched tables must equal a
   from-scratch build of the re-packed frame and its logits its own
   ``apply_unet`` (1e-4) and ``reference`` (1e-3). Times the host plans
   (patched against from scratch), the sweep, a stream wave's replay (busy
   share) and its kernel launches (held against the plain version, beside
   their bound), and counts the bytes each frame's upload copied.
11. Holds the flash attention kernel against its plain version on random
   q, k, v (``kernels/flash/ref.FLASH_CASES``: causal and not, sq < skv,
   windows, softcaps, D 32-256, f32 and bf16, GQA groups 1 and 2, ragged
   lengths, and the bf16 kernel's edges: many tiles at D=256, Sq=129, a
   window shorter than a tile, sq > skv, D=32).
12. Drives the LM serving path: Gemma-2 2B at its published widths (26
   layers, d_model 2304, 8/4 heads of 256, d_ff 9216, vocab 256000, window
   4096, softcaps 50 and 30), bf16, random weights drawn on the card from
   ``torch.Generator(device="cuda").manual_seed(0)``. An ``Engine`` (batch 2, prompt
   length 6144, 8 new tokens) serves four ``TokenStream`` prompts in two
   waves, once with ``sync=True`` and once with ``sync=False``: each wave's
   prefill must launch the kernel once per layer, the tokens of both runs
   must be equal, and each wave's last-position logits must match the same
   weights with the attention's plain version, in f32 (the weights cast up)
   and in bf16 (first tokens equal).
13. Replays every flash launch of one wave's prefill against the plain
   version and times kernel, plain version and bound; at the global-layer
   shape it also times the kernel without softcap beside
   ``scaled_dot_product_attention`` (a yardstick the port never calls).
   Then times one wave's prefill and its decode steps, and decode per
   token as eager steps against the serving engine's step graphs (one
   CUDA graph per step index, replayed by every wave), with the device's
   busy share; the two must emit the same tokens.
14. Frees the Gemma path and holds the grouped expert GEMM kernel against
   its plain version (``kernels/moe_gemm/ref.MOE_GEMM_CASES``: the JAX
   test's shapes, ragged C, d and f, an expert with no valid row, C = 8,
   f32 and bf16 with both output dtypes).
15. Drives the MoE LM serving path: Moonshot 16B-A3B at its published widths
   and depth (48 layers, d_model 2048, 16 heads of 128, 64 experts top-6 of
   d_ff 1408, vocab 163840; 27.7 B parameters), bf16, random weights drawn
   on the card. An ``Engine`` (batch 2, prompt length 4096, 8 new tokens)
   serves four prompts in two waves, blocking and pipelined: each wave must
   launch flash once per layer in its prefill and the expert GEMM three
   times per layer in its prefill and in each decode step (the steps are
   graph replays, counted by the engine), and both runs must emit the same
   tokens. Decode per token, eager steps against the step graphs, as for
   Gemma-2.
16. Checks every expert-GEMM launch of one wave's prefill and of one decode
   step against the plain version at its real inputs; the last-position
   logits at full width and 4 layers against the plain expert products in
   f32 and bf16; and reports (ungated) the full-depth bf16 logits against
   the plain expert products, for which no f32 noise floor fits the card.
17. Times the kernel at the path's four launch shapes beside its plain
   version, ``torch.bmm`` (a yardstick the port never calls) and its bound,
   as one call (``time_ms``) and, kernel and ``torch.bmm``, on the device
   (``device_ms``);
   holds flash at layer 0's inputs (D=128) against its plain version and
   times it beside SDPA; times a wave's prefill and decode.
18. Trains the SCN U-Net at its published widths ("SCN training", after the
   streaming phase): 30 SGD steps at lr 0.3 over seeds 0-2 on untiled
   plans, so every conv runs ``reference`` under autograd and no kernel
   launches (the counters stay at 0); prints the median step (forward,
   backward, update, ending in a synchronize), its device busy share,
   peak memory and the loss, which must fall. Then the trained weights run
   on seed 0's adaptive tiled plan with ``backend="auto"``: 15
   ``sspnna_fused`` launches, logits within 1e-3 of ``reference``.
19. Trains StableLM-2 1.6B at its published widths and depth ("LM
   training", last): bf16 with remat, AdamW with f32 moments, 10 steps of
   4 x 1024 ``TokenStream`` tokens in 2 microbatches, no kernel launch;
   prints step ms, tokens/s, the share of the bf16 dense peak, peak
   memory, loss and grad norm (the loss must fall). After step 5 a
   ``save_async`` of the state is written while steps 6-10 run, then
   restored onto the card and held bit for bit against the state it
   saved. A prefill of the trained weights launches flash once a layer
   and matches the plain attention (f32 within 1e-3; bf16 within twice
   bf16's own distance). Reduced Moonshot takes three AdamW steps: finite
   loss, the MoE auxiliaries, no expert-GEMM launch.

20. Serves the configs of slice 10 one after another, each freed before
   the next ("<arch> init", "serving", "decode graph", "checks",
   "timing"): Granite-8B, H2O-Danube-3-4B (head dim 120, which the flash
   wrapper pads to the kernel's 128), RecurrentGemma-9B and RWKV-6-7B at
   their published widths and depths, and Llama-4 Maverick at its
   published widths with one layer (128 experts top-1), bf16 with weights
   drawn on the card: one wave of 2 prompts of 256 tokens and 8 new tokens
   through ``Engine`` on the decode-step graphs (graph tokens equal eager
   tokens; the recurrent states advance in place in the graphs' buffers).
   Prints prefill ms, decode ms a token (graph against eager), the busy
   share and the peak memory; counts the flash and expert-GEMM launches as
   ``Graphs`` counts them; holds flash at one attention layer of each
   config (and of RWKV-6, which has none, checks that nothing launched)
   and every expert-GEMM launch of Maverick's prefill and decode step
   against their plain versions, and times them beside their bounds, SDPA
   (H2O, RecurrentGemma), ``torch.bmm`` (Maverick) and, for D=120, the
   same launch on pre-padded inputs (the pad's cost).
21. Trains RecurrentGemma-9B (6 layers) and RWKV-6-7B (8 layers) at their
   published widths for 2 AdamW steps each in bf16 with remat, and reduced
   Maverick for 8 Adafactor steps (a held batch's loss must fall); no
   kernel launches in a step.
22. Splits seed 0's scene ("SCN sharded", after the streaming phase) over 2
   and 4 shards (``engine.ShardLayout``) and runs it as the loop over the
   shards on the card: host plan seconds, halo rows a conv, logits within
   1e-3 of ``reference`` and two runs bit for bit, the forward's ms and
   busy share beside the unsharded ``reference``'s, and no kernel wrapper
   launched (the JAX package's sharded path is plain ops too). Then a
   ``SceneEngine(layout=pin_halo(...))`` serves seeds 0-1 as one wave of
   2, each scene's logits equal to its own sharded forward.
23. Serves Pixtral-12B and SeamlessM4T-medium at their published widths
   and depths (after the slice-10 configs, each freed before the next),
   bf16 with weights drawn on the card: one wave of 2 prompts through
   ``make_prefill`` (Pixtral: 512 tokens whose first 256 positions are
   seeded patch embeddings; Seamless: 256 tokens over sources of 384
   seeded frames) and ``Engine.decode`` on the decode-step graphs, graph
   tokens equal to eager steps. A prefill launches flash once a layer
   (Seamless: 12 encoder launches without a causal mask, 12 causal
   self-attention and 12 cross-attention launches with Sq < Skv); every
   launch is held against its plain version and the first of each kind
   timed through ``flash_row`` (beside SDPA). Prints prefill ms, decode ms
   a token (graph against eager) with busy shares, and peak memory.
24. Trains Pixtral-12B at its published widths and 6 of its 40 layers (2
   AdamW steps, the patch embeddings a batch key) and SeamlessM4T-medium at
   full depth (6 AdamW steps over source frames; a held batch's loss must
   fall), last; no kernel launches in a step.
25. Runs the distribution layer ("dist", after "LM training") in 2 spawned
   processes that share the card in a gloo group (``make_mesh((2,),
   ("model",))``): one Moonshot 16B-A3B MoE layer at its published widths
   (bf16, weights from seed 0) over 4 groups of 1024 tokens with
   ``dispatch="a2a"``, each rank holding 2 groups and 32 experts and
   launching the expert GEMM 3 times; the ranks' outputs, concatenated,
   against the same layer's ``dispatch="gather"`` in this process (bit
   for bit), each launch against its plain version and timed beside its
   bound and ``torch.bmm``, the layer's and the two exchanges' ms; then
   ``compressed_psum`` of each rank's expert gradients against the ranks'
   EF-int8 round trips summed in rank order (bit for bit), with its ms and
   the bytes that crossed; then the StableLM-2 checkpoint of "LM training"
   restored onto the two ranks with ``ShardingRules(cfg, mesh).
   state_shardings``, each rank's local shards against the matching slices
   of the saved leaves (bit for bit), with the seconds it took.
26. Runs the static analysis ("analysis", right after the build, before
   any other profiler session):
   ``python -m repro_torch.analysis`` with its four passes (lint, locks,
   plans, and ``hlo``, which launches the fused SSpNNA kernel on a budgeted
   tile plan of the canonical 16^3 scene and gates its profiler trace, its
   graph signature and its modeled shared memory) must find nothing; the
   same conv is held against its plain version, its device kernels
   listed (no gather or scatter kernel; none but the fused kernel and the
   output's fill), and the Python copy of the launch geometry
   (``analysis.hlo_gates.geometry``) held equal to ``launch_geometry``.
27. Runs the dry run ("dryrun", last) on this machine's CPU: two cells at
   full width on a fake 16x16 world of 256 ranks (``launch.dryrun.
   run_cell``): StableLM-2 1.6B x decode_32k and Moonshot 16B-A3B x
   prefill_32k, the latter reaching the flash and expert-GEMM wrappers'
   fake launches. Prints each cell's roofline terms, bound, MFU, memory
   (``fits_80GB``) and seconds; no kernel launches in it.

Each path runs with every launch count set to 0 just before it and read
just after. Prints each phase's seconds. Exits non-zero on any failure, and
when no card is present. The line before the last is a JSON object with
the kernels' numbers; the last line is ``{"ok": true, "device": {...}}``.
"""
from __future__ import annotations

import ctypes
import dataclasses
import gc
import json
import multiprocessing
import queue
import re
import shutil
import socket
import statistics
import subprocess
import sys
import time
import traceback
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

import numpy as np  # noqa: E402
import torch  # noqa: E402

# published peaks of one H100 SXM (NVIDIA data sheet, in launch/roofline
# with each kernel's work function; the card's power limit is printed beside
# every measurement)
from repro_torch.launch.roofline import (  # noqa: E402
    PEAK_BF16_FLOPS,
    PEAK_FP32_FLOPS,
    PEAK_TF32X3_FLOPS,
    flash_work,
    moe_gemm_work,
    sspnna_fused_work,
    sspnna_tiles_work,
)
# cycles a second of torch.cuda._sleep's spin, at most the H100's 1.98 GHz
# boost clock (a slower clock only spins longer)
SPIN_HZ = 1.98e9
# the fused kernel's timing builds (csrc/sspnna_tile.cuh, SSPNNA_BREAKDOWN)
BREAKDOWN_BUILDS = {"no_feed": ("SSPNNA_BREAKDOWN=1",),
                    "no_products": ("SSPNNA_BREAKDOWN=2",),
                    "one_tf32": ("SSPNNA_BREAKDOWN=3",)}
# f32 sums of up to K*C = 27*96 products, taken in another order than the
# plain version's matmul
KERNEL_TOL = 1e-4
# sspnna_tiles against its plain version on random stacks, max abs error /
# max(|want|, 1): f32 sums in another order; bf16 outputs rounded to bf16
TILES_TOL = {torch.float32: 1e-4, torch.bfloat16: 2e-2}
# end-to-end: 17 convs, each followed by a BatchNorm that divides by the
# per-channel std, so per-conv reorderings of ~1e-6 grow layer by layer
LOGITS_TOL = 1e-3
# a wave of scenes against each scene's own forward on the same plans: the
# same kernels over other row counts (cuBLAS may pick another order for the
# reference convs' products), then a batch norm after every conv
WAVE_TOL = 1e-4
SEEDS = (0, 1, 2)
# the "SCN dataflow" phase: Fig 23's tiles of DATAFLOW_TILE outputs and
# hierarchical SOAR's chunk sizes (``benchmarks/bench_soar.py``'s), the
# engine's SOAR chunk and SPADE budget; the lookup is timed over
# LOOKUP_REPS calls, ``explore`` over EXPLORE_REPS
DATAFLOW_TILE, DATAFLOW_CHUNKS = 256, [128, 2048]
DATAFLOW_SOAR_CHUNK, DATAFLOW_BUDGET = 512, 64 * 1024
LOOKUP_REPS, EXPLORE_REPS = 10_000, 3
# measured dispatch: samples a backend at each level (median of k), and the
# idle hook's budget a tick (enough to profile every missed level at once)
AUTOTUNE_K, REPROFILE_MS = 5, 120_000.0
RESOLUTION, CAPACITY, POINTS_PER_UNIT = 256, 131072, 2e6
# SCN streaming: two LiDAR sweeps of STREAM_FRAMES frames at the scene
# path's resolution and capacity; an ego step of 8 voxels keeps the shift
# divisible by 2^3 (four levels), so frames after the first are patched
STREAM_SEEDS, STREAM_FRAMES, STREAM_STEP, STREAM_CHURN = (0, 1), 3, 8, 0.05
DEVICE = "cuda"
# the LM path: Gemma-2 2B at full width, one engine shape, four prompts of
# lengths above the 4096 window (left-padded to PROMPT_LEN with token 0)
LM_ARCH, BATCH, PROMPT_LEN, MAX_NEW = "gemma2-2b", 2, 6144, 8
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
# the MoE LM path: Moonshot 16B-A3B at full width and depth, batch 2 in
# slots of 4096, four prompts; MOE_CHECK_LAYERS deep for the f32 check (an
# f32 copy of all 48 layers, 111 GB, does not fit the card)
MOE_ARCH, MOE_PROMPT_LEN = "moonshot-v1-16b-a3b", 4096
MOE_PROMPT_LENS = (4096, 3072, 4096, 2500)
MOE_CHECK_LAYERS = 4
# bf16 at full width, kernel against the plain expert products. A bf16
# rounding that differs in one layer moves the next layers' router logits,
# and a token whose top-k choice sits on a near tie goes to other experts,
# which moves the logits of random weights by O(1). So end to end the
# kernel may route otherwise at most LM_BF16_FACTOR times as many tokens as
# bf16 itself routes otherwise (the plain path's bf16 vs f32 evaluation);
# the last-position logits are reported. Layer by layer, given the same
# input (so the same routing), the outputs agree within the kernel's bf16
# tolerance, relative to the largest output (the residual sums of a layer
# cancel, so elementwise relative errors of near-zero sums mean nothing).
MOE_BF16_TOL = 2e-2
# SCN training: SGD at the JAX example's lr over seeds 0-2 in turn
SCN_TRAIN_STEPS, SCN_TRAIN_LR = 30, 0.3
# LM training: StableLM-2 1.6B at full width and depth, bf16 with remat,
# AdamW with f32 moments at the JAX example's lr; batches of 4 x 1024
# tokens in 2 microbatches; a checkpoint after step LM_CKPT_STEP
LM_TRAIN_ARCH, LM_TRAIN_LR = "stablelm-1.6b", 1e-3
LM_TRAIN_BATCH, LM_TRAIN_SEQ, LM_TRAIN_MICRO = 4, 1024, 2
LM_TRAIN_STEPS, LM_CKPT_STEP = 10, 5
# slice 10, parts a and b: the configs served one after another (each
# freed before the next), at their published widths and depths except
# Maverick, which serves one of its 48 layers (128 experts x 3 x 5120 x
# 8192 in bf16 is 32 GB a layer); one wave of BATCH prompts of LM10_PROMPT
# tokens (a multiple of RWKV's chunk of 64) and LM10_NEW new tokens
LM10_ARCHS = ("granite-8b", "h2o-danube-3-4b", "llama4-maverick-400b-a17b",
              "recurrentgemma-9b", "rwkv6-7b")
LM10_MOE = "llama4-maverick-400b-a17b"
# (n_layers, d_model, n_heads, n_kv_heads, head_dim, d_ff, vocab, experts,
# top_k) as published
LM10_PUBLISHED = {
    "granite-8b": (36, 4096, 32, 8, 128, 14336, 49152, 0, 1),
    "h2o-danube-3-4b": (24, 3840, 32, 8, 120, 10240, 32000, 0, 1),
    "llama4-maverick-400b-a17b": (48, 5120, 40, 8, 128, 8192, 202048, 128,
                                  1),
    "recurrentgemma-9b": (38, 4096, 16, 1, 256, 12288, 256000, 0, 1),
    "rwkv6-7b": (32, 4096, 64, 64, 64, 14336, 65536, 0, 1),
}
LM10_LAYERS = {LM10_MOE: 1}
LM10_PROMPT, LM10_NEW = 256, 8
# AdamW steps of the recurrent configs at their published widths: the
# depth one card holds with the functional update's two states (~25 bytes
# a parameter, as StableLM-2's step measured), batches of 2 x 512 tokens
LM10_TRAIN = {"recurrentgemma-9b": 6, "rwkv6-7b": 8}
LM10_TRAIN_BATCH, LM10_TRAIN_SEQ, LM10_TRAIN_STEPS = 2, 512, 2
# slice 10, part c, at published widths and depths with LM10_NEW new
# tokens: Pixtral-12B serves a wave of BATCH prompts of VLM_PROMPT tokens
# whose first 256 positions are seeded patch embeddings; SeamlessM4T-medium
# a wave of BATCH prompts of ENCDEC_PROMPT tokens over sources of
# ENCDEC_SRC seeded frames (so its cross attention has Sq < Skv)
VLM_ARCH, VLM_PROMPT = "pixtral-12b", 512
ENCDEC_ARCH, ENCDEC_PROMPT, ENCDEC_SRC = "seamless-m4t-medium", 256, 384
PART_C_PUBLISHED = {
    VLM_ARCH: (40, 5120, 32, 8, 128, 14336, 131072, 0, 1),
    ENCDEC_ARCH: (12, 1024, 16, 16, 64, 4096, 256206, 0, 1),
}
# Pixtral's AdamW steps (LM10_TRAIN_STEPS of LM10_TRAIN_BATCH x VLM_PROMPT
# tokens) at the depth one card holds with the functional update's two
# states: ~25 bytes a parameter, (6 x 0.273 + 1.342 embedding and head) B
# parameters ~ 69 GiB; Seamless trains at full depth, ENCDEC_TRAIN_STEPS
# steps, and a held batch's loss must fall
VLM_TRAIN_LAYERS = 6
ENCDEC_TRAIN_STEPS = 6
# SCN sharded (slice 9): seed 0's scene split over each of these shard
# counts, as the loop over shards on the one card
SHARDS = (2, 4)
# "LM training" writes its checkpoint here; "dist" restores it, then removes it
LM_CKPT_DIR = ROOT / "build" / "chip_smoke_ckpt"
# the "dist" phase (slice 11a): DIST_RANKS processes share the card in a
# gloo group; one Moonshot MoE layer over DIST_GROUPS groups of
# DIST_GROUP_TOKENS tokens, each rank holding DIST_GROUPS / DIST_RANKS
# groups and n_experts / DIST_RANKS experts; times are medians of DIST_REPS
DIST_RANKS, DIST_GROUPS, DIST_GROUP_TOKENS, DIST_REPS = 2, 4, 1024, 5
# how long the parent waits for the ranks' results
DIST_WAIT_S = 600


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise RuntimeError(msg)


def kernel_counts() -> dict[str, int]:
    """Every kernel wrapper's launch count."""
    from repro_torch.kernels.flash.flash import flash_attention
    from repro_torch.kernels.moe_gemm.moe_gemm import grouped_gemm
    from repro_torch.kernels.sspnna import sspnna

    return {"sspnna_fused": sspnna.sspnna_fused.launches,
            "sspnna_tiles": sspnna.sspnna_tiles.launches,
            "flash_fwd": flash_attention.launches,
            "moe_gemm": grouped_gemm.launches}


def zero_kernel_counts() -> None:
    from repro_torch.kernels.flash.flash import flash_attention
    from repro_torch.kernels.moe_gemm.moe_gemm import grouped_gemm
    from repro_torch.kernels.sspnna import sspnna

    sspnna.sspnna_fused.launches = sspnna.sspnna_tiles.launches = 0
    flash_attention.launches = grouped_gemm.launches = 0


def launched_only(*kernels: str) -> bool:
    """No wrapper but those of ``kernels`` has launched since the counts
    were last set to 0."""
    return not any(n for k, n in kernel_counts().items() if k not in kernels)


def kernel_vs_plain(kernel: str, kernel_side, plain_side, what: str):
    """``(kernel_side(), plain_side())``, failing the run unless the first
    launched ``kernel`` and the second did not: a comparison whose two
    sides run the same code would pass having measured nothing."""
    before = kernel_counts()[kernel]
    got = kernel_side()
    between = kernel_counts()[kernel]
    want = plain_side()
    check(between > before, f"{what}: the kernel side launched no {kernel}")
    check(kernel_counts()[kernel] == between,
          f"{what}: the plain side launched {kernel}")
    return got, want


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60).stdout
    return out.strip().splitlines()[0]


def max_err(got: torch.Tensor, want: torch.Tensor) -> tuple[float, float]:
    """(max abs error, max of abs error / max(|want|, 1))."""
    diff = (got - want).abs()
    return float(diff.max()), float((diff / want.abs().clamp(min=1.0)).max())


def norm_err(got: torch.Tensor, want: torch.Tensor) -> float:
    """max abs error / max(max |want|, 1), in f32."""
    got, want = got.float(), want.float()
    return float((got - want).abs().max() / want.abs().max().clamp(min=1.0))


def time_ms(fn, reps: int) -> float:
    """Median time of one call of ``fn`` over ``reps`` calls: CUDA events
    recorded just before and just after it, so a small kernel's time
    includes its wrapper's host work (after one warm-up call)."""
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


def device_ms(fn, reps: int) -> float:
    """Device time of one call of ``fn`` (ms), without the host's time: the
    stream is held by a spinning kernel (``torch.cuda._sleep``, twice as
    long as the host takes to enqueue the calls) while ``reps`` calls are
    enqueued behind it, so CUDA events around them see the device run them
    back to back. ``time_ms`` brackets one call through its Python wrapper
    and so adds the wrapper's host time to a small kernel's."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    host_s = time.perf_counter() - t0
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(int(SPIN_HZ * (2 * reps * host_s + 1e-3)))
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


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


def sspnna_bound(feats, weights, out_rows, in_rows, local_idx, counts, n_out,
                 peak=PEAK_FP32_FLOPS):
    """Least time (ms) the card could take for one launch's work, and what
    bounds it: ``launch.roofline.sspnna_fused_work`` (the FLOPs of the
    pairs this plan holds, against each referenced input row, the weights
    and the tables read once and the output written once) at the fp32 peak
    (or ``peak``) and the memory rate."""
    return sspnna_fused_work(feats, weights, out_rows, in_rows, local_idx,
                             counts, n_out).bound(peak)


def launch_shape(kernel: str, t, d_o, k, c, n) -> str:
    """The SSpNNA kernel's launch at this shape, in words."""
    from repro_torch.kernels.sspnna.sspnna import launch_geometry

    g = launch_geometry(kernel, t, d_o, k, c, n)
    return (f"{g['grid_x'] * g['grid_y']} blocks of {g['rows_per_block']} rows "
            f"x {g['channels_per_block']} channels, {g['threads']} threads, "
            f"{g['stages']} stages, {g['smem_bytes']} bytes of shared memory, "
            f"{g['blocks_per_sm']} an SM")


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
    """Least time (ms) for one attention launch, and what bounds it:
    ``launch.roofline.flash_work`` (4*D FLOPs per unmasked (q, k) pair and
    query head at the bf16 dense peak, against Q, K, V read once and O
    written once)."""
    return flash_work(q, k, v, causal, window).bound()


def flash_row(q, k, v, kw: dict, what: str, reps: int = 5) -> dict:
    """One flash launch at its real inputs: held against its plain version
    (within ``FLASH_TOL``), timed with its wrapper (``time_ms``) and on the
    device alone (``device_ms``), beside the plain version's time and the
    launch's bound. A head dim between instantiations also times the launch
    on inputs padded to the next one, so the pad costs the difference.
    Where no softcap is set and the window masks nothing, SDPA (GQA) computes
    the same function (causal at Sq = Skv, or without a mask at any lengths)
    and is timed as the library's yardstick, which the port never calls;
    otherwise ``library_ms`` is None."""
    from repro_torch.kernels.flash.flash import (
        HEAD_DIMS,
        flash_attention,
        flash_attention_plain,
    )
    from repro_torch.kernels.flash.ref import FLASH_TOL

    def kernel():
        return flash_attention(q, k, v, **kw)

    got, want = kernel_vs_plain(
        "flash_fwd", kernel, lambda: flash_attention_plain(q, k, v, **kw), what)
    abs_err, rel_err = max_err(got.float(), want.float())
    del want
    tol = FLASH_TOL[q.dtype]
    check(rel_err <= tol, f"{what}: flash disagrees with its plain version")
    causal, window = kw.get("causal", True), kw.get("window")
    b_ms, b_by = flash_bound(q, k, v, causal, window)
    row = {"q": list(q.shape), "kv": list(k.shape), "window": window,
           "max_abs_err": abs_err, "rel_err": rel_err,
           "ms": time_ms(kernel, reps), "device_ms": device_ms(kernel, 4 * reps),
           "plain_ms": time_ms(lambda: flash_attention_plain(q, k, v, **kw),
                               max(2, reps // 2)),
           "bound_ms": b_ms, "bound_by": b_by, "library_ms": None}
    note = ""
    d = q.shape[-1]
    kd = next(h for h in HEAD_DIMS if h >= d)
    if kd != d:
        qp, kp, vp = (torch.nn.functional.pad(x, (0, kd - d)) for x in (q, k, v))
        row["padded_ms"] = time_ms(lambda: flash_attention(qp, kp, vp, **kw),
                                   reps)
        row["padded_device_ms"] = device_ms(
            lambda: flash_attention(qp, kp, vp, **kw), 4 * reps)
        row["pad_ms"] = row["ms"] - row["padded_ms"]
        row["pad_device_ms"] = row["device_ms"] - row["padded_device_ms"]
        del qp, kp, vp
        note += (f"; padded {d} -> {kd}: the launch on padded inputs "
                 f"{row['padded_ms']:.4f} ms (device "
                 f"{row['padded_device_ms']:.4f}), so the pad costs "
                 f"{row['pad_ms']:.4f} ms (device {row['pad_device_ms']:.4f})")
    # SDPA's causal mask sits at the top left, the kernel's at the end of
    # the keys: they agree where Sq = Skv, and without a mask at any Sq, Skv
    if (not kw.get("softcap") and (not causal or q.shape[1] == k.shape[1])
            and (window is None or (causal and window >= q.shape[1]))):
        qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
        sdpa = torch.nn.functional.scaled_dot_product_attention

        def lib():
            return sdpa(qt, kt, vt, is_causal=causal, enable_gqa=True)

        row["library_ms"] = time_ms(lib, reps)
        row["library_device_ms"] = device_ms(lib, 4 * reps)
        _, row["library_rel_diff"] = max_err(lib().transpose(1, 2).float(),
                                             got.float())
        note += (f"; SDPA {row['library_ms']:.4f} ms (device "
                 f"{row['library_device_ms']:.4f}; rel diff "
                 f"{row['library_rel_diff']:.3g}; a yardstick the port never "
                 f"calls)")
    print(f"{what}: flash q {tuple(q.shape)} kv {tuple(k.shape)} {kw}: kernel "
          f"{row['ms']:.4f} ms (device {row['device_ms']:.4f}), plain "
          f"{row['plain_ms']:.4f} ms, bound {b_ms:.5f} ms ({b_by}), max abs "
          f"{abs_err:.3g} rel {rel_err:.3g} (tol {tol}){note}")
    return row


def device_times(fn) -> dict[str, float]:
    """Device ms of each kernel (and copy) name that ``fn`` ran, from
    ``torch.profiler``; empty when the profiler saw no device activity."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    # the device's own events only: a CPU op's entry repeats its kernels'
    return {evt.key: evt.self_device_time_total / 1e3
            for evt in prof.key_averages()
            if evt.device_type == DeviceType.CUDA
            and evt.self_device_time_total > 0}


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


def only_graph(eng):
    """The key of an engine's one captured graph."""
    keys = eng.graphs.keys()
    check(len(keys) == 1, f"{len(keys)} graphs where one was expected")
    return keys[0]


def check_no_breakers(eng) -> None:
    """A phase that injects no fault: no breaker state and no contained
    wave failure, so a real kernel or launch failure cannot hide behind a
    fallback."""
    states = eng.health()["breakers"]
    check(states == {} and eng.scheduler.wave_errors == 0,
          f"a fault-free serve recorded breaker states {states} and "
          f"{eng.scheduler.wave_errors} wave errors")


def sspnna_convs(plan, cfg) -> int:
    """Convs of one forward that the planner sent to the kernel."""
    n = 0
    for li, lvl in enumerate(plan.levels):
        if lvl.sub.dispatch.backend == "sspnna" and lvl.sub.tiles is not None:
            n += ((li == 0) + cfg.reps
                  + (cfg.reps if li < len(plan.levels) - 1 else 0))
    return n


def scn_path(dev: torch.device, phase: Phases) -> tuple[dict, dict]:
    """Phases 2-4: ``sspnna_fused`` on random tables, the SCN forward on
    three scenes, and the replay of seed 0's launches. Returns the kernel's
    JSON entry and what the pre-gathered phase reuses of seed 0 (model,
    features, coords, host and uploaded plans, recorded fused calls, the
    auto logits)."""
    from repro_torch import engine
    from repro_torch.data.scenes import make_scene
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
        got, want = kernel_vs_plain(
            "sspnna_fused", lambda: fused(*args, n_out=v),
            lambda: plain(*args, n_out=v), f"random tables V={v}")
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

    zero_kernel_counts()
    uploaded = {}
    with torch.inference_mode():
        for seed, feats, labels, mask, host in requests:
            plan = engine.upload_scene_plan(host, dev)
            uploaded[seed] = plan
            expected = sspnna_convs(plan, cfg)
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
    check(launched_only("sspnna_fused"), "the SCN path launched another "
          "kernel")

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
            logits0 = engine.apply_unet(model, feats0, plan0, device=dev)
    finally:
        ops.sspnna_fused = fused
    # per launch: level, kernel ms (a call), plain ms (a call), bound ms,
    # bound by, bound ms at 3xTF32, kernel and plain device ms
    rows = []
    with torch.inference_mode():
        for i, (args, kw) in enumerate(calls):
            got, want = kernel_vs_plain(
                "sspnna_fused", lambda: fused(*args, **kw),
                lambda: plain(*args, **kw), f"launch {i}")
            abs_err, rel_err = max_err(got, want)
            check(rel_err <= KERNEL_TOL, f"launch {i}: kernel disagrees")
            worst_abs = max(worst_abs, abs_err)
            ms = time_ms(lambda: fused(*args, **kw), 20)
            pms = time_ms(lambda: plain(*args, **kw), 5)
            dev_ms = device_ms(lambda: fused(*args, **kw), 20)
            plain_dev_ms = device_ms(lambda: plain(*args, **kw), 5)
            b_ms, b_by = sspnna_bound(*args, kw["n_out"])
            b3_ms, b3_by = sspnna_bound(*args, kw["n_out"], PEAK_TF32X3_FLOPS)
            feats, weights, out_rows, in_rows, local_idx, counts = args
            t, d_o, k = local_idx.shape
            c, n, pairs = feats.shape[1], weights.shape[2], int(counts.sum())
            level = next(li for li, lvl in enumerate(plan0.levels)
                         if lvl.sub.tiles is not None
                         and lvl.sub.tiles.local_idx is local_idx)
            print(f"launch {i} L{level} C={c} N={n} T={t} dO={d_o} "
                  f"dI={in_rows.shape[1]} pairs={pairs}: kernel {ms:.4f} ms "
                  f"a call, {dev_ms:.4f} ms on the device "
                  f"({launch_shape(sspnna.KERNEL, t, d_o, k, c, n)}, "
                  f"{2e-9 * pairs * c * n / dev_ms:.2f} TFLOP/s of useful "
                  f"pairs); plain {pms:.4f} ms a call, {plain_dev_ms:.4f} ms "
                  f"on the device; bound {b_ms:.4f} ms ({b_by}; {b3_ms:.4f} "
                  f"ms, {b3_by}, at 3xTF32), max abs {abs_err:.3g}")
            rows.append((level, ms, pms, b_ms, b_by, b3_ms, dev_ms,
                         plain_dev_ms))
    for level in sorted({r[0] for r in rows}):
        mine = [r for r in rows if r[0] == level]
        print(f"level {level}: {len(mine)} launches, kernel "
              f"{sum(r[1] for r in mine):.4f} ms in calls, "
              f"{sum(r[6] for r in mine):.4f} ms on the device; plain "
              f"{sum(r[2] for r in mine):.4f} ms in calls, "
              f"{sum(r[7] for r in mine):.4f} ms on the device; bound "
              f"{sum(r[3] for r in mine):.4f} ms ("
              f"{sum(r[5] for r in mine):.4f} ms at 3xTF32) per forward")
    by_bytes = sum(r[3] for r in rows if r[4] == "bytes")
    by_ops = sum(r[3] for r in rows if r[4] == "operations")
    with torch.inference_mode():
        breakdown = fused_breakdown(calls)
    print("sspnna_fused breakdown over seed 0's launches, device ms per "
          "forward: " + ", ".join(f"{k} {v:.4f}" for k, v in breakdown.items()))

    with torch.inference_mode():
        fwd_auto = host_ms(lambda: engine.apply_unet(
            model, feats0, plan0, device=dev), 5)
        fwd_ref = host_ms(lambda: engine.apply_unet(
            model, feats0, plan0, backend="reference", device=dev), 5)
    print(f"forward seed={seed0}: auto {fwd_auto:.3f} ms, reference "
          f"{fwd_ref:.3f} ms (median of 5, host clock after synchronize); "
          f"peak memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    entry = {
        "name": "sspnna_fused",
        "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/sspnna_fused.cu",
        "replaces": "src/repro/kernels/sspnna/sspnna.py:151",
        "launches": total_launches,
        "max_abs_err": worst_abs,
        # times and bound summed over the launches of one forward (seed 0);
        # ms and plain_ms are calls through the wrapper, host included
        # (time_ms), *device_ms the device alone (device_ms)
        "ms": sum(r[1] for r in rows),
        "plain_ms": sum(r[2] for r in rows),
        "bound_ms": by_bytes + by_ops,
        "bound_by": "bytes" if by_bytes >= by_ops else "operations",
        "library_ms": None,
        "device_ms": sum(r[6] for r in rows),
        "plain_device_ms": sum(r[7] for r in rows),
        "library_device_ms": None,
        # the same bound with the operations at 3xTF32 on the tensor cores
        "bound_tf32x3_ms": sum(r[5] for r in rows),
        # device ms of the timing builds (fused_breakdown), "full" the kernel
        "breakdown_device_ms": breakdown,
    }
    seed0_state = {"cfg": cfg, "model": model, "feats": feats0,
                   "coords": requests[0][4].levels[0].coords,
                   "host": requests[0][4], "plan": plan0, "calls": calls,
                   "logits": logits0,
                   # every scene's (seed, host plan, uploaded plan)
                   "scenes": [(seed, host, uploaded[seed])
                              for seed, _, _, _, host in requests]}
    return entry, seed0_state


def spade_da(layer, attrs, df) -> float:
    """``explore``'s data accesses (Eqn 5, with RST's split-tile factor) of
    the dataflow ``df`` on ``layer`` with ``attrs``."""
    from repro_torch.core import spade

    da, _ = spade.data_accesses(layer, attrs, df.delta_major, df.delta_c,
                                df.delta_n, df.walk, df.flavor)
    if df.tiling == "RST":
        da *= 1.0 + 0.5 * attrs.at(df.delta_major, "rst_overshoot_frac")
    return da


def scn_dataflow_path(dev: torch.device, phase: Phases, model, cfg,
                      scenes) -> dict:
    """Phase 4b ("SCN dataflow"): SOAR's access counts, the surface-ratio
    fit and offline SPADE on each level's submanifold conv of ``scenes``
    (``(seed, host plan, uploaded plan)``), then ``sspnna_fused`` on the
    plans of hierarchical SOAR with its own SPADE choice and of the SOAR
    order with the looked-up dataflow. Returns the fused kernel's
    "dataflow" entry."""
    from repro_torch import engine
    from repro_torch.core import soar, spade
    from repro_torch.kernels.sspnna import ops, sspnna

    fused, plain = sspnna.sspnna_fused, sspnna.sspnna_fused_plain
    phase("SCN dataflow")
    t_phase = time.perf_counter()

    def layer_of(li, v):  # the engine's SPADE layer of a level
        return spade.LayerSpec(f"level{li}", v, v, 27, cfg.widths[li],
                               cfg.widths[li], 2)

    # host: the three orders of each scene's levels, their input-row
    # fetches, the SOAR attributes and their surface-ratio fit
    lv = {}
    for seed, host, _ in scenes:
        for li, lvl in enumerate(host.levels):
            idx, mask = lvl.sub.coir.indices, lvl.mask
            t0 = time.perf_counter()
            order = soar.soar_order(idx, mask, DATAFLOW_SOAR_CHUNK).order
            t1 = time.perf_counter()
            hier = soar.soar_hierarchical(idx, mask, DATAFLOW_CHUNKS)
            t2 = time.perf_counter()
            orders = {"soar": order,
                      "raster": soar.raster_order(lvl.coords, mask),
                      "hierarchical": hier.order}
            fetches = {k: soar.tiled_unique_input_accesses(o, idx,
                                                           DATAFLOW_TILE)
                       for k, o in orders.items()}
            attrs = spade.extract_attributes(idx, mask, order)
            alpha, corr = spade.fit_surface_ratio(attrs)
            lv[seed, li] = {"n": int(mask.sum()), "orders": orders,
                            "attrs": attrs, "fetches": fetches,
                            "fit": (alpha, corr)}
            print(f"dataflow seed={seed} L{li} {int(mask.sum())} voxels: "
                  f"input rows fetched at tiles of {DATAFLOW_TILE}: SOAR "
                  f"{fetches['soar']}, raster {fetches['raster']} "
                  f"(raster / SOAR {fetches['raster'] / fetches['soar']:.3f}), "
                  f"hierarchical {DATAFLOW_CHUNKS} {fetches['hierarchical']} "
                  f"(SOAR / hierarchical "
                  f"{fetches['soar'] / fetches['hierarchical']:.3f}, "
                  f"{hier.n_chunks} chunks of 128); host s: SOAR "
                  f"{t1 - t0:.2f}, hierarchical {t2 - t1:.2f}; surface-ratio "
                  f"fit alpha={alpha:.4f} corr={corr:.4f}; ARF "
                  f"{attrs.arf_avg[0]:.4f}")

    # offline SPADE: one table a level from the three scenes' MSA, looked
    # up at each scene's ARF against explore on its own attributes; each
    # level's dispatch from (a) the hierarchical order's own attributes and
    # (b) the lookup, beside the engine's
    n_levels, plans, rows, lookups = len(cfg.widths), [], [], []
    for li in range(n_levels):
        mine = [lv[seed, li] for seed, _, _ in scenes]
        msa = spade.meta_attributes([m["attrs"] for m in mine])
        table_layer = layer_of(li, round(statistics.mean(m["n"] for m in mine)))
        t0 = time.perf_counter()
        table = spade.build_offline_table([table_layer], msa, DATAFLOW_BUDGET)
        table_s = time.perf_counter() - t0
        for seed, host, uploaded in scenes:
            m = lv[seed, li]
            n, attrs, order = m["n"], m["attrs"], m["orders"]["soar"]
            layer = layer_of(li, n)
            arf = float(attrs.arf_avg[0])
            t0 = time.perf_counter()
            for _ in range(LOOKUP_REPS):
                off = spade.otf_lookup(table, table_layer, arf)
            lookup_us = (time.perf_counter() - t0) / LOOKUP_REPS * 1e6
            times = []
            for _ in range(EXPLORE_REPS):
                t0 = time.perf_counter()
                jsa = spade.explore(layer, {"CIRF": attrs, "CORF": attrs},
                                    DATAFLOW_BUDGET)
                times.append(time.perf_counter() - t0)
            explore_us = statistics.median(times) * 1e6
            ratio = off.da_elems / jsa.da_elems
            here = spade_da(layer, attrs, off) / jsa.da_elems
            h_attrs = spade.extract_attributes(
                host.levels[li].sub.coir.indices, host.levels[li].mask,
                m["orders"]["hierarchical"])
            h_df = spade.explore(layer, {"CIRF": h_attrs, "CORF": h_attrs},
                                 DATAFLOW_BUDGET)
            d_a = engine.dispatch_from_dataflow(h_df, h_attrs, n)
            d_b = engine.dispatch_from_dataflow(off, attrs, n)
            mine_d = host.stats[li]["dispatch"]

            def says(d):
                return (f"{d.backend} dO={d.delta_o} dI={d.delta_i}"
                        if d.backend == engine.SSPNNA else d.backend)

            print(f"dataflow seed={seed} L{li}: offline table of 9 ARF bins "
                  f"built in {table_s:.3f} s; lookup at ARF {arf:.4f} -> "
                  f"{off.walk}/{off.flavor} dO={off.delta_major} "
                  f"dC={off.delta_c} dN={off.delta_n} in {lookup_us:.2f} us, "
                  f"explore on the scene's attributes -> {jsa.walk}/"
                  f"{jsa.flavor} dO={jsa.delta_major} dC={jsa.delta_c} "
                  f"dN={jsa.delta_n} in {explore_us:.1f} us "
                  f"({explore_us / lookup_us:.0f}x the lookup); DA offline "
                  f"/ scene's own: {ratio:.4f} (the table's DA), {here:.4f} "
                  f"(the looked-up dataflow's DA on the scene's attributes); "
                  f"dispatch (a) hierarchical: {says(d_a)}, (b) lookup: "
                  f"{says(d_b)}, the engine's SOAR plan: {says(mine_d)}")
            lookups.append({"seed": seed, "level": li, "arf": arf,
                            "lookup_us": lookup_us, "explore_us": explore_us,
                            "table_s": table_s, "da_ratio": ratio,
                            "da_ratio_on_scene": here,
                            "dispatch": {"hierarchical": d_a.backend,
                                         "lookup": d_b.backend,
                                         "engine": mine_d.backend}})
            for source, d, rows_order in (("hierarchical", d_a,
                                           m["orders"]["hierarchical"]),
                                          ("lookup", d_b, order)):
                if d.backend != engine.SSPNNA:
                    continue
                try:
                    cp = engine.conv_plan_for_layer(
                        uploaded.levels[li].sub.coir, rows_order, d.delta_o,
                        d.delta_i, walk=d.walk, device=dev)
                except ValueError as e:  # plane split: the engine's fallback
                    print(f"dataflow seed={seed} L{li} ({source}): {e}; "
                          f"reference, as the engine falls back")
                    continue
                plans.append((seed, li, source, cp, uploaded.levels[li]))

    # the path: every plan's conv through the engine, launches counted
    check(any(p[2] == "hierarchical" for p in plans),
          "the hierarchical SOAR order mapped to sspnna on no level")
    inputs = {}
    for li in range(n_levels):
        g = torch.Generator().manual_seed(100 + li)
        inputs[li] = (torch.randn((cfg.capacity, cfg.widths[li]),
                                  generator=g).to(dev),
                      model.levels[li].enc[0].conv.params)
    calls, outs = [], []

    def record(*args, **kw):
        calls.append((args, kw))
        return fused(*args, **kw)

    zero_kernel_counts()
    ops.sspnna_fused = record
    try:
        with torch.inference_mode():
            for seed, li, source, cp, lvl in plans:
                x, p = inputs[li]
                x = x * lvl.mask.unsqueeze(-1)
                outs.append((x, engine.sparse_conv(x, p, cp,
                                                   backend="sspnna")))
        torch.cuda.synchronize()
    finally:
        ops.sspnna_fused = fused
    launches = fused.launches
    check(launches == len(plans) == len(calls),
          f"sspnna_fused launched {launches} times for {len(plans)} plans")
    check(launched_only("sspnna_fused"), "the dataflow path launched another "
          "kernel")

    worst_abs = 0.0
    with torch.inference_mode():
        for (seed, li, source, cp, lvl), (args, kw), (x, out) in zip(
                plans, calls, outs, strict=True):
            what = f"dataflow seed={seed} L{li} ({source})"
            got, want = kernel_vs_plain(
                "sspnna_fused", lambda: fused(*args, **kw),
                lambda: plain(*args, **kw), what)
            abs_err, rel_err = max_err(got, want)
            check(rel_err <= KERNEL_TOL, f"{what}: kernel disagrees")
            worst_abs = max(worst_abs, abs_err)
            _, p = inputs[li]
            ref = engine.sparse_conv(x, p, cp, backend="reference")
            ref_abs, ref_rel = max_err(out, ref)
            check(ref_rel <= KERNEL_TOL, f"{what}: the conv disagrees with "
                  "reference on the same plan")
            dev_ms = device_ms(lambda: fused(*args, **kw), 20)
            b_ms, b_by = sspnna_bound(*args, kw["n_out"])
            eng_ms = None
            if lvl.sub.dispatch.backend == engine.SSPNNA:
                eng_args = (x, p.weight, *lvl.sub.tiles)
                eng_ms = device_ms(lambda: fused(*eng_args, **kw), 20)
            d, t = cp.dispatch, args[4].shape[0]
            print(f"{what}: T={t} dO={d.delta_o} dI={d.delta_i}: kernel "
                  f"{dev_ms:.4f} ms on the device (the engine's SOAR plan of "
                  f"the level: "
                  + (f"{eng_ms:.4f} ms, T={lvl.sub.dispatch.n_tiles} "
                     f"dO={lvl.sub.dispatch.delta_o} "
                     f"dI={lvl.sub.dispatch.delta_i}" if eng_ms is not None
                     else lvl.sub.dispatch.backend)
                  + f"); bound {b_ms:.4f} ms ({b_by}); kernel vs plain max "
                  f"abs {abs_err:.3g} rel {rel_err:.3g}, conv vs reference "
                  f"max abs {ref_abs:.3g} rel {ref_rel:.3g} (tol {KERNEL_TOL})")
            rows.append({"seed": seed, "level": li, "source": source,
                         "n_tiles": int(t), "delta_o": d.delta_o,
                         "delta_i": d.delta_i, "device_ms": dev_ms,
                         "engine_device_ms": eng_ms, "bound_ms": b_ms,
                         "bound_by": b_by, "max_abs_err": abs_err,
                         "reference_max_abs_err": ref_abs})
    del outs, inputs
    print(f"SCN dataflow: sspnna_fused launches {launches} "
          f"({sum(r['source'] == 'hierarchical' for r in rows)} hierarchical, "
          f"{sum(r['source'] == 'lookup' for r in rows)} looked up); phase "
          f"{time.perf_counter() - t_phase:.1f} s")
    return {"launches": launches, "max_abs_err": worst_abs,
            "plans": rows, "lookups": lookups,
            "fetches": [{"seed": s, "level": li, **m["fetches"],
                         "fit_alpha": m["fit"][0], "fit_corr": m["fit"][1]}
                        for (s, li), m in lv.items()]}


def fused_breakdown(calls) -> dict[str, float]:
    """Device time (ms) of the recorded ``sspnna_fused`` calls, summed: the
    kernel as the port builds it ("full") and each of ``BREAKDOWN_BUILDS``,
    launched through their C entries on the same inputs. What the timing
    builds write is wrong by design and not read; the wrapper's launch
    count does not move."""
    from repro_torch.kernels import build
    from repro_torch.kernels.sspnna import sspnna

    totals = {}
    for label, defines in {"full": (), **BREAKDOWN_BUILDS}.items():
        fn = build.load(sspnna.KERNEL, defines).sspnna_fused_f32
        fn.argtypes, fn.restype = sspnna.FUSED_ARGTYPES, ctypes.c_int
        totals[label] = 0.0
        for args, kw in calls:
            feats, weights, _, in_rows, local_idx, _ = args
            t, d_o, k = local_idx.shape
            n, n_out = weights.shape[2], kw["n_out"]
            out = torch.zeros((n_out + 1, n), device=feats.device)
            ptrs = [x.data_ptr() for x in (*args, out)]
            stream = torch.cuda.current_stream().cuda_stream
            shape = (t, d_o, in_rows.shape[1], k, feats.shape[1], n, n_out)

            def run():
                check(fn(*ptrs, *shape, stream) == 0,
                      f"sspnna_fused {label} build failed to launch")

            totals[label] += device_ms(run, 20)
    return totals


def tiles_bound(feats, local_idx, weights, peak=PEAK_FP32_FLOPS):
    """Least time (ms) for one ``sspnna_tiles`` launch, and what bounds it:
    ``launch.roofline.sspnna_tiles_work`` (2*C*N FLOPs per pair against
    the referenced rows of the stack, W and local_idx read once and the
    output written once) at the fp32 peak (or ``peak``) and the memory
    rate."""
    return sspnna_tiles_work(feats, local_idx, weights).bound(peak)


def pregathered_path(dev: torch.device, phase: Phases, seed0: dict) -> dict:
    """Phases 5-6: ``sspnna_tiles`` on random stacks, then the pre-gathered
    path on seed 0's scene: the standalone layer path (COIR, strided and
    transposed tables built on the card, ``conv_plan_for_layer``,
    ``sparse_conv``), every recorded fused call through
    ``run_sspnna_conv(fused=False)`` and a plane-split conv at each level,
    each launch replayed against the plain version and timed, and the
    whole forward with ``use_kernel=False``. Returns the kernel's JSON
    entry."""
    from repro_torch import engine
    from repro_torch.core import soar
    from repro_torch.core.sparse_conv import (
        SparseConvParams,
        init_sparse_conv,
        reference_conv_cirf,
        strided_conv,
        submanifold_coir,
        transposed_coir,
    )
    from repro_torch.core.tiles import build_tile_plan, modeled_hbm_bytes
    from repro_torch.kernels.sspnna import ops, sspnna
    from repro_torch.kernels.sspnna.ref import TILE_STACK_CASES, random_tile_stack
    from repro_torch.sparse.tensor import SparseVoxelTensor

    tiles, plain = sspnna.sspnna_tiles, sspnna.sspnna_tiles_plain
    fused = sspnna.sspnna_fused
    cfg, model, host, plan = (seed0[k] for k in ("cfg", "model", "host", "plan"))

    phase("sspnna_tiles random stacks")
    worst_abs = 0.0
    rng = np.random.default_rng(0)
    for t, d_i, d_o, k, c, n, dt in TILE_STACK_CASES:
        feats, idx, w = (x.to(dev) for x in random_tile_stack(
            rng, t=t, d_i=d_i, d_o=d_o, k=k, c=c, n=n, dtype=dt))
        got, want = kernel_vs_plain(
            "sspnna_tiles", lambda: tiles(feats, idx, w),
            lambda: plain(feats, idx, w), f"random stack T={t}")
        torch.cuda.synchronize()
        abs_err, rel_err = max_err(got.float(), want.float())
        dead = int((idx < 0).all(dim=(1, 2)).sum())
        print(f"random stack T={t} dI={d_i} dO={d_o} K={k} C={c} N={n} "
              f"{str(dt).removeprefix('torch.')} all-hole tiles={dead}: max "
              f"abs {abs_err:.3g} rel {rel_err:.3g} (tol {TILES_TOL[dt]})")
        check(rel_err <= TILES_TOL[dt], "sspnna_tiles disagrees with its "
              "plain version")
        worst_abs = max(worst_abs, abs_err)

    phase("SSpNNA pre-gathered")
    # host: each tiled level's SOAR order (the planner's own: order="soar",
    # chunk 512), its tile plan rebuilt (for the modeled bytes) and a
    # plane-split plan (delta_i one below the level's largest working set)
    levels = {}
    for li, lvl in enumerate(host.levels):
        if lvl.sub.tiles is None:
            continue
        idx, mask = lvl.sub.coir.indices, lvl.mask
        d = lvl.sub.dispatch
        order = soar.soar_order(idx, mask, 512).order
        tp = build_tile_plan(idx, order, d.delta_o, d.delta_i)
        check(np.array_equal(tp.local_idx, lvl.sub.tiles.local_idx),
              f"level {li}: rebuilt tile plan differs from the scene plan's")
        split_di = int((idx >= 0).sum(1).max()) - 1
        split = build_tile_plan(idx, order, d.delta_o, split_di)
        print(f"level {li}: plane-split plan dO={d.delta_o} dI={split_di}: "
              f"T={split.n_tiles}, n_row_splits={split.n_row_splits}")
        check(split.n_row_splits > 0, f"level {li}: no plane split")
        levels[li] = (order, tp, split)

    recorded = []  # (args, kw) of every sspnna_tiles call on the main path

    def record(*args, **kw):
        recorded.append((args, kw))
        return tiles(*args, **kw)

    check(0 in levels, "level 0 is not tiled")
    calls = seed0["calls"]
    level_of = [next(li for li, lvl in enumerate(plan.levels)
                     if lvl.sub.tiles is not None
                     and lvl.sub.tiles.local_idx is args[4])
                for args, _ in calls]
    first_call = {li: i for i, li in reversed(list(enumerate(level_of)))}
    zero_kernel_counts()
    ops.sspnna_tiles = record
    try:
        with torch.inference_mode():
            # the standalone layer path at level 0, tables built on the card
            lvl0, res = host.levels[0], cfg.resolution
            t0 = SparseVoxelTensor(*(torch.from_numpy(x).to(dev) for x in (
                lvl0.coords, seed0["feats"], lvl0.mask)))
            coir = submanifold_coir(t0, res)
            down = init_sparse_conv(torch.Generator().manual_seed(1), 8,
                                    cfg.in_channels, cfg.widths[1], device=dev)
            coarse, _, down_coir = strided_conv(t0, res, down)
            down_ref = engine.sparse_conv(t0.feats, down, plan.levels[0].down)
            up_coir = transposed_coir(coarse, t0.coords, t0.mask, res)
            d = lvl0.sub.dispatch
            cp = engine.conv_plan_for_layer(coir, levels[0][0], d.delta_o,
                                            d.delta_i, device=dev)
            stem = model.stem.params
            layer_fused = engine.sparse_conv(t0.feats, stem, cp, backend="sspnna")
            layer_pg = ops.run_sspnna_conv(
                t0.feats, stem.weight, cp.tiles.out_rows, cp.tiles.in_rows,
                cp.tiles.local_idx, n_out=cfg.capacity, fused=False)
            # every recorded fused call of the forward, pre-gathered
            pg_out = [ops.run_sspnna_conv(*args[:5], n_out=kw["n_out"],
                                          fused=False)
                      for args, kw in calls]
            # a plane-split conv at each level, on the level's first
            # recorded call's input and weights
            split_out = {}
            for li, (_, _, split) in levels.items():
                x, w = calls[first_call[li]][0][:2]
                split_out[li] = ops.run_sspnna_conv(
                    x, w, *(torch.from_numpy(a).to(dev) for a in (
                        split.out_rows, split.in_rows, split.local_idx)),
                    n_out=cfg.capacity, fused=False)
            torch.cuda.synchronize()
    finally:
        ops.sspnna_tiles = tiles
    main_launches = tiles.launches
    expected = 1 + len(calls) + len(levels)
    print(f"pre-gathered path: sspnna_tiles launches {main_launches} "
          f"(calls {len(recorded)}: 1 standalone layer, {len(calls)} "
          f"recorded convs, {len(levels)} plane-split convs); sspnna_fused "
          f"launches {fused.launches}")
    check(main_launches == expected == len(recorded),
          f"sspnna_tiles launched {main_launches} times for {expected} calls")
    check(fused.launches == 1, "the standalone sparse_conv did not launch "
          "the fused kernel once")

    # the standalone layer path's tables against the host planner's
    host_tables = [(coir.indices, lvl0.sub.coir.indices, "submanifold COIR"),
                   (coir.bitmask, lvl0.sub.coir.bitmask.astype(np.int32),
                    "submanifold bitmask"),
                   (coarse.coords, host.levels[1].coords, "downsampled coords"),
                   (coarse.mask, host.levels[1].mask, "downsampled mask"),
                   (down_coir.indices, lvl0.down.coir.indices, "strided COIR"),
                   (up_coir.indices, lvl0.up.coir.indices, "transposed COIR"),
                   (cp.tiles.local_idx, lvl0.sub.tiles.local_idx, "tile plan")]
    for got, want, what in host_tables:
        check(np.array_equal(got.cpu().numpy(), want),
              f"{what} built on the card differs from the host planner's")
    mask0 = t0.mask.unsqueeze(-1)
    abs_err, rel_err = max_err((layer_pg + stem.bias) * mask0, layer_fused)
    ref = reference_conv_cirf(t0.feats, coir, stem)
    print(f"standalone layer path: {int(t0.mask.sum())} voxels, tables equal "
          f"to the host planner's; sspnna_fused vs reference max abs "
          f"{max_err(layer_fused, ref)[0]:.3g}; pre-gathered vs fused max abs "
          f"{abs_err:.3g} rel {rel_err:.3g} (tol {KERNEL_TOL})")
    check(rel_err <= KERNEL_TOL, "standalone pre-gathered conv disagrees")
    check(max_err(layer_fused * mask0, ref)[1] <= KERNEL_TOL,
          "standalone sparse_conv disagrees with reference")
    check(max_err(coarse.feats, down_ref)[1] <= KERNEL_TOL,
          "strided_conv disagrees with the scene plan's down conv")

    # every recorded conv, in the three arms of the JAX package's SSpNNA
    # benchmark (fused, pre-gathered, plain): pre-gathered and plain
    # against fused; each launch against its plain version at its real
    # inputs; times, bound, yardstick
    # per launch: level, kernel, plain, conv, bound, by, matmul, fused,
    # oracle (calls), bound at 3xTF32, kernel, matmul and plain device ms
    rows = []
    with torch.inference_mode():
        for i, ((args, kw), got) in enumerate(zip(calls, pg_out)):
            want, oracle = kernel_vs_plain(
                "sspnna_fused", lambda: fused(*args, **kw),
                lambda: ops.run_sspnna_conv(*args[:5], n_out=kw["n_out"],
                                            use_kernel=False), f"conv {i}")
            abs_err, rel_err = max_err(got, want)
            check(rel_err <= KERNEL_TOL, f"conv {i}: pre-gathered disagrees "
                  "with fused")
            check(max_err(oracle, want)[1] <= KERNEL_TOL,
                  f"conv {i}: the plain arm disagrees with fused")
            (tf, idx, w), _ = recorded[1 + i]
            k_out, p_out = kernel_vs_plain(
                "sspnna_tiles", lambda: tiles(tf, idx, w),
                lambda: plain(tf, idx, w), f"conv {i}")
            k_abs, k_rel = max_err(k_out, p_out)
            check(k_rel <= KERNEL_TOL, f"conv {i}: sspnna_tiles disagrees "
                  "with its plain version")
            worst_abs = max(worst_abs, k_abs)
            ms = time_ms(lambda: tiles(tf, idx, w), 20)
            pms = time_ms(lambda: plain(tf, idx, w), 5)
            dev_ms = device_ms(lambda: tiles(tf, idx, w), 20)
            plain_dev_ms = device_ms(lambda: plain(tf, idx, w), 5)
            conv_ms = time_ms(lambda: ops.run_sspnna_conv(
                *args[:5], n_out=kw["n_out"], fused=False), 10)
            fused_ms = time_ms(lambda: fused(*args, **kw), 10)
            oracle_ms = time_ms(lambda: ops.run_sspnna_conv(
                *args[:5], n_out=kw["n_out"], use_kernel=False), 5)
            t, d_o, k = idx.shape
            c, n = tf.shape[2], w.shape[2]
            g = torch.gather(tf, 1, idx.clamp(min=0).long().reshape(
                t, d_o * k, 1).expand(t, d_o * k, c))
            g = torch.where((idx >= 0).reshape(t, d_o * k, 1), g, 0.0)
            g = g.reshape(t * d_o, k * c)
            mm_ms = time_ms(lambda: torch.matmul(g, w.reshape(k * c, n)), 20)
            mm_dev_ms = device_ms(lambda: torch.matmul(g, w.reshape(k * c, n)),
                                  20)
            del g
            b_ms, b_by = tiles_bound(tf, idx, w)
            b3_ms = tiles_bound(tf, idx, w, PEAK_TF32X3_FLOPS)[0]
            li = level_of[i]
            hbm = modeled_hbm_bytes(levels[li][1], c, n)
            pairs = int((idx >= 0).sum())
            print(f"conv {i} L{li} C={c} N={n} T={t} dO={d_o} dI={tf.shape[1]} "
                  f"pairs={pairs}: kernel {ms:.4f} ms a call, {dev_ms:.4f} "
                  f"ms on the device "
                  f"({launch_shape(sspnna.TILES_KERNEL, t, d_o, k, c, n)}, "
                  f"{2e-9 * pairs * c * n / dev_ms:.2f} TFLOP/s of useful "
                  f"pairs); plain {pms:.4f} ms a call, {plain_dev_ms:.4f} ms "
                  f"on the device; bound {b_ms:.4f} ms ({b_by}; {b3_ms:.4f} "
                  f"ms at 3xTF32); matmul of the gathered block {mm_ms:.4f} "
                  f"ms a call, {mm_dev_ms:.4f} ms on the device; whole conv "
                  f"(calls): fused "
                  f"{fused_ms:.4f} ms, pre-gathered {conv_ms:.4f} ms, plain "
                  f"arm {oracle_ms:.4f} ms; pre-gathered vs fused max abs "
                  f"{abs_err:.3g}, kernel vs plain max abs {k_abs:.3g}; "
                  f"modeled bytes fused {hbm['fused']} pre-gathered "
                  f"{hbm['pregathered']}")
            rows.append((li, ms, pms, conv_ms, b_ms, b_by, mm_ms, fused_ms,
                         oracle_ms, b3_ms, dev_ms, mm_dev_ms, plain_dev_ms))
    for li in sorted({r[0] for r in rows}):
        mine = [r for r in rows if r[0] == li]
        print(f"level {li}: {len(mine)} launches, kernel "
              f"{sum(r[1] for r in mine):.4f} ms in calls, "
              f"{sum(r[10] for r in mine):.4f} ms on the device; plain "
              f"{sum(r[2] for r in mine):.4f} ms in calls, "
              f"{sum(r[12] for r in mine):.4f} ms on the device; bound "
              f"{sum(r[4] for r in mine):.4f} ms ("
              f"{sum(r[9] for r in mine):.4f} ms at 3xTF32), matmul "
              f"{sum(r[6] for r in mine):.4f} ms in calls, "
              f"{sum(r[11] for r in mine):.4f} ms on the device; whole convs "
              f"(calls): fused "
              f"{sum(r[7] for r in mine):.4f} ms, pre-gathered "
              f"{sum(r[3] for r in mine):.4f} ms, plain arm "
              f"{sum(r[8] for r in mine):.4f} ms per forward")

    # plane-split convs against the reference product (no bias, masked)
    with torch.inference_mode():
        for j, (li, out) in enumerate(split_out.items()):
            (tf, idx, w), _ = recorded[1 + len(calls) + j]
            k_abs, k_rel = max_err(*kernel_vs_plain(
                "sspnna_tiles", lambda: tiles(tf, idx, w),
                lambda: plain(tf, idx, w), f"plane-split L{li}"))
            check(k_rel <= KERNEL_TOL, f"level {li}: split launch disagrees")
            worst_abs = max(worst_abs, k_abs)
            x, wt = calls[first_call[li]][0][:2]
            lvl = plan.levels[li]
            ref = reference_conv_cirf(x, lvl.sub.coir, SparseConvParams(
                wt, torch.zeros(wt.shape[2], device=dev)))
            abs_err, rel_err = max_err(out * lvl.mask.unsqueeze(-1), ref)
            ms = time_ms(lambda: tiles(tf, idx, w), 10)
            print(f"plane-split L{li}: T={tf.shape[0]} n_row_splits="
                  f"{levels[li][2].n_row_splits}: kernel {ms:.4f} ms; conv vs "
                  f"reference max abs {abs_err:.3g} rel {rel_err:.3g} (tol "
                  f"{KERNEL_TOL}); kernel vs plain max abs {k_abs:.3g}")
            check(rel_err <= KERNEL_TOL, f"level {li}: plane-split conv "
                  "disagrees with the reference product")

    # the whole forward through the oracle branch: no kernel launches
    before = tiles.launches, fused.launches
    with torch.inference_mode():
        logits = engine.apply_unet(model, seed0["feats"], plan,
                                   use_kernel=False, device=dev)
        torch.cuda.synchronize()
        fwd_ms = host_ms(lambda: engine.apply_unet(
            model, seed0["feats"], plan, use_kernel=False, device=dev), 3)
    check((tiles.launches, fused.launches) == before,
          "use_kernel=False launched a kernel")
    abs_err, rel_err = max_err(logits, seed0["logits"])
    print(f"forward use_kernel=False: logits vs auto max abs {abs_err:.3g} "
          f"rel {rel_err:.3g} (tol {LOGITS_TOL}); {fwd_ms:.3f} ms (median of "
          "3, host clock after synchronize)")
    check(rel_err <= LOGITS_TOL, "use_kernel=False logits disagree with auto")
    by_bytes = sum(r[4] for r in rows if r[5] == "bytes")
    by_ops = sum(r[4] for r in rows if r[5] == "operations")
    return {
        "name": "sspnna_tiles",
        "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/sspnna_tiles.cu",
        "replaces": "src/repro/kernels/sspnna/sspnna.py:93",
        "launches": main_launches,
        "max_abs_err": worst_abs,
        # summed over the launches of one forward's recorded convs (seed 0),
        # calls through the wrapper, host included (time_ms), and
        # *device_ms the device alone (device_ms); library_ms is
        # torch.matmul of the already-gathered (T*dO, K*C) block, a
        # yardstick the port never calls
        "ms": sum(r[1] for r in rows),
        "plain_ms": sum(r[2] for r in rows),
        "bound_ms": by_bytes + by_ops,
        "bound_by": "bytes" if by_bytes >= by_ops else "operations",
        "library_ms": sum(r[6] for r in rows),
        "device_ms": sum(r[10] for r in rows),
        "plain_device_ms": sum(r[12] for r in rows),
        "library_device_ms": sum(r[11] for r in rows),
        "bound_tf32x3_ms": sum(r[9] for r in rows),
        # the three arms of the whole conv, summed the same way
        "conv_fused_ms": sum(r[7] for r in rows),
        "conv_pregathered_ms": sum(r[3] for r in rows),
        "conv_plain_ms": sum(r[8] for r in rows),
    }


def scn_serving_path(dev: torch.device, phase: Phases, model, cfg):
    """Phase 7: SCN batched serving. Pins a spec from seeds 0-2, serves
    them as one wave of 3 through a ``SceneEngine``, blocking and then
    pipelined on the same context (the second serve hits the plan cache),
    holds the wave's logits against each scene's own ``apply_unet`` on the
    same pinned plans and against ``backend="reference"``, and times the
    wave eagerly and as the bucket's graph replay. Each ``sspnna_fused``
    launch of the wave is held against the plain version and timed on the
    device. Returns the numbers for the kernel's JSON entry, the spec, the
    scenes and the blocking serve's wave logits."""
    from repro_torch import engine
    from repro_torch.data.scenes import make_scene
    from repro_torch.kernels.sspnna import ops, sspnna
    from repro_torch.serving.scene_engine import SceneEngine, SceneRequest
    from repro_torch.sparse.tensor import SparseVoxelTensor

    fused, plain = sspnna.sspnna_fused, sspnna.sspnna_fused_plain
    phase("SCN serving: spec")
    scenes = []
    for seed in SEEDS:
        coords, feats, _, mask = make_scene(seed, RESOLUTION, CAPACITY,
                                            points_per_unit=POINTS_PER_UNIT)
        scenes.append(SparseVoxelTensor(coords, feats, mask))
    t0 = time.perf_counter()
    spec = engine.build_plan_spec(scenes, cfg)
    print(f"plan spec pinned from seeds {SEEDS} in "
          f"{time.perf_counter() - t0:.1f} s: " + "; ".join(
              f"L{li} {d.backend}" + (f" dO={d.delta_o} dI={d.delta_i} "
                                      f"T={d.n_tiles}"
                                      if d.backend == engine.SSPNNA else "")
              for li, d in enumerate(spec.levels)))

    phase("SCN serving")
    ctx = engine.ExecutionContext(device=dev)
    # the serving path's counts: set to 0 here, read after both serves
    zero_kernel_counts()
    runs = {}
    with torch.inference_mode():
        for sync in (True, False):
            eng = SceneEngine(cfg, model, len(scenes), spec=spec, ctx=ctx,
                              sync=sync)
            hits, misses = ctx.plan_cache.hits, ctx.plan_cache.misses
            handles = eng.submit([SceneRequest(seed, t)
                                  for seed, t in zip(SEEDS, scenes)])
            t0 = time.perf_counter()
            eng.serve()
            torch.cuda.synchronize()
            wall_s = time.perf_counter() - t0
            logits = np.stack([h.result().logits for h in handles])
            eng.close()
            st = eng.wave_stats
            print(f"serve sync={sync}: {len(st)} wave of {len(scenes)} "
                  f"scenes in {wall_s:.3f} s; plan cache "
                  f"{ctx.plan_cache.misses - misses} misses, "
                  f"{ctx.plan_cache.hits - hits} hits, plan stage "
                  f"{sum(x.plan_ms for x in st):.1f} ms; graphs "
                  f"{len(eng.graphs)}, replays {eng.graphs.replays}, "
                  f"sspnna_fused launches a replay "
                  f"{eng.graphs.launches(only_graph(eng))['sspnna_fused']}")
            check(len(st) == 1 and eng.n_compilations == 1
                  and len(eng.graphs) == 1, "one wave, one graph expected")
            check_no_breakers(eng)
            check(logits.shape == (len(scenes), CAPACITY, cfg.n_classes)
                  and bool(np.isfinite(logits).all()),
                  "wave logits not finite or of the wrong shape")
            runs[sync] = (eng, logits, wall_s, sum(x.plan_ms for x in st))
    check(ctx.plan_cache.misses == len(scenes)
          and ctx.plan_cache.hits == len(scenes),
          "the second serve did not hit the plan cache")
    check(np.array_equal(runs[True][1], runs[False][1]),
          "sync and async serving gave other logits")
    engines = [r[0] for r in runs.values()]
    # a replay ticks no counter: the graphs count what their replays ran
    captured = sum(e.graphs.captured["sspnna_fused"] for e in engines)
    replayed = sum(e.graphs.replayed["sspnna_fused"] for e in engines)
    launched = fused.launches - captured + replayed
    print(f"SCN serving path: sspnna_fused counter {fused.launches} "
          f"(warm-ups and {captured} recorded at capture), {replayed} run by "
          f"replays: {launched} launches on the device")
    check(replayed > 0 and captured > 0, "the wave did not run sspnna_fused "
          "inside the bucket's graph")
    check(launched_only("sspnna_fused"),
          "the SCN serving path launched another kernel")
    print(f"plan cache: a miss costs {runs[True][3] / len(scenes):.1f} ms of "
          f"plan stage a scene, a hit {runs[False][3] / len(scenes):.3f} ms")

    phase("SCN serving checks")
    plan_kw = dict(spec=spec, plan_tiles=True, order="soar", soar_chunk=512)
    with torch.inference_mode():
        plans = [ctx.plan_cache.get_or_build(
            t, cfg, device=dev, topology=ctx.topology_key(), **plan_kw)
            for t in scenes]
        feats = [torch.from_numpy(t.feats).to(dev) for t in scenes]
        for i, seed in enumerate(SEEDS):
            wave = torch.from_numpy(runs[True][1][i]).to(dev)
            own, ref = kernel_vs_plain(
                "sspnna_fused",
                lambda: engine.apply_unet(model, feats[i], plans[i],
                                          device=dev),
                lambda: engine.apply_unet(model, feats[i], plans[i],
                                          backend="reference", device=dev),
                f"served seed {seed}")
            _, own_err = max_err(wave, own)
            _, ref_err = max_err(wave, ref)
            print(f"seed {seed}: wave logits vs its own apply_unet on the "
                  f"pinned plan rel {own_err:.3g} (tol {WAVE_TOL}), vs "
                  f"reference rel {ref_err:.3g} (tol {LOGITS_TOL})")
            check(own_err <= WAVE_TOL, "wave and per-scene logits disagree")
            check(ref_err <= LOGITS_TOL, "wave and reference logits disagree")

    phase("SCN serving timing")
    eng = runs[True][0]
    n = len(scenes)
    with torch.inference_mode():
        def eager():
            return engine.apply_unet(model, torch.cat(feats),
                                     engine.stack_plans(plans), device=dev)

        def graph():
            return eng.run_wave(feats, plans, cfg.capacity)

        _, g_err = max_err(graph()[0], eager())
        check(g_err <= 1e-5, "graph replay and eager wave disagree")
        times = {}
        for name, fn in (("eager", eager), ("graph", graph)):
            wall = host_ms(fn, 5)
            times[name] = {"ms": wall, "device_ms": device_ms(fn, 2)}
            print(f"wave of {n}, {name}: {wall:.3f} ms ({wall / n:.3f} ms a "
                  f"scene; host clock after synchronize, median of 5), "
                  f"device span {times[name]['device_ms']:.3f} ms (calls "
                  f"queued behind a spin)")
            times[name].update(busy_report(f"wave of {n}, {name}", fn, wall))

        def one():
            return engine.apply_unet(model, feats[0], plans[0], device=dev)

        one_ms = host_ms(one, 5)
        print(f"one scene's forward on its pinned plan: {one_ms:.3f} ms")
        one_busy = busy_report("one scene's forward", one, one_ms)
        # the wave's kernel launches at their real inputs
        calls = []

        def record(*args, **kw):
            calls.append((args, kw))
            return fused(*args, **kw)

        ops.sspnna_fused = record
        try:
            eager()
            for i in range(n):
                engine.apply_unet(model, feats[i], plans[i], device=dev)
        finally:
            ops.sspnna_fused = fused
        per_wave = len(calls) // (n + 1)
        check(per_wave == eng.graphs.launches(only_graph(eng))["sspnna_fused"],
              "the graph records another number of launches than the eager "
              "wave makes")
        wave_dev = own_dev = bound = 0.0
        worst_abs = 0.0
        dead = sum(int((args[5] == 0).sum()) for args, _ in calls[:per_wave])
        tiles = sum(args[5].numel() for args, _ in calls[:per_wave])
        for j, (args, kw) in enumerate(calls):
            d_ms = device_ms(lambda: fused(*args, **kw), 10)
            if j < per_wave:
                abs_err, rel_err = max_err(*kernel_vs_plain(
                    "sspnna_fused", lambda: fused(*args, **kw),
                    lambda: plain(*args, **kw), f"wave launch {j}"))
                check(rel_err <= KERNEL_TOL, f"wave launch {j} disagrees")
                worst_abs = max(worst_abs, abs_err)
                wave_dev += d_ms
                bound += sspnna_bound(*args, kw["n_out"])[0]
            else:
                own_dev += d_ms
    print(f"sspnna_fused per wave: {per_wave} launches, {wave_dev:.4f} ms on "
          f"the device (bound {bound:.4f} ms); the three scenes' own "
          f"forwards on the pinned plans {own_dev:.4f} ms; {dead} of the "
          f"wave's {tiles} tiles are dead (pinned budgets); max abs "
          f"{worst_abs:.3g} against the plain version")
    entry = {"serving_launches": launched,
              "wave_launches": per_wave,
             "wave_device_ms": wave_dev,
             "wave_bound_ms": bound,
             "pinned_scenes_device_ms": own_dev,
             "wave_max_abs_err": worst_abs,
             "wave_dead_tiles": [dead, tiles],
             "wave": times,
             "scene": {"ms": one_ms, **one_busy}}
    return entry, spec, scenes, runs[True][1]


def scn_stream_path(dev: torch.device, phase: Phases, model, cfg) -> dict:
    """Phase 8: SCN streaming. Pins a spec from the first frame of two
    LiDAR sweeps, serves both sweeps as streams through a ``SceneEngine``
    (each wave one frame of each stream), blocking and then pipelined, and
    checks modes, bits, the graph and the kernel: every wave must be a
    replay of the bucket's one graph, which runs ``sspnna_fused`` once per
    sspnna conv. Stream 0's patched tables are held against a from-scratch
    build of the re-packed frame, and its logits against its own
    ``apply_unet`` and ``reference``. Times the host plans (patched against
    from scratch), the sweep, a stream wave's replay and its kernel
    launches beside their bound. Returns the numbers for the kernel's JSON
    entry."""
    from repro_torch import engine
    from repro_torch.core.host_meta import pack_stream_frame_np
    from repro_torch.data.scenes import make_lidar_sweep
    from repro_torch.engine.plan import plan_leaves
    from repro_torch.kernels.sspnna import ops, sspnna
    from repro_torch.serving.graphs import COUNTED
    from repro_torch.serving.scene_engine import SceneEngine
    from repro_torch.sparse.tensor import PAD_COORD, SparseVoxelTensor

    fused, plain = sspnna.sspnna_fused, sspnna.sspnna_fused_plain
    n_streams, n_frames = len(STREAM_SEEDS), STREAM_FRAMES
    phase("SCN streaming: spec")
    sweeps = []
    for seed in STREAM_SEEDS:
        frames, shifts = make_lidar_sweep(
            seed, n_frames, resolution=RESOLUTION, capacity=CAPACITY,
            step=STREAM_STEP, churn=STREAM_CHURN)
        sweeps.append(([SparseVoxelTensor(c, f, m) for c, f, _, m in frames],
                       shifts))
    print("sweeps: " + "; ".join(
        f"seed {seed}: " + ", ".join(str(int(t.mask.sum())) for t in sc)
        + " active voxels" for seed, (sc, _) in zip(STREAM_SEEDS, sweeps)))
    t0 = time.perf_counter()
    spec = engine.build_plan_spec([sc[0] for sc, _ in sweeps], cfg)
    print(f"plan spec pinned from the sweeps' first frames in "
          f"{time.perf_counter() - t0:.1f} s: " + "; ".join(
              f"L{li} {d.backend}" + (f" dO={d.delta_o} dI={d.delta_i} "
                                      f"T={d.n_tiles}"
                                      if d.backend == engine.SSPNNA else "")
              for li, d in enumerate(spec.levels)))
    check(any(d.backend == engine.SSPNNA for d in spec.levels),
          "the stream spec sends no level to sspnna")

    phase("SCN streaming")
    ctx = engine.ExecutionContext(device=dev)
    # the streaming path's counts: set to 0 here, read after both serves
    zero_kernel_counts()
    runs = {}
    with torch.inference_mode():
        for sync in (True, False):
            eng = SceneEngine(cfg, model, n_streams, spec=spec, ctx=ctx,
                              sync=sync, planner_threads=n_streams)
            streams = [eng.open_stream(f"lidar{s}") for s in STREAM_SEEDS]
            handles = [[] for _ in streams]
            t0 = time.perf_counter()
            for fno in range(n_frames):  # frame by frame, streams in turn
                for i, (scenes, shifts) in enumerate(sweeps):
                    handles[i].append(streams[i].submit(scenes[fno],
                                                        shifts[fno]))
            eng.serve()
            torch.cuda.synchronize()
            wall_s = time.perf_counter() - t0
            reqs = [[h.result() for h in hs] for hs in handles]
            eng.close()
            modes = [[r.plan_info["mode"] for r in rs] for rs in reqs]
            st = eng.wave_stats
            lat = sorted(r.latency_ms for rs in reqs for r in rs)
            print(f"stream serve sync={sync}: {n_streams * n_frames} frames "
                  f"in {len(st)} waves, {wall_s:.3f} s ("
                  f"{n_streams * n_frames / wall_s:.3f} frames/s, "
                  f"{1e3 * wall_s / (n_streams * n_frames):.1f} ms a frame; "
                  f"request latency median {statistics.median(lat):.1f} ms, "
                  f"max {lat[-1]:.1f} ms); modes {modes}; plan stage "
                  f"{sum(x.plan_ms for x in st):.1f} ms; graphs "
                  f"{len(eng.graphs)}, replays {eng.graphs.replays}")
            check(all(m == ["rebuilt"] + ["patched"] * (n_frames - 1)
                      for m in modes),
                  f"stream modes {modes}, expected rebuilt then patched")
            check(len(st) == n_frames
                  and all(len(x.rids) == n_streams for x in st),
                  "a stream wave did not hold one frame of each stream")
            check(eng.n_compilations == 1 and len(eng.graphs) == 1
                  and eng.graphs.replays == n_frames,
                  "stream waves did not replay one bucket graph")
            check_no_breakers(eng)
            logits = np.stack([[r.logits for r in rs] for rs in reqs])
            check(logits.shape == (n_streams, n_frames, CAPACITY,
                                   cfg.n_classes)
                  and bool(np.isfinite(logits).all()),
                  "stream logits not finite or of the wrong shape")
            runs[sync] = (eng, reqs, logits, wall_s, modes)
    check(np.array_equal(runs[True][2], runs[False][2])
          and runs[True][4] == runs[False][4],
          "blocking and pipelined streams gave other logits or modes")
    engines = [r[0] for r in runs.values()]
    expected = sspnna_convs(ctx.plan_cache.adopt(
        runs[True][1][0][0].plan_key, None, device=False), cfg)
    per_replay = engines[0].graphs.launches(only_graph(engines[0]))
    captured = sum(e.graphs.captured["sspnna_fused"] for e in engines)
    replayed = sum(e.graphs.replayed["sspnna_fused"] for e in engines)
    launched = fused.launches - captured + replayed
    print(f"SCN streaming path: sspnna_fused counter {fused.launches} "
          f"(warm-ups and {captured} recorded at capture), {replayed} run by "
          f"replays ({per_replay['sspnna_fused']} a replay, {expected} "
          f"sspnna convs a frame): {launched} launches on the device")
    check(replayed > 0 and per_replay["sspnna_fused"] == expected,
          "the stream waves did not run sspnna_fused once per sspnna conv "
          "inside the bucket's graph")
    check(launched_only("sspnna_fused")
          and all(e.graphs.replayed[k] == 0 for e in engines
                  for k in COUNTED if k != "sspnna_fused"),
          "the SCN streaming path launched another kernel")

    phase("SCN streaming checks")
    eng, reqs = runs[True][0], runs[True][1]
    plan_rows = []   # (frame, mode, patched ms, from-scratch ms)
    uploads = []
    with torch.inference_mode():
        for r, scene in zip(reqs[0], sweeps[0][0]):
            fr = r._frame_rows
            act = np.flatnonzero(scene.mask)
            pc = np.full_like(scene.coords, PAD_COORD)
            pm = np.zeros_like(scene.mask)
            pc[fr[act]], pm[fr[act]] = scene.coords[act], True
            pf = pack_stream_frame_np(fr, scene.feats)
            t0 = time.perf_counter()
            scratch = engine.build_scene_plan_host(
                SparseVoxelTensor(pc, pf, pm), cfg, spec=spec)
            scratch_ms = (time.perf_counter() - t0) * 1e3
            host = ctx.plan_cache.adopt(r.plan_key, None, device=False)
            got, want = plan_leaves(host), plan_leaves(scratch)
            check(len(got) == len(want) and all(
                a.dtype == b.dtype and np.array_equal(a, b)
                for a, b in zip(got, want)),
                f"frame {r.frame_no}: patched tables differ from a "
                "from-scratch build")
            plan = engine.upload_scene_plan(host, dev)
            feats = torch.from_numpy(pf).to(dev)
            own, ref = kernel_vs_plain(
                "sspnna_fused",
                lambda: engine.apply_unet(model, feats, plan, device=dev),
                lambda: engine.apply_unet(model, feats, plan,
                                          backend="reference", device=dev),
                f"stream frame {r.frame_no}")
            # the frame's own forwards, scattered to the caller's rows as
            # the drain scatters the stream's (inactive rows stay 0)
            canon = torch.from_numpy(fr).to(dev).long()
            live = canon >= 0
            got = torch.from_numpy(r.logits).to(dev)
            own_rows, ref_rows = torch.zeros_like(got), torch.zeros_like(got)
            own_rows[live], ref_rows[live] = own[canon[live]], ref[canon[live]]
            _, own_err = max_err(got, own_rows)
            _, ref_err = max_err(got, ref_rows)
            plan_rows.append((r.frame_no, r.plan_info["mode"],
                              r.plan_info["plan_ms"], scratch_ms))
            uploads.append(r.plan_info["upload"])
            print(f"stream 0 frame {r.frame_no} ({r.plan_info['mode']}, "
                  f"overlap {r.plan_info['overlap']:.4f}): host plan "
                  f"{r.plan_info['plan_ms']:.1f} ms, from scratch "
                  f"{scratch_ms:.1f} ms, tables equal; upload "
                  f"{r.plan_info['upload']['bytes']} of "
                  f"{r.plan_info['upload']['of_bytes']} bytes; logits vs "
                  f"its own apply_unet rel {own_err:.3g} (tol {WAVE_TOL}), "
                  f"vs reference rel {ref_err:.3g} (tol {LOGITS_TOL})")
            check(own_err <= WAVE_TOL, "stream and per-frame logits disagree")
            check(ref_err <= LOGITS_TOL,
                  "stream and reference logits disagree")

    phase("SCN streaming timing")
    last = [rs[-1] for rs in reqs]
    with torch.inference_mode():
        hosts = [ctx.plan_cache.adopt(r.plan_key, None, device=False)
                 for r in last]
        plans = [engine.upload_scene_plan(h, dev) for h in hosts]
        feats = [torch.from_numpy(pack_stream_frame_np(
            r._frame_rows, sweeps[i][0][-1].feats)).to(dev)
            for i, r in enumerate(last)]

        def graph():
            return eng.run_wave(feats, plans, cfg.capacity)

        wall = host_ms(graph, 5)
        dev_span = device_ms(graph, 2)
        print(f"stream wave of {n_streams} frames, graph replay: {wall:.3f} "
              f"ms (host clock after synchronize, median of 5), device span "
              f"{dev_span:.3f} ms (calls queued behind a spin)")
        busy = busy_report(f"stream wave of {n_streams}, graph", graph, wall)
        calls = []

        def record(*args, **kw):
            calls.append((args, kw))
            return fused(*args, **kw)

        ops.sspnna_fused = record
        try:
            engine.apply_unet(model, torch.cat(feats),
                              engine.stack_plans(plans), device=dev)
        finally:
            ops.sspnna_fused = fused
        check(len(calls) == per_replay["sspnna_fused"],
              "the eager stream wave makes another number of launches than "
              "the graph records")
        wave_dev = bound = worst_abs = 0.0
        for j, (args, kw) in enumerate(calls):
            abs_err, rel_err = max_err(*kernel_vs_plain(
                "sspnna_fused", lambda: fused(*args, **kw),
                lambda: plain(*args, **kw), f"stream wave launch {j}"))
            check(rel_err <= KERNEL_TOL, f"stream wave launch {j} disagrees")
            worst_abs = max(worst_abs, abs_err)
            wave_dev += device_ms(lambda: fused(*args, **kw), 10)
            bound += sspnna_bound(*args, kw["n_out"])[0]
    patched = [u for (_, mode, _, _), u in zip(plan_rows, uploads)
               if mode == "patched"]
    print(f"sspnna_fused per stream wave: {len(calls)} launches, "
          f"{wave_dev:.4f} ms on the device (bound {bound:.4f} ms); max abs "
          f"{worst_abs:.3g} against the plain version")
    print(f"uploads through device_plan: a patched frame copies "
          f"{statistics.mean(u['bytes'] for u in patched):.0f} of "
          f"{statistics.mean(u['of_bytes'] for u in patched):.0f} bytes "
          f"({statistics.mean(u['leaves'] for u in patched):.1f} of "
          f"{statistics.mean(u['of_leaves'] for u in patched):.1f} tables)")
    return {"launches": launched,
            "wave_launches": len(calls),
            "sweep_s": {"blocking": runs[True][3],
                        "pipelined": runs[False][3]},
            "frames_per_s": {"blocking": n_streams * n_frames / runs[True][3],
                             "pipelined": n_streams * n_frames
                             / runs[False][3]},
            "host_plan_ms": [{"frame": f, "mode": m, "patched": p,
                              "from_scratch": sc}
                             for f, m, p, sc in plan_rows],
            "upload_bytes": [[u["bytes"], u["of_bytes"]] for u in uploads],
            "wave": {"ms": wall, "device_ms": dev_span, **busy},
            "wave_device_ms": wave_dev,
            "wave_bound_ms": bound,
            "wave_max_abs_err": worst_abs}


def scn_autotune_path(dev: torch.device, phase: Phases, model, cfg, seed0,
                      spec, scenes, served) -> dict:
    """Phases "SCN autotune: measured" and "SCN autotune: reprofile".

    Measured: each level's submanifold conv of seed 0's adaptive plan runs
    through every registered backend (``measure_backends``, CUDA events,
    median of AUTOTUNE_K); the times fill a ``CostTable``, seed 0's plan is
    built again with ``autotune=table``, and the tuned forward is held
    against ``reference`` and timed beside the analytical plan's. The
    table's save/load round trip must load, and refuse another card's
    fingerprint. Reprofile: a cold table records seed 0's signatures as
    misses, a ``SceneEngine`` on the pinned spec serves seeds 0-2 with
    ``autotune_reprofile_ms`` set, and its idle hook profiles the misses on
    synthetic workloads; the synthetic winners are printed beside the real
    plan's. Returns the numbers for the kernel's JSON entry."""
    from repro_torch import engine
    from repro_torch.engine import autotune
    from repro_torch.kernels.sspnna import sspnna
    from repro_torch.serving.scene_engine import SceneEngine, SceneRequest

    fused = sspnna.sspnna_fused
    board = engine.default_registry().breakers
    phase("SCN autotune: measured")
    # the measured path's counts: set to 0 here, read at the phase's end
    zero_kernel_counts()
    host, plan = seed0["host"], seed0["plan"]
    table = autotune.CostTable()
    gen = torch.Generator(device=dev).manual_seed(1)
    levels, real_winner = [], {}
    with torch.inference_mode():
        for li, (lvl, params) in enumerate(zip(plan.levels, model.levels)):
            n, c = host.stats[li]["n_active"], cfg.widths[li]
            sig = autotune.signature(
                n, n, c, c, density=n / float(max(cfg.resolution >> li, 1)) ** 3)
            feats = torch.randn(lvl.mask.shape[0], c, generator=gen,
                                device=dev) * lvl.mask[:, None]
            res = autotune.measure_backends(
                lvl.sub, feats, params.enc[0].conv.params, k=AUTOTUNE_K)
            d = lvl.sub.dispatch
            for name, m in res.items():
                table.record(dataclasses.replace(sig, backend=name),
                             m.median_us, spread_us=m.spread_us, k=m.k,
                             delta_o=d.delta_o, delta_i=d.delta_i)
            win = min(res, key=lambda b: res[b].median_us)
            real_winner[sig.encode()] = win
            print(f"level {li} sig {sig.encode()} (analytical {d.backend}, "
                  f"dO={d.delta_o} dI={d.delta_i} T={d.n_tiles}): " + "; ".join(
                      f"{b} median {m.median_us:.1f} us spread "
                      f"{m.spread_us:.1f} us" for b, m in sorted(res.items()))
                  + f"; winner {win}")
            check(set(res) == {"reference", "sspnna"} or d.backend != "sspnna",
                  f"level {li}: a backend was not measured")
            levels.append({"level": li, "sig": sig.encode(),
                           "analytical": d.backend, "winner": win,
                           **{f"{b}_us": m.median_us
                              for b, m in res.items()},
                           **{f"{b}_spread_us": m.spread_us
                              for b, m in res.items()}})
        t0 = time.perf_counter()
        tuned_host = engine.build_scene_plan_host(scenes[0], cfg,
                                                  autotune=table)
        tuned_s = time.perf_counter() - t0
        check(table.hits == len(plan.levels) and table.miss_count == 0,
              "the tuned build did not hit the table at every level")
        for li, (a, b) in enumerate(zip(host.stats, tuned_host.stats)):
            print(f"level {li}: analytical {a['dispatch'].backend}, tuned "
                  f"{b['dispatch'].backend}")
            levels[li]["tuned"] = b["dispatch"].backend
        tuned = engine.upload_scene_plan(tuned_host, dev)
        feats0 = seed0["feats"]
        logits, ref = kernel_vs_plain(
            "sspnna_fused",
            lambda: engine.apply_unet(model, feats0, tuned, device=dev),
            lambda: engine.apply_unet(model, feats0, tuned,
                                      backend="reference", device=dev),
            "tuned plan")
        check(logits.shape == (CAPACITY, cfg.n_classes)
              and bool(torch.isfinite(logits).all()),
              "tuned logits not finite or of the wrong shape")
        _, tuned_err = max_err(logits, ref)
        check(tuned_err <= LOGITS_TOL, "tuned and reference logits disagree")
        fwd = {name: host_ms(lambda p=p: engine.apply_unet(
            model, feats0, p, device=dev), 5)
            for name, p in (("analytical", plan), ("tuned", tuned))}
    print(f"tuned plan of seed {SEEDS[0]} built in {tuned_s:.1f} s; logits "
          f"vs reference rel {tuned_err:.3g} (tol {LOGITS_TOL}); forward "
          f"analytical {fwd['analytical']:.3f} ms, tuned {fwd['tuned']:.3f} "
          f"ms (median of 5, host clock after synchronize)")
    path = ROOT / "build" / "chip_smoke_autotune.json"
    table.save(str(path))
    back = autotune.CostTable.load(str(path))
    other = autotune.CostTable.load(str(path), fingerprint="another card")
    print(f"cost table {table.fingerprint}: {len(table)} entries, "
          f"generation {table.generation}; reloaded {back.load_status} "
          f"({len(back)} entries), under another fingerprint "
          f"{other.load_status}")
    check(back.load_status == "ok" and len(back) == len(table)
          and other.load_status == "fingerprint-mismatch" and len(other) == 0,
          "the cost table's save/load round trip failed")
    measured_launches = fused.launches
    check(launched_only("sspnna_fused") and board.states() == {},
          "the measured phase launched another kernel or tripped a breaker")

    phase("SCN autotune: reprofile")
    zero_kernel_counts()
    cold = autotune.CostTable()
    engine.build_scene_plan_host(scenes[0], cfg, autotune=cold)
    missed = [gk for gk, _ in cold.hottest_misses()]
    ctx = engine.ExecutionContext(device=dev, autotune=cold,
                                  autotune_reprofile_ms=REPROFILE_MS)
    eng = SceneEngine(cfg, model, len(scenes), spec=spec, ctx=ctx)
    hook, idle_s = eng.scheduler.on_idle, []

    def timed(scheduler):
        t0 = time.perf_counter()
        hook(scheduler)
        idle_s.append(time.perf_counter() - t0)

    eng.scheduler.on_idle = timed
    handles = eng.submit([SceneRequest(seed, t)
                          for seed, t in zip(SEEDS, scenes)])
    eng.serve()
    logits = np.stack([h.result().logits for h in handles])
    eng.close()
    check_no_breakers(eng)
    per_replay = eng.graphs.launches(only_graph(eng))["sspnna_fused"]
    captured = eng.graphs.captured["sspnna_fused"]
    replayed = eng.graphs.replayed["sspnna_fused"]
    profiled = []
    for gk in missed:
        got = {e.sig.backend: e for e in cold.entries() if e.sig.group() == gk}
        win = min(got, key=lambda b: got[b].median_us) if got else None
        profiled.append({"sig": gk.encode(), "synthetic_winner": win,
                         "real_winner": real_winner.get(gk.encode()),
                         **{f"{b}_us": e.median_us for b, e in got.items()}})
        print(f"reprofiled {gk.encode()}: " + "; ".join(
            f"{b} {e.median_us:.1f} us" for b, e in sorted(got.items()))
              + f"; synthetic winner {win}, real plan's winner "
              f"{real_winner.get(gk.encode())}")
    n_sspnna = sum("sspnna_us" in p for p in profiled)
    print(f"reprofile: {len(missed)} missed signatures, {len(cold)} entries "
          f"after {eng.scheduler.idle_ticks} idle tick(s) of "
          f"{sum(idle_s):.2f} s (budget {REPROFILE_MS:.0f} ms a tick); "
          f"generation {cold.generation}, plan-cache invalidations "
          f"{ctx.plan_cache.invalidations}; sspnna_fused counter "
          f"{fused.launches}: {captured} recorded at capture, {replayed} run "
          f"by the replay, {fused.launches - captured - per_replay} by the "
          f"profiler ({n_sspnna} signatures x 3 calls)")
    check(len(missed) == len(plan.levels) and cold.miss_count == 0
          and n_sspnna > 0 and eng.scheduler.idle_ticks == 1,
          "the idle hook did not profile every missed signature")
    # each first measurement of a miss flips (plans were built on the
    # analytical fallback), and so does a second backend that beats it
    check(cold.generation == ctx.plan_cache.invalidations >= len(missed),
          "a profiled miss did not rotate the plan cache")
    check(fused.launches - captured - per_replay == 3 * n_sspnna
          and replayed == per_replay,
          "the profiler's launches do not add up")
    check(launched_only("sspnna_fused"), "the reprofile phase launched "
          "another kernel")
    _, wave_err = max_err(torch.from_numpy(logits), torch.from_numpy(served))
    print(f"reprofile engine's wave vs the serving phase's: rel "
          f"{wave_err:.3g} (tol {WAVE_TOL})")
    check(wave_err <= WAVE_TOL, "the reprofile engine's wave disagrees")
    return {"measured": {"launches": measured_launches, "levels": levels,
                         "forward_ms": fwd, "tuned_max_rel_err": tuned_err,
                         "k": AUTOTUNE_K},
            "reprofile": {"launches": fused.launches - captured + replayed,
                          "profiled": profiled, "idle_s": sum(idle_s),
                          "generation": cold.generation,
                          "invalidations": ctx.plan_cache.invalidations}}


def scn_breaker_path(dev: torch.device, phase: Phases, model, cfg, spec,
                     scenes) -> dict:
    """Phase "SCN breakers": a ``SceneEngine`` on the pinned spec, batch 2,
    seeds 0-1, its board at 3 failures with a fake clock. A fault-free
    wave captures the ``sspnna`` graph; then three injected dispatch faults
    attributed to ``sspnna`` trip the breaker, and the retried requests'
    plans, rerouted to ``reference``, run on a second graph without
    ``sspnna_fused``, their logits held against a reference engine's. Past
    the cooldown seed 2 probes and closes the breaker, and seeds 0-1 replay
    the ``sspnna`` graph again, held against the fault-free wave. Times
    the rerouted wave against the ``sspnna`` graph's. Returns the numbers
    for the kernel's JSON entry."""
    from repro_torch import engine
    from repro_torch.engine.backends import OPEN, BreakerBoard
    from repro_torch.kernels.sspnna import sspnna
    from repro_torch.serving.api import AdmissionPolicy
    from repro_torch.serving.faults import FaultInjector, FaultPlan, FaultSpec
    from repro_torch.serving.scene_engine import SceneEngine, SceneRequest

    fused = sspnna.sspnna_fused
    phase("SCN breakers")
    zero_kernel_counts()
    torch.cuda.reset_peak_memory_stats()
    now = [0.0]
    reg = engine.default_registry().view()
    reg.breakers = board = BreakerBoard(reg, failure_threshold=3,
                                        cooldown_s=60.0, clock=lambda: now[0])
    ctx = engine.ExecutionContext(device=dev, registry=reg)
    eng = SceneEngine(cfg, model, 2, spec=spec, ctx=ctx,
                      policy=AdmissionPolicy(max_retries=4,
                                             retry_backoff_ms=1.0))
    pair, cap = scenes[:2], cfg.capacity

    def serve(e, batch, rid0):
        hs = e.submit([SceneRequest(rid0 + i, t) for i, t in enumerate(batch)])
        e.serve()
        return np.stack([h.result().logits for h in hs])

    def plans_now():
        return [ctx.plan_cache.get_or_build(
            t, cfg, device=dev, topology=ctx.topology_key(), **eng._plan_kw)
            for t in pair]

    clean = serve(eng, pair, 0)
    check_no_breakers(eng)
    sspnna_plans = plans_now()
    sspnna_key = eng.graph_key(cap, sspnna_plans[0])
    eng.scheduler.faults = FaultInjector(FaultPlan(seed=0, specs=(
        FaultSpec("dispatch", rate=1.0, backend="sspnna", max_fires=3),)))
    rerouted = serve(eng, pair, 10)
    states = board.states()
    print(f"faulted serve: {eng.scheduler.wave_errors} wave errors, "
          f"{eng.scheduler.retries_charged} retries, breakers {states}, "
          f"generation {board.generation}, graphs {len(eng.graphs)}")
    check(eng.scheduler.wave_errors == 3 and states["sspnna"]["state"] == OPEN
          and states["sspnna"]["trips"] == 1
          and eng.health()["breakers"] == states,
          "three dispatch faults did not trip the sspnna breaker once")
    ref_plans = plans_now()
    check(all(lvl.sub.dispatch.backend == engine.REFERENCE
              for p in ref_plans for lvl in p.levels),
          "a plan built after the trip still dispatches to sspnna")
    ref_key = eng.graph_key(cap, ref_plans[0])
    check(eng.graphs.keys() == [sspnna_key, ref_key]
          and eng.n_compilations == 2
          and eng.graphs.launches(ref_key)["sspnna_fused"] == 0,
          "the rerouted waves did not run on a second graph without "
          "sspnna_fused")
    ref_eng = SceneEngine(cfg, model, 2, ctx=engine.ExecutionContext(
        device=dev))
    want = serve(ref_eng, pair, 0)
    ref_eng.close()
    check_no_breakers(ref_eng)
    _, reroute_err = max_err(torch.from_numpy(rerouted),
                             torch.from_numpy(want))
    print(f"rerouted logits vs a reference engine's: rel {reroute_err:.3g} "
          f"(tol {LOGITS_TOL})")
    check(reroute_err <= LOGITS_TOL, "rerouted and reference logits disagree")
    feats = [torch.from_numpy(t.feats).to(dev) for t in pair]
    with torch.inference_mode():
        wave_ms = {name: host_ms(lambda p=p: eng.run_wave(feats, p, cap), 5)
                   for name, p in (("sspnna", sspnna_plans),
                                   ("rerouted", ref_plans))}
    print(f"a wave of 2, graph replay: sspnna {wave_ms['sspnna']:.3f} ms "
          f"({wave_ms['sspnna'] / 2:.3f} ms a scene), rerouted to reference "
          f"{wave_ms['rerouted']:.3f} ms ({wave_ms['rerouted'] / 2:.3f} ms a "
          f"scene; host clock after synchronize, median of 5)")
    eng.scheduler.faults = None
    now[0] += 61.0
    gen, replays = board.generation, eng.graphs.replays
    serve(eng, scenes[2:3], 20)   # a new scene's build probes sspnna
    check(board.states()["sspnna"]["state"] == "closed"
          and board.generation == gen + 1
          and eng.graphs.replays == replays + 1 and len(eng.graphs) == 2,
          "the HALF_OPEN probe did not close the breaker on the sspnna graph")
    again = serve(eng, pair, 30)
    eng.close()
    _, again_err = max_err(torch.from_numpy(again), torch.from_numpy(clean))
    print(f"after the probe closed the breaker: seeds 0-1 vs the fault-free "
          f"wave rel {again_err:.3g} (tol {WAVE_TOL}); graphs "
          f"{len(eng.graphs)}, replays {eng.graphs.replays}")
    check(again_err <= WAVE_TOL, "the re-closed sspnna wave disagrees")
    captured = eng.graphs.captured["sspnna_fused"]
    replayed = eng.graphs.replayed["sspnna_fused"]
    launched = fused.launches - captured + replayed
    peak = torch.cuda.max_memory_allocated() / 2**30
    print(f"SCN breakers path: sspnna_fused counter {fused.launches} "
          f"({captured} recorded at capture), {replayed} run by replays: "
          f"{launched} launches on the device; peak memory {peak:.2f} GiB")
    check(replayed > 0 and launched_only("sspnna_fused"),
          "the breaker path ran no sspnna_fused replay or another kernel")
    return {"launches": launched, "wave_errors": eng.scheduler.wave_errors,
            "trips": states["sspnna"]["trips"],
            "generation": board.generation, "graphs": len(eng.graphs),
            "wave_ms": wave_ms, "rerouted_max_rel_err": reroute_err,
            "reclosed_max_rel_err": again_err, "peak_gib": peak}


def scn_training_path(dev: torch.device, phase: Phases, card: str,
                      seed0: dict) -> dict:
    """Phase "SCN training": the U-Net at its published widths trained by
    SGD on seeds 0-2 (untiled plans, so every conv runs ``reference`` under
    autograd and no kernel launches), then the trained weights on seed 0's
    adaptive tiled plan with ``backend="auto"`` (``sspnna_fused`` once an
    sspnna conv) against ``reference``. Returns the launch counts and
    numbers for the JSON."""
    from repro_torch import engine
    from repro_torch.data.scenes import make_scene
    from repro_torch.models.scn import SCNUNet, segmentation_loss
    from repro_torch.sparse.tensor import SparseVoxelTensor

    phase("SCN training")
    cfg = seed0["cfg"]
    check((cfg.widths, cfg.reps, cfg.n_classes) == ((16, 32, 48, 64), 2, 20),
          "the SCN is not at its published widths")
    scenes = []
    for seed in SEEDS:
        coords, feats, labels, mask = make_scene(
            seed, RESOLUTION, CAPACITY, points_per_unit=POINTS_PER_UNIT)
        t0 = time.perf_counter()
        host = engine.build_scene_plan_host(
            SparseVoxelTensor(coords, feats, mask), cfg, plan_tiles=False)
        plan_s = time.perf_counter() - t0
        check(all(lvl.sub.tiles is None for lvl in host.levels),
              "an untiled plan holds tiles")
        scenes.append((torch.from_numpy(feats).to(dev),
                       engine.upload_scene_plan(host, dev),
                       torch.from_numpy(labels).to(dev),
                       torch.from_numpy(mask).to(dev)))
        print(f"training scene {seed}: {int(mask.sum())} active voxels, "
              f"untiled host plan {plan_s:.1f} s")
    model = SCNUNet(cfg, device=dev,
                    generator=torch.Generator().manual_seed(0))
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    held = torch.cuda.memory_allocated()
    zero_kernel_counts()
    losses, step_ms = [], []
    for step in range(SCN_TRAIN_STEPS):
        feats, plan, labels, mask = scenes[step % len(scenes)]
        t0 = time.perf_counter()
        model.zero_grad()
        loss, _ = segmentation_loss(
            engine.apply_unet(model, feats, plan, device=dev), labels, mask)
        loss.backward()
        with torch.no_grad():
            for prm in model.parameters():
                prm.sub_(SCN_TRAIN_LR * prm.grad)
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t0) * 1e3)
        losses.append(loss.item())
    step_launches = kernel_counts()
    peak = (torch.cuda.max_memory_allocated() - held) / 2**30
    first, last = (statistics.mean(losses[:len(SEEDS)]),
                   statistics.mean(losses[-len(SEEDS):]))
    med = statistics.median(step_ms)
    print(f"SCN training: {SCN_TRAIN_STEPS} SGD steps at lr {SCN_TRAIN_LR} "
          f"over seeds {SEEDS}: step {med:.3f} ms median (forward, backward, "
          f"update, ending in a synchronize; first {step_ms[0]:.3f}), "
          f"{1e3 / med:.3f} scenes/s; peak memory {peak:.2f} GiB above the "
          f"{held / 2**30:.2f} held before; loss first {losses[0]:.4f} last "
          f"{losses[-1]:.4f} (mean of the first and last {len(SEEDS)}: "
          f"{first:.4f} -> {last:.4f}); kernel launches in the steps "
          f"{step_launches} [{card}]")
    check(all(np.isfinite(losses)), "a non-finite SCN training loss")
    check(last < first, "the SCN training loss did not fall")
    check(not any(step_launches.values()),
          "an SCN training step launched a kernel")
    feats, plan, labels, mask = scenes[0]
    busy = busy_report("SCN train step: device", lambda: (
        segmentation_loss(engine.apply_unet(model, feats, plan, device=dev),
                          labels, mask)[0].backward()), med)
    model.zero_grad(set_to_none=True)
    del scenes

    feats0, plan0 = seed0["feats"], seed0["plan"]
    expected = sspnna_convs(plan0, cfg)
    zero_kernel_counts()
    with torch.inference_mode():
        logits, ref = kernel_vs_plain(
            "sspnna_fused",
            lambda: engine.apply_unet(model, feats0, plan0, device=dev),
            lambda: engine.apply_unet(model, feats0, plan0,
                                      backend="reference", device=dev),
            "trained weights")
        launches = kernel_counts()["sspnna_fused"]
    torch.cuda.synchronize()
    abs_err, rel_err = max_err(logits, ref)
    print(f"trained weights on seed 0's adaptive plan: sspnna_fused launches "
          f"{launches} (planned {expected}); logits vs reference max abs "
          f"{abs_err:.3g} rel {rel_err:.3g} (tol {LOGITS_TOL}) [{card}]")
    check(bool(torch.isfinite(logits).all()), "non-finite trained logits")
    check(launches == expected == 15,
          f"{launches} sspnna_fused launches on the trained weights")
    check(rel_err <= LOGITS_TOL, "trained weights: auto and reference logits "
          "disagree")
    return {"step_ms": med, "peak_gib": peak, "loss_first": losses[0],
            "loss_last": losses[-1], "busy_ms": busy["busy_ms"],
            "step_launches": step_launches, "eval_launches": launches,
            "eval_max_abs_err": abs_err}


def lm_training_path(dev: torch.device, phase: Phases, card: str) -> dict:
    """Phase "LM training": StableLM-2 1.6B at its published widths and
    depth in bf16 with remat, AdamW with f32 moments, microbatched steps on
    ``TokenStream`` batches (no kernel launches: the train mode runs plain
    ops); an asynchronous checkpoint after step ``LM_CKPT_STEP`` restored
    onto the card against the live state, bit for bit (and left in
    ``LM_CKPT_DIR`` for the "dist" phase); a prefill of the
    trained weights through flash against the plain attention; and three
    AdamW steps of reduced Moonshot. Returns numbers for the JSON."""
    from repro_torch.configs import get_config
    from repro_torch.data.tokens import TokenStream
    from repro_torch.kernels.flash.flash import flash_attention_plain
    from repro_torch.models import attention
    from repro_torch.serving.engine import make_prefill
    from repro_torch.training import checkpoint, train_loop
    from repro_torch.training.optimizer import OptHParams, adamw_update
    from repro_torch.training.tree import tree_leaves, tree_map

    phase("LM training")
    cfg = get_config(LM_TRAIN_ARCH)
    check((cfg.n_layers, cfg.d_model, cfg.n_heads, cfg.head_dim, cfg.d_ff,
           cfg.vocab_size) == (24, 2048, 32, 64, 5632, 100352),
          f"{LM_TRAIN_ARCH} is not at its published widths and depth")
    check(cfg.torch_dtype == torch.bfloat16 and cfg.remat,
          "the LM trains in bf16 with remat")
    hp = OptHParams(lr=LM_TRAIN_LR, moment_dtype=torch.float32)
    torch.cuda.reset_peak_memory_stats()
    state = train_loop.init_train_state(
        cfg, hp, device=dev, generator=torch.Generator(device=dev).manual_seed(0))
    n_params = sum(p.numel() for p in leaves(state["params"]))
    step_fn = train_loop.make_train_step(cfg, hp,
                                         n_microbatches=LM_TRAIN_MICRO)
    ds = TokenStream(cfg.vocab_size, LM_TRAIN_BATCH, LM_TRAIN_SEQ, seed=0)
    tokens = LM_TRAIN_BATCH * LM_TRAIN_SEQ
    ckpt_dir = LM_CKPT_DIR
    shutil.rmtree(ckpt_dir, ignore_errors=True)
    zero_kernel_counts()
    losses, norms, step_ms, ckpt = [], [], [], {}
    for i in range(LM_TRAIN_STEPS):
        batch = next(ds)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, m = step_fn(state, batch)
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t0) * 1e3)
        losses.append(float(m["loss"]))
        norms.append(float(m["grad_norm"]))
        print(f"LM train step {i + 1}: {step_ms[-1]:.3f} ms, loss "
              f"{losses[-1]:.4f}, grad_norm {norms[-1]:.4f}", flush=True)
        if i + 1 == LM_CKPT_STEP:
            # the steps' peak; the saved state stays alive below, for the
            # check only
            peak = torch.cuda.max_memory_allocated() / 2**30
            saved, data_state = state, ds.state()
            t0 = time.perf_counter()
            checkpoint.save_async(state, str(ckpt_dir), i + 1,
                                  data_state=data_state)
            ckpt["snapshot_s"] = time.perf_counter() - t0
            t_write = time.perf_counter()
    t0 = time.perf_counter()
    checkpoint.wait_for_saves()
    ckpt["wait_s"] = time.perf_counter() - t0
    ckpt["write_s"] = time.perf_counter() - t_write
    t0 = time.perf_counter()
    restored, man = checkpoint.restore(str(ckpt_dir), LM_CKPT_STEP, saved,
                                       device=dev)
    torch.cuda.synchronize()
    ckpt["restore_s"] = time.perf_counter() - t0
    ckpt["equal"] = all(
        torch.equal(a, b) and a.dtype == b.dtype
        for a, b in zip(tree_leaves(saved), tree_leaves(restored),
                        strict=True))
    ckpt["gib"] = sum(f.stat().st_size for f in ckpt_dir.rglob("*")
                      if f.is_file()) / 2**30
    check(man["data_state"] == data_state and man["step"] == LM_CKPT_STEP,
          "the checkpoint's manifest")
    del restored, saved
    print(f"checkpoint after step {LM_CKPT_STEP}: save_async returned in "
          f"{ckpt['snapshot_s']:.3f} s (snapshot to host); its thread wrote "
          f"{ckpt['gib']:.2f} GiB while steps {LM_CKPT_STEP + 1}-"
          f"{LM_TRAIN_STEPS} ran, {ckpt['write_s']:.3f} s from the snapshot "
          f"to the end of wait_for_saves ({ckpt['wait_s']:.3f} s of it "
          f"waited after the last step); restore onto the card "
          f"{ckpt['restore_s']:.3f} s; equal to the state it saved bit for "
          f"bit: {ckpt['equal']}")
    check(ckpt["equal"], "the restored checkpoint differs from the state it "
          "saved")
    step_launches = kernel_counts()
    med = statistics.median(step_ms[1:LM_CKPT_STEP])
    med_writing = statistics.median(step_ms[LM_CKPT_STEP:])
    share = 6 * n_params * tokens / (med / 1e3) / PEAK_BF16_FLOPS
    print(f"LM training {LM_TRAIN_ARCH}: {n_params / 1e9:.4f} B parameters, "
          f"{LM_TRAIN_STEPS} AdamW steps of {LM_TRAIN_BATCH} x {LM_TRAIN_SEQ} "
          f"tokens in {LM_TRAIN_MICRO} microbatches: step {med:.3f} ms median "
          f"(steps 2-{LM_CKPT_STEP}; first {step_ms[0]:.3f}; "
          f"{med_writing:.3f} while the checkpoint was written), "
          f"{tokens / med * 1e3:.1f} tokens/s, {100 * share:.2f}% of the bf16 "
          f"dense peak (6 N tokens / step time / 989 TFLOP/s; remat's "
          f"recompute and attention's products not counted); peak memory "
          f"{peak:.2f} GiB (steps 1-{LM_CKPT_STEP}); loss {losses[0]:.4f} -> {losses[-1]:.4f}; "
          f"grad_norm {norms[0]:.4f} -> {norms[-1]:.4f}; kernel launches in "
          f"the steps {step_launches} [{card}]")
    check(all(np.isfinite(losses)) and all(np.isfinite(norms)),
          "a non-finite LM training loss or grad norm")
    check(losses[-1] < losses[0], "the LM training loss did not fall")
    check(not any(step_launches.values()), "an LM train step launched a kernel")
    batch = next(ds)
    busy = busy_report("LM train step: device",
                       lambda: step_fn(state, batch), med)
    # the optimizer's part of a step: one AdamW update of the whole state
    grads = tree_map(torch.zeros_like, state["params"])
    ranks = train_loop.layout_ranks(state["params"], cfg)
    adamw_ms = host_ms(lambda: adamw_update(
        state["params"], grads, state["opt"], state["step"], hp, ranks), 2)
    del grads
    print(f"LM train step: the AdamW update alone {adamw_ms:.3f} ms of the "
          f"{med:.3f} ms step (median of 2, host clock after synchronize) "
          f"[{card}]")

    # the trained weights' prefill: flash once a layer, against the plain
    # attention in bf16 and (the weights cast up) in f32
    params = state["params"]
    del state, m
    toks = torch.from_numpy(batch["tokens"][:2, :LM_TRAIN_SEQ]).to(dev)
    prefill = make_prefill(cfg)
    cfg32 = dataclasses.replace(cfg, dtype="float32")
    params32 = to_float32(params)
    prefill32 = make_prefill(cfg32)
    kernel_bshd = attention.flash_attention_bshd
    zero_kernel_counts()
    def plain_side():
        attention.flash_attention_bshd = flash_attention_plain
        try:
            return prefill(params, toks)[0], prefill32(params32, toks)[0]
        finally:
            attention.flash_attention_bshd = kernel_bshd

    with torch.inference_mode():
        got = prefill(params, toks)[0]
        torch.cuda.synchronize()
        prefill_launches = kernel_counts()["flash_fwd"]
        got32, (want, want32) = kernel_vs_plain(
            "flash_fwd", lambda: prefill32(params32, toks)[0], plain_side,
            "trained prefill")
    torch.cuda.synchronize()
    _, err32 = max_err(got32, want32)
    _, err = max_err(got, want)
    _, noise = max_err(want, want32)
    print(f"trained {LM_TRAIN_ARCH} prefill of 2 x {LM_TRAIN_SEQ}: flash "
          f"launches {prefill_launches}; last-position logits, kernel vs "
          f"plain attention: f32 rel {err32:.3g} (tol {LM_F32_TOL}), bf16 rel "
          f"{err:.3g} (tol {LM_BF16_FACTOR} x {noise:.3g}, the plain path's "
          f"bf16 vs f32) [{card}]")
    check(prefill_launches == cfg.n_layers == 24,
          f"{prefill_launches} flash launches in the trained prefill")
    check(bool(torch.isfinite(got).all()), "non-finite trained logits")
    check(err32 <= LM_F32_TOL, "trained f32 prefill logits disagree with the "
          "plain attention")
    check(err <= LM_BF16_FACTOR * noise, "trained bf16 prefill logits "
          "disagree with the plain attention")
    del params, params32, got, got32, want, want32

    # reduced Moonshot: the MoE train mode (expert products as plain
    # products under autograd)
    mcfg = get_config(MOE_ARCH).reduced()
    mstate = train_loop.init_train_state(
        mcfg, hp, device=dev, generator=torch.Generator(device=dev).manual_seed(0))
    mstep = train_loop.make_train_step(mcfg, hp)
    mds = TokenStream(mcfg.vocab_size, 4, 64, seed=1)
    zero_kernel_counts()
    mlosses = []
    for _ in range(3):
        mstate, mm = mstep(mstate, next(mds))
        mlosses.append(float(mm["loss"]))
    moe_launches = kernel_counts()
    aux = {k: float(mm[k]) for k in ("moe_lb_loss", "moe_z_loss",
                                     "moe_dropped")}
    print(f"{MOE_ARCH} reduced: 3 AdamW steps, loss {mlosses}, aux {aux}, "
          f"kernel launches {moe_launches} [{card}]")
    check(all(np.isfinite(mlosses)) and all(np.isfinite(list(aux.values()))),
          "non-finite MoE training metrics")
    check(not any(moe_launches.values()), "a MoE train step launched a kernel")
    del mstate
    return {"step_ms": med, "step_ms_while_writing": med_writing,
            "tokens_per_s": tokens / med * 1e3,
            "bf16_peak_share": share, "peak_gib": peak,
            "loss_first": losses[0], "loss_last": losses[-1],
            "busy_ms": busy["busy_ms"], "adamw_ms": adamw_ms,
            "step_launches": step_launches,
            "prefill_launches": prefill_launches, "checkpoint": ckpt}


def greedy_tokens(step, params, cfg, logits, cache,
                  new: int = MAX_NEW) -> torch.Tensor:
    """``new`` greedy tokens (B, new) from a prefill's output, the decode
    steps run eagerly (``step`` is ``make_serve_step(cfg)``)."""
    tok = logits[:, :cfg.vocab_size].argmax(-1).to(torch.int32)[:, None]
    out = [tok]
    for _ in range(new - 1):
        nxt, _, cache = step(params, tok, cache)
        tok = nxt[:, None]
        out.append(tok)
    return torch.cat(out, 1)


def busy_report(name: str, fn, wall_ms: float, per: int = 1) -> dict:
    """What the device did in one call of ``fn`` (torch.profiler): its
    kernels' and copies' time summed over ``per`` units (tokens, scenes),
    the share of ``wall_ms`` (a unit's wall time) it is, and the top
    kernels. ``busy_ms`` is None when the profiler saw no device time."""
    times = device_times(fn)
    if not times:
        print(f"{name}: torch.profiler saw no device time (not measured)")
        return {"busy_ms": None}
    busy = sum(times.values()) / per
    top = sorted(times.items(), key=lambda kv: -kv[1])[:6]
    print(f"{name}: device busy {busy:.3f} ms of {wall_ms:.3f} ms "
          f"({100 * busy / wall_ms:.1f}%; torch.profiler); top: "
          + "; ".join(f"{k[:60]} {v / per:.3f} ms" for k, v in top))
    return {"busy_ms": busy}


def decode_graph(eng, prefill, greedy, toks, arch: str,
                 new: int = MAX_NEW) -> dict:
    """Decode ms a token and the device's busy share, eager steps (``greedy``)
    against the serving engine's step graphs (``eng.decode``, whose copy of
    the prefill cache into the graphs' cache is counted), on one prefill of
    ``toks``; the two must emit the same tokens. Wall time is the host
    clock after a synchronize; busy time is the device's kernels and
    copies (torch.profiler) and, for the graphs, also ``device_ms`` (the
    replays queued behind a spinning kernel; an eager decode's thousands of
    launches fill the launch queue, so that measure does not hold for it).
    The timed eager calls decode over a cache an earlier call wrote into:
    the same work, other tokens. ``new`` is the engine's ``max_new``."""
    steps = new - 1
    with torch.inference_mode():
        logits, cache = prefill(eng.params, toks)
        # the graphs read a copy of the cache; the eager steps write into it
        # (a ring cache's slots then hold later positions), so they go last
        graph_tok = eng.decode(logits, cache)
        eager_tok = greedy(logits, cache)
        check(torch.equal(eager_tok, graph_tok),
              f"{arch}: graph decode emitted other tokens than eager steps")
        out = {}
        for name, fn, reps in (
                ("eager", lambda: greedy(logits, cache), 2),
                ("graph", lambda: eng.decode(logits, cache), 5)):
            wall = host_ms(fn, reps) / steps
            out[name] = {"ms": wall}
            print(f"{arch} decode, {name}: {wall:.3f} ms a token (batch "
                  f"{BATCH}, {steps} steps, median of {reps})")
            out[name].update(busy_report(f"{arch} decode, {name}", fn, wall,
                                         steps))
        span = device_ms(lambda: eng.decode(logits, cache), 5) / steps
        out["graph"]["device_ms"] = span
        print(f"{arch} decode, graph: device span {span:.3f} ms a token "
              f"(replays queued behind a spin; "
              f"{100 * span / out['graph']['ms']:.1f}% of the wall time)")
        del logits, cache
    print(f"{arch} decode tokens, graph = eager: {graph_tok.tolist()}; "
          f"{len(eng.graphs)} step graphs, speedup "
          f"{out['eager']['ms'] / out['graph']['ms']:.2f}x")
    return out


def lm_path(dev: torch.device, phase: Phases) -> dict:
    """Phases 8-10: the flash kernel on random shapes, Gemma-2 2B served at
    full width, and the replay of one wave's launches. Returns the kernel's
    JSON entry."""
    from repro_torch.configs import get_config
    from repro_torch.data.tokens import TokenStream
    from repro_torch.kernels.flash.flash import (
        flash_attention,
        flash_attention_plain,
    )
    from repro_torch.kernels.flash.ref import FLASH_CASES, FLASH_TOL, random_qkv
    from repro_torch.models import attention, transformer
    from repro_torch.serving.engine import Engine, Request, make_prefill, make_serve_step

    phase("flash random shapes")
    worst_abs = 0.0
    rng = np.random.default_rng(0)
    for b, sq, skv, hq, hkv, d, causal, window, cap, dt in FLASH_CASES:
        q, k, v = (x.to(dev) for x in random_qkv(
            rng, b=b, sq=sq, skv=skv, hq=hq, hkv=hkv, d=d, dtype=dt))
        kw = dict(causal=causal, window=window, softcap=cap)
        got, want = kernel_vs_plain(
            "flash_fwd", lambda: flash_attention(q, k, v, **kw),
            lambda: flash_attention_plain(q, k, v, **kw),
            f"flash B={b} Sq={sq} D={d}")
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
    params = transformer.init_lm(
        cfg, device=dev, generator=torch.Generator(device=dev).manual_seed(0))
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
        return out, waves, wall_s, eng

    zero_kernel_counts()
    by_sync, waves, sync_s, sync_eng = serve(sync=True)
    by_async, async_waves, async_s, _ = serve(sync=False)
    total_launches = flash_attention.launches
    check(launched_only("flash_fwd"), "the LM path launched another kernel")
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
        return greedy_tokens(step, params, cfg, logits, cache)

    cfg32 = dataclasses.replace(cfg, dtype="float32")
    params32 = to_float32(params)
    prefill32 = make_prefill(cfg32, cache_pad=MAX_NEW)
    kernel_bshd = attention.flash_attention_bshd
    with torch.inference_mode():
        def plain_side(toks):
            """bf16 logits, greedy tokens and f32 logits with the plain
            attention."""
            attention.flash_attention_bshd = flash_attention_plain
            try:
                want, cache = prefill(params, toks)
                plain_tokens = greedy(want, cache).tolist()
                del cache
                return want, plain_tokens, prefill32(params32, toks)[0]
            finally:
                attention.flash_attention_bshd = kernel_bshd

        for wi, (toks, logits, _) in enumerate(waves):
            got32, (want, plain_tokens, want32) = kernel_vs_plain(
                "flash_fwd", lambda: prefill32(params32, toks)[0],
                lambda: plain_side(toks), f"wave {wi} prefill")
            torch.cuda.synchronize()
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
    with torch.inference_mode():
        rows = [flash_row(q, k, v, kw, f"flash launch {i} "
                          f"({cfg.layer_kind(i)})", reps=3)
                for i, (q, k, v, kw) in enumerate(calls)]
        worst_abs = max([worst_abs] + [r["max_abs_err"] for r in rows])
        # the global layer's inputs without softcap, beside the library call
        glob = next(i for i in range(cfg.n_layers)
                    if cfg.layer_kind(i) != "local")
        q, k, v, _ = calls[glob]
        nocap = flash_row(q, k, v, {"causal": True},
                          f"layer {glob} inputs without softcap")
        wave_ms = sum(r["ms"] for r in rows)
        print(f"one wave's prefill: {len(rows)} flash launches, kernel "
              f"{wave_ms:.3f} ms, plain {sum(r['plain_ms'] for r in rows):.3f} "
              f"ms, bound {sum(r['bound_ms'] for r in rows):.4f} ms")

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
    phase("decode graph")
    graph_decode = decode_graph(sync_eng, prefill, greedy, toks0, LM_ARCH)
    del sync_eng
    row = rows[glob]
    return {
        "name": "flash_fwd",
        "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/flash_fwd.cu",
        "replaces": "src/repro/kernels/flash/flash.py:30",
        "launches": total_launches,
        "max_abs_err": worst_abs,
        # one global-layer launch of a wave's prefill (B=2, S=6144, 8/4
        # heads of 256, causal, softcap 50); library_ms is SDPA on the same
        # inputs without softcap, beside the kernel's ms_no_softcap
        "ms": row["ms"],
        "plain_ms": row["plain_ms"],
        "bound_ms": row["bound_ms"],
        "bound_by": row["bound_by"],
        "library_ms": nocap["library_ms"],
        "device_ms": row["device_ms"],
        "ms_no_softcap": nocap["ms"],
        "device_ms_no_softcap": nocap["device_ms"],
        "library_device_ms": nocap["library_device_ms"],
        # summed over the 26 launches of one wave's prefill
        "wave_ms": wave_ms,
        "wave_plain_ms": sum(r["plain_ms"] for r in rows),
        "wave_bound_ms": sum(r["bound_ms"] for r in rows),
        # Gemma-2's decode per token, eager steps against the step graphs
        "decode": graph_decode,
    }

def moe_gemm_bound(xin, w, valid, out_dtype):
    """Least time (ms) for one expert-GEMM launch, and what bounds it:
    ``launch.roofline.moe_gemm_work`` (2*d*f FLOPs per valid row at the
    inputs' peak, against the valid rows of x, the w of experts with a
    valid row and the validity read once and all of out written once)."""
    return moe_gemm_work(xin, w, valid, out_dtype).bound()


def gemm_row(xin, w, valid, out_dtype, what: str, reps: int = 5) -> dict:
    """One expert-GEMM launch at its real inputs, timed with its wrapper
    (``time_ms``) and on the device alone (``device_ms``), beside the plain
    version's time, ``torch.bmm`` on the pre-masked inputs (the library's
    yardstick, bf16 out, which the port never calls) and the launch's
    bound."""
    from repro_torch.kernels.moe_gemm.moe_gemm import grouped_gemm
    from repro_torch.kernels.moe_gemm.ref import grouped_gemm_ref

    def kernel():
        return grouped_gemm(xin, w, valid, out_dtype=out_dtype)

    xm = torch.where(valid[..., None], xin, 0)
    b_ms, b_by = moe_gemm_bound(xin, w, valid, out_dtype)
    row = {"x": list(xin.shape), "w": list(w.shape),
           "valid_rows": int(valid.sum()),
           "live_experts": int(valid.any(1).sum()),
           "ms": time_ms(kernel, reps), "device_ms": device_ms(kernel, 4 * reps),
           "plain_ms": time_ms(lambda: grouped_gemm_ref(xin, w, valid,
                                                        out_dtype),
                               max(2, reps // 2)),
           "library_ms": time_ms(lambda: torch.bmm(xm, w), reps),
           "library_device_ms": device_ms(lambda: torch.bmm(xm, w), 4 * reps),
           "bound_ms": b_ms, "bound_by": b_by}
    del xm
    print(f"{what}: moe_gemm x {tuple(xin.shape)} w {tuple(w.shape)}, "
          f"{row['valid_rows']} valid rows in {row['live_experts']} experts: "
          f"kernel {row['ms']:.4f} ms (device {row['device_ms']:.4f}), plain "
          f"{row['plain_ms']:.4f} ms, torch.bmm {row['library_ms']:.4f} ms "
          f"(device {row['library_device_ms']:.4f}; a yardstick the port "
          f"never calls), bound {b_ms:.4f} ms ({b_by})")
    return row


# the expert GEMM's kernel instantiations: the bf16 wgmma tiles (f32 or
# bf16 out, 16-byte or 2-byte copies), the bf16 mma.sync slabs (also 16 or
# 64 rows) and the f32 CUDA-core kernel (f32 or bf16 out)
MOE_GEMM_INSTANCES = 4 + 8 + 2


def moe_gemm_label(name: str) -> str:
    """A readable name for a mangled moe_gemm kernel name."""
    m = re.search(r"(tile_kernel|slab_kernel|moe_gemm_f32_kernel)"
                  r"I(f|13__nv_bfloat16)(?:Lb([01])E)?(?:Li(\d+)E)?E", name)
    if not m:
        return name
    kind = {"tile_kernel": "bf16 wgmma tile", "slab_kernel": "bf16 slab",
            "moe_gemm_f32_kernel": "f32"}[m.group(1)]
    label = f"{kind}, {'f32' if m.group(2) == 'f' else 'bf16'} out"
    if m.group(3):
        label += ", 16-byte copies" if m.group(3) == "1" else ", 2-byte loads"
    if m.group(4):
        label += f", {16 * int(m.group(4))} rows"
    return label


def moe_path(dev: torch.device, phase: Phases) -> tuple[dict, dict]:
    """Phases 11-14: the expert GEMM on random shapes, Moonshot 16B-A3B
    served at full width and depth, the checks at real inputs and the
    timings. Returns the kernel's JSON entry and flash's numbers at this
    path's shape."""
    from repro_torch.configs import get_config
    from repro_torch.data.tokens import TokenStream
    from repro_torch.kernels.flash.flash import flash_attention
    from repro_torch.kernels.moe_gemm.moe_gemm import grouped_gemm
    from repro_torch.kernels.moe_gemm.ref import (
        MOE_GEMM_CASES,
        grouped_gemm_ref,
        moe_gemm_tol,
        random_moe_inputs,
    )
    from repro_torch.models import attention, moe, transformer
    from repro_torch.serving.engine import Engine, Request, make_prefill, make_serve_step

    def plain_gemm(xin, w, valid, *, out_dtype=None):
        return grouped_gemm_ref(xin, w, valid, out_dtype)

    phase("moe_gemm random shapes")
    worst_abs = 0.0
    rng = np.random.default_rng(0)
    for e, c, d, f, share, dt, odt in MOE_GEMM_CASES:
        xin, w, valid = (x.to(dev) for x in random_moe_inputs(
            rng, e=e, c=c, d=d, f=f, valid_share=share, dtype=dt))
        got, want = kernel_vs_plain(
            "moe_gemm", lambda: grouped_gemm(xin, w, valid, out_dtype=odt),
            lambda: grouped_gemm_ref(xin, w, valid, odt),
            f"moe_gemm E={e} C={c} d={d} f={f}")
        torch.cuda.synchronize()
        abs_err, rel_err = max_err(got.float(), want.float())
        tol = moe_gemm_tol(dt, odt)
        print(f"moe_gemm E={e} C={c} d={d} f={f} valid "
              f"{int(valid.sum())}/{valid.numel()} "
              f"{str(dt).removeprefix('torch.')} -> "
              f"{str(odt).removeprefix('torch.')}: max abs {abs_err:.3g} rel "
              f"{rel_err:.3g} (tol {tol})")
        check(rel_err <= tol, "expert GEMM kernel disagrees with its plain "
              "version")
        check(not bool(got[~valid].any()), "invalid rows are not zero")
        worst_abs = max(worst_abs, abs_err)

    phase("MoE init")
    cfg = get_config(MOE_ARCH)
    published = (48, 2048, 16, 16, 128, 1408, 163840, 64, 6)
    check((cfg.n_layers, cfg.d_model, cfg.n_heads, cfg.n_kv_heads,
           cfg.head_dim, cfg.d_ff, cfg.vocab_size, cfg.moe.n_experts,
           cfg.moe.top_k) == published,
          f"{MOE_ARCH} is not at its published widths")
    check(cfg.torch_dtype == torch.bfloat16, "the MoE path runs in bf16")
    torch.cuda.reset_peak_memory_stats()
    params = transformer.init_lm(
        cfg, device=dev, generator=torch.Generator(device=dev).manual_seed(0))
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in leaves(params))
    n_norms = params["final_norm"].numel() + sum(
        lp[k].numel() for lp in params["layers"] for k in ("ln1", "ln2"))
    check(n_params - n_norms == cfg.param_count(),
          f"{n_params - n_norms} parameters, config {cfg.param_count()}")
    stream = TokenStream(cfg.vocab_size, len(MOE_PROMPT_LENS), MOE_PROMPT_LEN,
                         seed=0)
    tokens = next(stream)["tokens"]
    prompts = [tokens[i, :n] for i, n in enumerate(MOE_PROMPT_LENS)]
    cap = moe.moe_capacity(MOE_PROMPT_LEN, cfg.moe.top_k, cfg.moe.n_experts,
                           cfg.moe.capacity_factor)
    print(f"{MOE_ARCH}: {(n_params - n_norms) / 1e9:.3f} B parameters in "
          f"bf16 (cfg.param_count() {cfg.param_count()}, plus {n_norms} norm "
          f"weights; {cfg.active_param_count() / 1e9:.3f} B active a token), "
          f"{cfg.n_layers} layers, {cfg.moe.n_experts} experts top-"
          f"{cfg.moe.top_k}, capacity {cap} a group in prefill; prompts of "
          f"{MOE_PROMPT_LENS} tokens in slots of {MOE_PROMPT_LEN}, batch "
          f"{BATCH}, {MAX_NEW} new tokens each; "
          f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB on the card")

    phase("MoE serving")
    per_prefill = 3 * cfg.n_layers
    per_wave = per_prefill * MAX_NEW   # the prefill and MAX_NEW - 1 steps

    def serve(sync: bool):
        eng = Engine(cfg, params, BATCH, MOE_PROMPT_LEN, MAX_NEW, sync=sync,
                     device=dev)
        waves = []   # [tokens, logits, flash launches, expert-GEMM launches]
        inner_prefill = eng.prefill

        def prefill(p, toks):
            before = flash_attention.launches, grouped_gemm.launches
            logits, cache = inner_prefill(p, toks)
            waves.append([toks, logits, flash_attention.launches - before[0],
                          grouped_gemm.launches - before[1]])
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
        # the decode steps are graph replays, which tick no counter: each
        # wave's stats hold the launches its replays ran
        for w, st in zip(waves, eng.wave_stats, strict=True):
            w[3] += st.notes["graph_launches"].get("moe_gemm", 0)
        return out, waves, wall_s, eng

    zero_kernel_counts()
    by_sync, waves, sync_s, sync_eng = serve(sync=True)
    by_async, async_waves, async_s, async_eng = serve(sync=False)
    # the counter ticked at each engine's warm-up step and capture; the
    # replays ran the launches the wave stats count
    captured = sum(e.graphs.captured["moe_gemm"]
                   for e in (sync_eng, async_eng))
    replayed = sum(e.graphs.replayed["moe_gemm"]
                   for e in (sync_eng, async_eng))
    total_launches = grouped_gemm.launches - captured + replayed
    print(f"expert GEMM: counter {grouped_gemm.launches} ({captured} recorded "
          f"into the step graphs at capture), {replayed} run by replays: "
          f"{total_launches} launches on the device")
    del async_eng
    check(launched_only("flash_fwd", "moe_gemm"),
          "the MoE path launched another kernel")
    n_new = sum(len(o) for o in by_sync.values())
    for name, w, sec in (("sync", waves, sync_s),
                         ("async", async_waves, async_s)):
        print(f"serve sync={name == 'sync'}: {len(w)} waves, flash launches "
              f"per wave {[x[2] for x in w]}, expert-GEMM launches per wave "
              f"{[x[3] for x in w]}, {sec:.3f} s, {n_new / sec:.2f} new "
              f"tokens/s, {sum(MOE_PROMPT_LENS) / sec:.1f} prompt tokens/s")
        check(len(w) == len(prompts) // BATCH, f"{len(w)} waves")
        check(all(x[2] == cfg.n_layers for x in w),
              "a wave's prefill did not launch flash once per layer")
        check(all(x[3] == per_wave for x in w),
              f"a wave did not launch the expert GEMM {per_wave} times")
    # and one eager warm-up step an engine before its capture
    check(total_launches == 2 * len(waves) * per_wave + 2 * per_prefill,
          f"{total_launches} expert-GEMM launches")
    print(f"tokens sync={by_sync}")
    check(by_sync == by_async, "sync and async serving emitted other tokens")
    check(all(len(o) == MAX_NEW and all(0 <= t < cfg.vocab_size for t in o)
              for o in by_sync.values()), "emitted tokens out of range")
    for toks, logits, _, _ in waves:
        check(bool(torch.isfinite(logits).all())
              and logits.shape == (BATCH, cfg.vocab_padded),
              "prefill logits not finite or of the wrong shape")
    print(f"MoE serving peak memory "
          f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")

    prefill = make_prefill(cfg, cache_pad=MAX_NEW)
    step = make_serve_step(cfg)
    toks0 = waves[0][0]
    phase("MoE decode graph")

    def greedy(logits, cache) -> torch.Tensor:
        return greedy_tokens(step, params, cfg, logits, cache)

    graph_decode = decode_graph(sync_eng, prefill, greedy, toks0, MOE_ARCH)
    del sync_eng  # its graphs' cache and pool make room for the checks
    gc.collect()
    torch.cuda.empty_cache()

    phase("MoE checks")
    kernel_gemm, kernel_bshd = moe.grouped_gemm, attention.flash_attention_bshd
    launch_errs = []    # (abs error, rel error, tolerance) of every launch
    launch_work = {"prefill": [], "decode": []}   # (valid rows, bound ms)
    timed = {}          # layer 0's inputs of each launch shape
    flash_in = []

    def checked(where):
        def run(xin, w, valid, *, out_dtype=None):
            got = kernel_gemm(xin, w, valid, out_dtype=out_dtype)
            want = grouped_gemm_ref(xin, w, valid, out_dtype)
            abs_err, rel_err = max_err(got.float(), want.float())
            launch_errs.append((abs_err, rel_err,
                                moe_gemm_tol(xin.dtype, got.dtype)))
            launch_work[where].append(
                (int(valid.sum()), moe_gemm_bound(xin, w, valid, got.dtype)[0]))
            key = (where, w.shape[1], got.dtype)
            if key not in timed:
                timed[key] = (xin, w, valid, got.dtype)
            return got
        return run

    def record_flash(q, k, v, **kw):
        if not flash_in:
            flash_in.append((q, k, v, kw))
        return kernel_bshd(q, k, v, **kw)

    with torch.inference_mode():
        # (a) every launch of one wave's prefill and one decode step
        before = kernel_counts()["moe_gemm"]
        moe.grouped_gemm = checked("prefill")
        attention.flash_attention_bshd = record_flash
        try:
            logits, cache = prefill(params, toks0)
            tok = logits[:, :cfg.vocab_size].argmax(-1).to(torch.int32)[:, None]
            moe.grouped_gemm = checked("decode")
            step(params, tok, cache)
        finally:
            moe.grouped_gemm = kernel_gemm
            attention.flash_attention_bshd = kernel_bshd
        del logits, cache
        torch.cuda.synchronize()
        check(len(launch_errs) == 2 * per_prefill
              == kernel_counts()["moe_gemm"] - before,
              f"{len(launch_errs)} expert-GEMM calls in a prefill and a step")
        worst = max(launch_errs, key=lambda x: x[1] / x[2])
        worst_abs = max([worst_abs] + [x[0] for x in launch_errs])
        print(f"every expert-GEMM launch of one prefill and one decode step "
              f"({len(launch_errs)}) vs its plain version at its real inputs: "
              f"worst rel {worst[1]:.3g} (tol {worst[2]}), max abs "
              f"{max(x[0] for x in launch_errs):.3g}")
        check(all(rel <= tol for _, rel, tol in launch_errs),
              "an expert-GEMM launch disagrees with its plain version")
        for where, work in launch_work.items():
            valid_rows = sorted(n for n, _ in work)
            print(f"{where}: valid rows per expert-GEMM launch min "
                  f"{valid_rows[0]}, median {valid_rows[len(work) // 2]}, max "
                  f"{valid_rows[-1]} of {cfg.moe.n_experts} experts x "
                  f"{BATCH} groups x capacity; bound summed over the "
                  f"{len(work)} launches {sum(b for _, b in work):.4f} ms")

        # (b) full width, MOE_CHECK_LAYERS layers, kernel vs plain products
        cfg_n = dataclasses.replace(cfg, n_layers=MOE_CHECK_LAYERS)
        params_n = dict(params, layers=params["layers"][:MOE_CHECK_LAYERS])
        cfg_n32 = dataclasses.replace(cfg_n, dtype="float32")
        params_n32 = to_float32(params_n)
        dispatch = moe.build_dispatch

        def last_logits(p, c, toks, gemm):
            """Last-position logits with the expert products in ``gemm``,
            and the experts every MoE layer routed each token to."""
            routed = []

            def record(idx, n_experts, capacity):
                routed.append(idx.sort(-1).values)
                return dispatch(idx, n_experts, capacity)

            moe.grouped_gemm, moe.build_dispatch = gemm, record
            try:
                logits = transformer.forward(p, c, toks, mode="prefill",
                                             last_only=True)[0]
            finally:
                moe.grouped_gemm, moe.build_dispatch = kernel_gemm, dispatch
            return logits[:, -1], routed

        def rerouted(a, b) -> list[int]:
            """Tokens each MoE layer routed to other experts in a than in b."""
            return [int((x != y).any(-1).sum()) for x, y in zip(a, b)]

        def kernel_vs_plain_logits(p, c, toks, what):
            """last_logits with the kernel's and the plain products."""
            return kernel_vs_plain(
                "moe_gemm", lambda: last_logits(p, c, toks, kernel_gemm),
                lambda: last_logits(p, c, toks, plain_gemm), what)

        for wi, (toks, _, _, _) in enumerate(waves):
            (got32, routed32), (want32, plain32) = kernel_vs_plain_logits(
                params_n32, cfg_n32, toks, f"wave {wi} f32")
            (got, routed), (want, plain) = kernel_vs_plain_logits(
                params_n, cfg_n, toks, f"wave {wi} bf16")
            torch.cuda.synchronize()
            _, err32 = max_err(got32, want32)
            _, err = max_err(got, want)
            _, noise = max_err(want, want32)
            moved, floor = rerouted(routed, plain), rerouted(plain, plain32)
            print(f"wave {wi}, {MOE_CHECK_LAYERS} layers at full width, "
                  f"kernel vs plain expert products: f32 last-position "
                  f"logits rel {err32:.3g} (tol {LM_F32_TOL}; tokens routed "
                  f"otherwise per layer {rerouted(routed32, plain32)}); bf16 "
                  f"tokens routed otherwise per layer {moved} of "
                  f"{toks.numel()} (tol {LM_BF16_FACTOR} x {sum(floor)}: the "
                  f"plain path's bf16 vs f32 routes {floor} otherwise), "
                  f"last-position logits rel {err:.3g} (reported; the plain "
                  f"path's bf16 vs f32: {noise:.3g})")
            check(err32 <= LM_F32_TOL,
                  "f32 logits disagree with the plain expert products")
            check(sum(moved) <= LM_BF16_FACTOR * sum(floor),
                  "bf16 kernel path routes more tokens otherwise than bf16 "
                  "itself does")
            # bf16, layer by layer: both paths take the plain path's input
            # to each layer, so they route alike and differ by the expert
            # products alone
            x = params["embed"][toks.long()]   # Moonshot's are not scaled
            errs = []

            def layer_out(lp, x, i, gemm):
                moe.grouped_gemm = gemm
                try:
                    return transformer.apply_layer(
                        lp, x, cfg.layer_kind(i), cfg, "prefill")[0]
                finally:
                    moe.grouped_gemm = kernel_gemm

            for i, lp in enumerate(params_n["layers"]):
                outs = kernel_vs_plain(
                    "moe_gemm", lambda: layer_out(lp, x, i, kernel_gemm),
                    lambda: layer_out(lp, x, i, plain_gemm),
                    f"wave {wi} layer {i}")
                errs.append(norm_err(outs[0], outs[1]))
                x = outs[1]
            print(f"wave {wi}, bf16, the same input to each layer: layer "
                  f"outputs, kernel vs plain expert products, max abs error "
                  f"over the largest output: "
                  f"{', '.join(f'{e:.3g}' for e in errs)} (tol {MOE_BF16_TOL})")
            check(max(errs) <= MOE_BF16_TOL,
                  "a bf16 layer disagrees with the plain expert products")
        del params_n32, got32, want32, x, outs

        # (c) full depth in bf16: reported, not gated (no f32 floor fits)
        for wi, (toks, _, _, _) in enumerate(waves):
            (got, routed), (want, plain) = kernel_vs_plain_logits(
                params, cfg, toks, f"wave {wi} all layers")
            _, err = max_err(got, want)
            first = got[:, :cfg.vocab_size].argmax(-1).tolist()
            plain_first = want[:, :cfg.vocab_size].argmax(-1).tolist()
            print(f"wave {wi}, all {cfg.n_layers} layers in bf16: "
                  f"last-position logits, kernel vs plain expert products: "
                  f"rel {err:.3g} (reported, not gated); tokens routed "
                  f"otherwise, summed over layers, "
                  f"{sum(rerouted(routed, plain))} of "
                  f"{toks.numel() * cfg.n_layers}; first tokens {first}, "
                  f"plain {plain_first}")
        del got, want, routed, plain

    phase("MoE timing")
    rows = {}   # (where, d) -> gemm_row
    with torch.inference_mode():
        for (where, d, odt), (xin, w, valid, _) in sorted(
                timed.items(), key=lambda kv: (kv[0][0] != "prefill", -kv[0][1])):
            rows[where, d] = gemm_row(
                xin, w, valid, odt, f"{where} d={d}->f={w.shape[2]} "
                f"{str(odt).removeprefix('torch.')}")
        # the device time of every expert-GEMM and flash launch of one
        # prefill and one decode step, in place (CUDA events around each)
        spans = []

        def evented(kind, inner):
            def run(*args, **kw):
                start = torch.cuda.Event(enable_timing=True)
                end = torch.cuda.Event(enable_timing=True)
                start.record()
                out = inner(*args, **kw)
                end.record()
                spans.append((kind, start, end))
                return out
            return run

        logits, cache = prefill(params, toks0)       # warm
        tok = logits[:, :cfg.vocab_size].argmax(-1).to(torch.int32)[:, None]
        moe.grouped_gemm = evented("prefill", kernel_gemm)
        attention.flash_attention_bshd = evented("flash", kernel_bshd)
        try:
            logits, cache = prefill(params, toks0)
            moe.grouped_gemm = evented("decode", kernel_gemm)
            step(params, tok, cache)
        finally:
            moe.grouped_gemm = kernel_gemm
            attention.flash_attention_bshd = kernel_bshd
        torch.cuda.synchronize()
        in_place = {kind: sum(a.elapsed_time(b) for k, a, b in spans
                              if k == kind)
                    for kind in ("prefill", "decode", "flash")}
        check([k for k, _, _ in spans].count("prefill") == per_prefill,
              "the timed prefill missed expert-GEMM launches")
        wave_ms, step_ms = in_place["prefill"], in_place["decode"]
        del logits, cache

        q, k, v, kw = flash_in[0]
        frow = flash_row(q, k, v, kw, "flash at layer 0 of a Moonshot wave")

        prefill_ms = host_ms(lambda: prefill(params, toks0), 3)
        decode_ms = []
        for _ in range(2):   # the second run is warm
            logits, cache = prefill(params, toks0)
            tok = logits[:, :cfg.vocab_size].argmax(-1).to(torch.int32)[:, None]
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(MAX_NEW - 1):
                tok, _, cache = step(params, tok, cache)
                tok = tok[:, None]
            torch.cuda.synchronize()
            decode_ms.append((time.perf_counter() - t0) * 1e3 / (MAX_NEW - 1))
            del logits, cache
        # where the time goes: device time by kernel name, over the wall
        # time measured without the profiler
        logits, cache = prefill(params, toks0)
        tok = logits[:, :cfg.vocab_size].argmax(-1).to(torch.int32)[:, None]
        profiles = {"prefill": (prefill_ms, device_times(
                        lambda: prefill(params, toks0))),
                    "decode step": (decode_ms[-1], device_times(
                        lambda: step(params, tok, cache)))}
        del logits, cache
    for name, (wall, times) in profiles.items():
        if not times:
            print(f"{name}: torch.profiler saw no device time (not measured)")
            continue
        busy = sum(times.values())
        top = sorted(times.items(), key=lambda kv: -kv[1])[:8]
        print(f"{name}: device busy {busy:.3f} ms of {wall:.3f} ms wall "
              f"({100 * busy / wall:.1f}%; torch.profiler); top kernels: "
              + "; ".join(f"{k[:70]} {v:.3f} ms" for k, v in top))
    wave_bound = sum(b for _, b in launch_work["prefill"])
    step_bound = sum(b for _, b in launch_work["decode"])
    print(f"MoE wave: prefill {prefill_ms:.3f} ms (median of 3), of which "
          f"the {per_prefill} expert-GEMM launches {wave_ms:.3f} ms "
          f"({100 * wave_ms / prefill_ms:.1f}%; bound {wave_bound:.4f} ms) "
          f"and the {cfg.n_layers} flash launches {in_place['flash']:.3f} ms "
          f"({100 * in_place['flash'] / prefill_ms:.1f}%), device time in "
          f"place; decode {decode_ms[-1]:.3f} ms per token, of which the "
          f"expert GEMM {step_ms:.3f} ms (bound {step_bound:.4f} ms; "
          f"{BATCH} sequences, {1e3 * BATCH / decode_ms[-1]:.1f} tokens/s); "
          f"peak memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    row = rows["prefill", cfg.d_model]
    entry = {
        "name": "moe_gemm",
        "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/moe_gemm.cu",
        "replaces": "src/repro/kernels/moe_gemm/moe_gemm.py:22",
        "launches": total_launches,
        "max_abs_err": worst_abs,
        # one prefill gate launch of a wave (layer 0: x (64, 968, 2048)
        # bf16, f32 out); library_ms is torch.bmm on the pre-masked inputs
        "ms": row["ms"],
        "plain_ms": row["plain_ms"],
        "bound_ms": row["bound_ms"],
        "bound_by": row["bound_by"],
        "library_ms": row["library_ms"],
        # the same launch on the device (chip_smoke.device_ms)
        "device_ms": row["device_ms"],
        "library_device_ms": row["library_device_ms"],
        "shapes": {f"{w_} d={d}": r for (w_, d), r in rows.items()},
        # summed over the launches of one wave's prefill and of one decode
        # step, timed in place
        "wave_prefill_ms": wave_ms,
        "wave_prefill_bound_ms": wave_bound,
        "decode_step_ms": step_ms,
        "decode_step_bound_ms": step_bound,
        # Moonshot's decode per token, eager steps against the step graphs
        "decode": graph_decode,
    }
    flash = {f"moe_{k}": frow[k] for k in (
        "ms", "device_ms", "plain_ms", "library_ms", "library_device_ms",
        "bound_ms", "max_abs_err")}
    return entry, flash


def lm_config_path(dev: torch.device, phase: Phases, arch: str,
                   card: str) -> dict:
    """Phase "<arch> serving" of slice 10: one config at its published
    widths (depth cut only where ``LM10_LAYERS`` says), seeded on the card,
    serving one wave of ``BATCH`` prompts of ``LM10_PROMPT`` tokens through
    ``Engine`` with ``LM10_NEW`` new tokens on the decode-step graphs. The
    flash and expert-GEMM launches are counted as ``Graphs`` counts them
    (the counters' ticks, less those recorded at capture, plus the
    replays'), one attention layer's flash launch and every expert-GEMM
    launch of a prefill and a decode step are held against their plain
    versions, and prefill, decode (graph against eager) and the kernels
    are timed. Returns the numbers for the JSON."""
    from repro_torch.configs import get_config
    from repro_torch.data.tokens import TokenStream
    from repro_torch.kernels.moe_gemm.ref import grouped_gemm_ref, moe_gemm_tol
    from repro_torch.models import attention, moe, transformer
    from repro_torch.serving.engine import Engine, Request, make_prefill, make_serve_step

    phase(f"{arch} init")
    cfg = get_config(arch)
    check((cfg.n_layers, cfg.d_model, cfg.n_heads, cfg.n_kv_heads,
           cfg.head_dim, cfg.d_ff, cfg.vocab_size, cfg.moe.n_experts,
           cfg.moe.top_k) == LM10_PUBLISHED[arch],
          f"{arch} is not at its published widths")
    check(cfg.torch_dtype == torch.bfloat16, f"{arch} runs in bf16")
    if arch in LM10_LAYERS:
        cfg = dataclasses.replace(cfg, n_layers=LM10_LAYERS[arch])
    kinds = [cfg.layer_kind(i) for i in range(cfg.n_layers)]
    n_attn = sum(k in ("global", "local") for k in kinds)
    per_prefill = 3 * cfg.n_layers if cfg.is_moe else 0
    torch.cuda.reset_peak_memory_stats()
    params = transformer.init_lm(
        cfg, device=dev, generator=torch.Generator(device=dev).manual_seed(0))
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in leaves(params))
    tokens = next(TokenStream(cfg.vocab_size, BATCH, LM10_PROMPT,
                              seed=0))["tokens"]
    prompts = [tokens[i, :LM10_PROMPT] for i in range(BATCH)]
    print(f"{arch}: {n_params / 1e9:.4f} B parameters in bf16, "
          f"{cfg.n_layers} layers{' (depth cut)' if arch in LM10_LAYERS else ''}"
          f", kinds {sorted(set(kinds))}, head dim {cfg.head_dim}; "
          f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB on the card; "
          f"batch {BATCH}, prompts of {LM10_PROMPT}, {LM10_NEW} new tokens")

    phase(f"{arch} serving")
    zero_kernel_counts()
    eng = Engine(cfg, params, BATCH, LM10_PROMPT, LM10_NEW, device=dev)
    waves = []   # (tokens, logits, flash launches, expert-GEMM launches)
    inner = eng.prefill

    def prefill_counted(p, toks):
        before = kernel_counts()
        logits, cache = inner(p, toks)
        after = kernel_counts()
        waves.append((toks, logits, after["flash_fwd"] - before["flash_fwd"],
                      after["moe_gemm"] - before["moe_gemm"]))
        return logits, cache

    eng.prefill = prefill_counted
    handles = eng.submit([Request(i, p, max_new=LM10_NEW)
                          for i, p in enumerate(prompts)])
    t0 = time.perf_counter()
    eng.serve()
    torch.cuda.synchronize()
    serve_s = time.perf_counter() - t0
    served = {h.request.rid: h.result().out for h in handles}
    eng.close()
    counts = kernel_counts()
    launches = {k: counts[k] - eng.graphs.captured[k] + eng.graphs.replayed[k]
                for k in ("flash_fwd", "moe_gemm")}
    check(launched_only("flash_fwd", "moe_gemm"),
          f"the {arch} path launched another kernel")
    check(len(waves) == 1 and waves[0][2] == n_attn,
          f"{arch}: the prefill launched flash {waves[0][2]} times, not once "
          f"an attention layer ({n_attn})")
    check(waves[0][3] == per_prefill,
          f"{arch}: the prefill launched the expert GEMM {waves[0][3]} times")
    graph_gemm = eng.wave_stats[0].notes["graph_launches"].get("moe_gemm", 0)
    check(graph_gemm == per_prefill * (LM10_NEW - 1),
          f"{arch}: the step graphs ran {graph_gemm} expert-GEMM launches")
    check(len(eng.graphs) == LM10_NEW - 1, f"{len(eng.graphs)} step graphs")
    _, logits0, _, _ = waves[0]
    check(bool(torch.isfinite(logits0).all())
          and logits0.shape == (BATCH, cfg.vocab_padded),
          f"{arch}: prefill logits not finite or of the wrong shape")
    check(all(len(o) == LM10_NEW and all(0 <= t < cfg.vocab_size for t in o)
              for o in served.values()), f"{arch}: tokens out of range")
    print(f"{arch} serve: {serve_s:.3f} s for one wave; launches on the "
          f"device {launches} (flash {waves[0][2]} in the prefill; the "
          f"expert GEMM {waves[0][3]} in the prefill, {graph_gemm} by the "
          f"{LM10_NEW - 1} step graphs' replays); tokens {served}")

    phase(f"{arch} decode graph")
    prefill = make_prefill(cfg, cache_pad=LM10_NEW)
    step = make_serve_step(cfg)
    toks0 = waves[0][0]

    def greedy(logits, cache):
        return greedy_tokens(step, params, cfg, logits, cache, LM10_NEW)

    decode = decode_graph(eng, prefill, greedy, toks0, arch, LM10_NEW)
    del eng
    gc.collect()

    phase(f"{arch} checks")
    out = {"params": n_params, "layers": cfg.n_layers, "serve_s": serve_s,
           "launches": launches, "decode": decode}
    kernel_bshd, kernel_gemm = attention.flash_attention_bshd, moe.grouped_gemm
    flash_in, gemm_in = [], []

    def record_flash(q, k, v, **kw):
        flash_in.append((q, k, v, kw))
        return kernel_bshd(q, k, v, **kw)

    def record_gemm(where):
        def run(xin, w, valid, *, out_dtype=None):
            got = kernel_gemm(xin, w, valid, out_dtype=out_dtype)
            gemm_in.append((where, xin, w, valid, got.dtype))
            return got
        return run

    with torch.inference_mode():
        attention.flash_attention_bshd = record_flash
        moe.grouped_gemm = record_gemm("prefill")
        try:
            logits, cache = prefill(params, toks0)
            tok = logits[:, :cfg.vocab_size].argmax(-1).to(torch.int32)[:, None]
            moe.grouped_gemm = record_gemm("decode")
            step(params, tok, cache)
        finally:
            attention.flash_attention_bshd = kernel_bshd
            moe.grouped_gemm = kernel_gemm
        del logits, cache
        check(len(flash_in) == n_attn and len(gemm_in) == 2 * per_prefill,
              f"{arch}: recorded {len(flash_in)} flash and {len(gemm_in)} "
              "expert-GEMM calls")
        if flash_in:
            q, k, v, kw = flash_in[0]
            out["flash"] = flash_row(
                q, k, v, kw, f"{arch}, first attention layer [{card}]")
        flash_in.clear()
        if gemm_in:
            errs, rows = [], {}
            for where, xin, w, valid, odt in gemm_in:
                got, want = kernel_vs_plain(
                    "moe_gemm", lambda: kernel_gemm(xin, w, valid,
                                                    out_dtype=odt),
                    lambda: grouped_gemm_ref(xin, w, valid, odt),
                    f"{arch} expert GEMM ({where})")
                abs_err, rel_err = max_err(got.float(), want.float())
                errs.append((abs_err, rel_err, moe_gemm_tol(xin.dtype,
                                                            got.dtype)))
                del got, want
            print(f"{arch}: every expert-GEMM launch of one prefill and one "
                  f"decode step ({len(errs)}) vs its plain version: rel "
                  f"{', '.join(f'{e[1]:.3g}' for e in errs)} (tol "
                  f"{errs[0][2]}), max abs {max(e[0] for e in errs):.3g}")
            check(all(rel <= tol for _, rel, tol in errs),
                  f"an expert-GEMM launch of {arch} disagrees")
            for where, xin, w, valid, odt in (gemm_in[0],
                                              gemm_in[per_prefill]):
                rows[where] = gemm_row(xin, w, valid, odt,
                                       f"{arch} {where} gate [{card}]")
            out["moe_gemm"] = dict(rows, max_abs_err=max(e[0] for e in errs))
        gemm_in.clear()

        phase(f"{arch} timing")
        prefill_ms = host_ms(lambda: prefill(params, toks0), 3)
        busy = busy_report(f"{arch} prefill", lambda: prefill(params, toks0),
                           prefill_ms)
    peak = torch.cuda.max_memory_allocated() / 2**30
    print(f"{arch}: prefill {prefill_ms:.3f} ms a wave of {BATCH} x "
          f"{LM10_PROMPT}; decode {decode['graph']['ms']:.3f} ms a token as "
          f"step graphs, {decode['eager']['ms']:.3f} eager; peak memory "
          f"{peak:.2f} GiB [{card}]")
    out.update(prefill_ms=prefill_ms, prefill_busy_ms=busy["busy_ms"],
               peak_gib=peak)
    return out


def recurrent_training_path(dev: torch.device, phase: Phases,
                            card: str) -> dict:
    """Phases "<arch> training" and "Maverick Adafactor": AdamW steps of
    RecurrentGemma-9B and RWKV-6-7B at their published widths, at the
    depth one card holds with the functional update's two states
    (``LM10_TRAIN``), in bf16 with remat (the backward through the
    log-depth RG-LRU scan and ``chunked_wkv``); then the twin of
    ``tests/test_training.py::test_adafactor_trains_moe``: reduced Maverick,
    Adafactor, 8 steps, a held batch's loss falling. No kernel launches in
    a step."""
    from repro_torch.configs import get_config
    from repro_torch.data.tokens import TokenStream
    from repro_torch.training import train_loop
    from repro_torch.training.optimizer import OptHParams

    out = {}
    hp = OptHParams(lr=LM_TRAIN_LR, moment_dtype=torch.float32)
    for arch, depth in LM10_TRAIN.items():
        phase(f"{arch} training")
        cfg = get_config(arch)
        check((cfg.n_layers, cfg.d_model, cfg.n_heads, cfg.n_kv_heads,
               cfg.head_dim, cfg.d_ff, cfg.vocab_size, cfg.moe.n_experts,
               cfg.moe.top_k) == LM10_PUBLISHED[arch],
              f"{arch} is not at its published widths")
        cfg = dataclasses.replace(cfg, n_layers=depth)
        check(cfg.torch_dtype == torch.bfloat16 and cfg.remat,
              f"{arch} trains in bf16 with remat")
        torch.cuda.reset_peak_memory_stats()
        state = train_loop.init_train_state(
            cfg, hp, device=dev,
            generator=torch.Generator(device=dev).manual_seed(0))
        n_params = sum(p.numel() for p in leaves(state["params"]))
        step_fn = train_loop.make_train_step(cfg, hp)
        ds = TokenStream(cfg.vocab_size, LM10_TRAIN_BATCH, LM10_TRAIN_SEQ,
                         seed=0)
        zero_kernel_counts()
        losses, step_ms = [], []
        for _ in range(LM10_TRAIN_STEPS):
            batch = next(ds)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            state, m = step_fn(state, batch)
            torch.cuda.synchronize()
            step_ms.append((time.perf_counter() - t0) * 1e3)
            losses.append(float(m["loss"]))
        peak = torch.cuda.max_memory_allocated() / 2**30
        launched = kernel_counts()
        tokens = LM10_TRAIN_BATCH * LM10_TRAIN_SEQ
        print(f"{arch} training: {n_params / 1e9:.4f} B parameters ({depth} "
              f"of {get_config(arch).n_layers} layers), AdamW steps of "
              f"{LM10_TRAIN_BATCH} x {LM10_TRAIN_SEQ} tokens: "
              f"{', '.join(f'{t:.1f}' for t in step_ms)} ms "
              f"({tokens / step_ms[-1] * 1e3:.1f} tokens/s at the last); "
              f"peak memory {peak:.2f} GiB; loss "
              f"{', '.join(f'{x:.4f}' for x in losses)}; kernel launches "
              f"{launched} [{card}]")
        check(all(np.isfinite(losses)), f"{arch}: a non-finite loss")
        check(not any(launched.values()), f"an {arch} train step launched a "
              "kernel")
        out[arch] = {"layers": depth, "params": n_params, "step_ms": step_ms,
                     "peak_gib": peak, "losses": losses}
        del state, m, step_fn
        gc.collect()
        torch.cuda.empty_cache()

    phase("Maverick Adafactor")
    mcfg = get_config(LM10_MOE).reduced()
    check(mcfg.optimizer == "adafactor", "Maverick trains with Adafactor")
    mhp = OptHParams(lr=1e-3)
    mstate = train_loop.init_train_state(
        mcfg, mhp, device=dev,
        generator=torch.Generator(device=dev).manual_seed(0))
    mstep = train_loop.make_train_step(mcfg, mhp)
    mds = TokenStream(mcfg.vocab_size, 4, 32, 1)
    # each step's loss is on a fresh batch, which moves it by ~0.1 at this
    # size (as much as 8 steps at lr 1e-3 gain): the loss that must fall is
    # that of one held batch, before and after the steps
    held = next(TokenStream(mcfg.vocab_size, 16, 32, 99))
    loss_fn = train_loop.make_loss_fn(mcfg)

    def held_loss():
        with torch.no_grad():
            return float(loss_fn(mstate["params"], held)[1]["loss"])

    zero_kernel_counts()
    before = held_loss()
    mlosses = []
    for _ in range(8):
        mstate, mm = mstep(mstate, next(mds))
        mlosses.append(float(mm["loss"]))
    after = held_loss()
    launched = kernel_counts()
    print(f"{LM10_MOE} reduced, Adafactor: 8 steps, loss "
          f"{', '.join(f'{x:.4f}' for x in mlosses)}; a held batch's loss "
          f"{before:.4f} -> {after:.4f}; kernel launches {launched} [{card}]")
    check(all(np.isfinite(mlosses)), "a non-finite Maverick loss")
    check(after < before, "the Maverick Adafactor loss did not fall")
    check(not any(launched.values()), "a Maverick train step launched a "
          "kernel")
    out["maverick_adafactor"] = {"losses": mlosses, "held_before": before,
                                 "held_after": after}
    del mstate
    return out


def part_c_inputs(cfg, dev: torch.device, batch: int, length: int,
                  seed: int) -> tuple[np.ndarray, dict]:
    """A ``TokenStream`` batch of ``length`` (+1) tokens, and the config's
    other input drawn on the card in its dtype from ``seed``: Pixtral's
    patch embeddings (``n_frontend_tokens`` a row) or Seamless's source
    frames (``ENCDEC_SRC`` a row)."""
    from repro_torch.data.tokens import TokenStream

    toks = next(TokenStream(cfg.vocab_size, batch, length, seed=seed))["tokens"]
    g = torch.Generator(device=dev).manual_seed(seed)
    rows = (cfg.n_frontend_tokens if cfg.frontend == "vision"
            else ENCDEC_SRC)
    x = torch.randn((batch, rows, cfg.d_model), generator=g, device=dev,
                    dtype=cfg.torch_dtype)
    return toks, ({"frontend_embeds": x} if cfg.frontend == "vision"
                  else {"enc_frames": x})


def part_c_path(dev: torch.device, phase: Phases, arch: str,
                card: str) -> dict:
    """Phases "<arch> ..." of slice 10 part c: Pixtral-12B or
    SeamlessM4T-medium at its published widths and depth, seeded on the
    card, serving one wave through ``make_prefill`` (with the patch
    embeddings or the source frames) and ``Engine.decode`` on the
    decode-step graphs; graph tokens against eager steps; every flash
    launch of a prefill (Pixtral: a self-attention a layer; Seamless: an
    encoder layer's without a causal mask, then a decoder layer's causal
    self-attention and its cross attention, Sq < Skv) held against its
    plain version, the first of each kind timed through ``flash_row``;
    prefill and decode timed with their busy shares. Returns the numbers
    for the JSON."""
    from repro_torch.configs import get_config
    from repro_torch.kernels.flash.flash import flash_attention_plain
    from repro_torch.kernels.flash.ref import FLASH_TOL
    from repro_torch.models import attention, transformer
    from repro_torch.serving.engine import Engine, make_prefill, make_serve_step

    phase(f"{arch} init")
    cfg = get_config(arch)
    check((cfg.n_layers, cfg.d_model, cfg.n_heads, cfg.n_kv_heads,
           cfg.head_dim, cfg.d_ff, cfg.vocab_size, cfg.moe.n_experts,
           cfg.moe.top_k) == PART_C_PUBLISHED[arch],
          f"{arch} is not at its published widths")
    check(cfg.torch_dtype == torch.bfloat16, f"{arch} runs in bf16")
    length = ENCDEC_PROMPT if cfg.is_encdec else VLM_PROMPT
    kinds = (["encoder"] * cfg.encoder_layers + ["self", "cross"] * cfg.n_layers
             if cfg.is_encdec else ["self"] * cfg.n_layers)
    torch.cuda.reset_peak_memory_stats()
    params = transformer.init_lm(
        cfg, device=dev, generator=torch.Generator(device=dev).manual_seed(0))
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in leaves(params))
    toks, extra = part_c_inputs(cfg, dev, BATCH, length, 0)
    toks = torch.as_tensor(toks[:, :length], device=dev)
    print(f"{arch}: {n_params / 1e9:.4f} B parameters in bf16, "
          f"{cfg.n_layers} layers" + (f" and {cfg.encoder_layers} encoder "
                                      f"layers" if cfg.is_encdec else "")
          + f"; {torch.cuda.memory_allocated() / 2**30:.2f} GiB on the card; "
          f"batch {BATCH}, prompts of {length}, "
          + ", ".join(f"{k} {tuple(v.shape)}" for k, v in extra.items())
          + f", {LM10_NEW} new tokens")

    phase(f"{arch} serving")
    zero_kernel_counts()
    eng = Engine(cfg, params, BATCH, length, LM10_NEW, device=dev)
    prefill = make_prefill(cfg, cache_pad=LM10_NEW)
    notes: dict = {}
    with torch.inference_mode():
        t0 = time.perf_counter()
        logits, cache = prefill(params, toks, **extra)
        n_flash = kernel_counts()["flash_fwd"]
        served = eng.decode(logits, cache, notes=notes)
        torch.cuda.synchronize()
        serve_s = time.perf_counter() - t0
    del cache
    check(n_flash == len(kinds), f"{arch}: the prefill launched flash "
          f"{n_flash} times, not {len(kinds)}")
    check(launched_only("flash_fwd"), f"the {arch} path launched another "
          "kernel")
    check(kernel_counts()["flash_fwd"] == n_flash
          and not notes["graph_launches"].get("flash_fwd"),
          f"{arch}: flash launched in decode")
    check(len(eng.graphs) == LM10_NEW - 1, f"{len(eng.graphs)} step graphs")
    check(bool(torch.isfinite(logits).all())
          and logits.shape == (BATCH, cfg.vocab_padded),
          f"{arch}: prefill logits not finite or of the wrong shape")
    check(tuple(served.shape) == (BATCH, LM10_NEW)
          and bool(((served >= 0) & (served < cfg.vocab_size)).all()),
          f"{arch}: tokens out of range")
    print(f"{arch} serve: {serve_s:.3f} s for one wave (make_prefill and "
          f"Engine.decode); flash {n_flash} in the prefill "
          f"({', '.join(f'{k} {kinds.count(k)}' for k in dict.fromkeys(kinds))}"
          f"), none in the {LM10_NEW - 1} step graphs; tokens "
          f"{served.tolist()}")

    phase(f"{arch} decode graph")
    step = make_serve_step(cfg)

    def prefill_extra(p, t):
        return prefill(p, t, **extra)

    def greedy(logits, cache):
        return greedy_tokens(step, params, cfg, logits, cache, LM10_NEW)

    decode = decode_graph(eng, prefill_extra, greedy, toks, arch, LM10_NEW)
    eng.close()
    del eng
    gc.collect()

    phase(f"{arch} checks")
    out = {"params": n_params, "layers": cfg.n_layers, "serve_s": serve_s,
           "launches": n_flash, "decode": decode}
    kernel_bshd = attention.flash_attention_bshd
    flash_in = []

    def record_flash(q, k, v, **kw):
        flash_in.append((q, k, v, kw))
        return kernel_bshd(q, k, v, **kw)

    with torch.inference_mode():
        attention.flash_attention_bshd = record_flash
        try:
            prefill(params, toks, **extra)
        finally:
            attention.flash_attention_bshd = kernel_bshd
        check(len(flash_in) == len(kinds),
              f"{arch}: recorded {len(flash_in)} flash calls")
        rows, worst = {}, {}
        for i, (kind, (q, k, v, kw)) in enumerate(zip(kinds, flash_in)):
            if kind not in rows:
                rows[kind] = flash_row(q, k, v, kw,
                                       f"{arch}, {kind} attention [{card}]")
                err = rows[kind]["rel_err"]
            else:
                got, want = kernel_vs_plain(
                    "flash_fwd", lambda: kernel_bshd(q, k, v, **kw),
                    lambda: flash_attention_plain(q, k, v, **kw),
                    f"{arch} flash launch {i} ({kind})")
                err = max_err(got.float(), want.float())[1]
                del got, want
            check(err <= FLASH_TOL[q.dtype],
                  f"{arch}: flash launch {i} ({kind}) disagrees")
            worst[kind] = max(worst.get(kind, 0.0), err)
        flash_in.clear()
        print(f"{arch}: every flash launch of a prefill ({len(kinds)}) vs "
              f"its plain version, worst rel by kind: "
              + ", ".join(f"{k} {kinds.count(k)} launches {e:.3g}"
                          for k, e in worst.items())
              + f" (tol {FLASH_TOL[torch.bfloat16]})")
        out["flash"] = {k: dict(r, launches=kinds.count(k),
                                worst_rel_err=worst[k])
                        for k, r in rows.items()}

        phase(f"{arch} timing")
        prefill_ms = host_ms(lambda: prefill(params, toks, **extra), 3)
        busy = busy_report(f"{arch} prefill",
                           lambda: prefill(params, toks, **extra), prefill_ms)
    peak = torch.cuda.max_memory_allocated() / 2**30
    print(f"{arch}: prefill {prefill_ms:.3f} ms a wave of {BATCH} x {length}"
          f"; decode {decode['graph']['ms']:.3f} ms a token as step graphs, "
          f"{decode['eager']['ms']:.3f} eager; peak memory {peak:.2f} GiB "
          f"[{card}]")
    out.update(prefill_ms=prefill_ms, prefill_busy_ms=busy["busy_ms"],
               peak_gib=peak)
    return out


def part_c_training_path(dev: torch.device, phase: Phases,
                         card: str) -> dict:
    """Phases "pixtral-12b training" and "seamless-m4t-medium training":
    AdamW steps (f32 moments, bf16 with remat) of Pixtral-12B at its
    published widths and ``VLM_TRAIN_LAYERS`` of its 40 layers, the patch
    embeddings a batch key, and of SeamlessM4T-medium at full depth over
    ``ENCDEC_TRAIN_STEPS`` batches of source frames and tokens, where a
    held batch's loss must fall. No kernel launches in a step."""
    from repro_torch.configs import get_config
    from repro_torch.training import train_loop
    from repro_torch.training.optimizer import OptHParams

    out = {}
    hp = OptHParams(lr=LM_TRAIN_LR, moment_dtype=torch.float32)
    for arch, depth, steps in ((VLM_ARCH, VLM_TRAIN_LAYERS, LM10_TRAIN_STEPS),
                               (ENCDEC_ARCH, None, ENCDEC_TRAIN_STEPS)):
        phase(f"{arch} training")
        cfg = get_config(arch)
        if depth is not None:
            cfg = dataclasses.replace(cfg, n_layers=depth)
        check(cfg.torch_dtype == torch.bfloat16 and cfg.remat,
              f"{arch} trains in bf16 with remat")
        length = ENCDEC_PROMPT if cfg.is_encdec else VLM_PROMPT
        torch.cuda.reset_peak_memory_stats()
        state = train_loop.init_train_state(
            cfg, hp, device=dev,
            generator=torch.Generator(device=dev).manual_seed(0))
        n_params = sum(p.numel() for p in leaves(state["params"]))
        step_fn = train_loop.make_train_step(cfg, hp)
        loss_fn = train_loop.make_loss_fn(cfg)

        def batch(seed, rows=LM10_TRAIN_BATCH):
            toks, extra = part_c_inputs(cfg, dev, rows, length, seed)
            return dict(extra, tokens=toks)

        held = batch(99, 4)

        def held_loss():
            with torch.no_grad():
                return float(loss_fn(state["params"], held)[1]["loss"])

        zero_kernel_counts()
        before = held_loss()
        losses, step_ms = [], []
        for i in range(steps):
            b = batch(i + 1)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            state, m = step_fn(state, b)
            torch.cuda.synchronize()
            step_ms.append((time.perf_counter() - t0) * 1e3)
            losses.append(float(m["loss"]))
        after = held_loss()
        peak = torch.cuda.max_memory_allocated() / 2**30
        launched = kernel_counts()
        print(f"{arch} training: {n_params / 1e9:.4f} B parameters "
              f"({cfg.n_layers} of {get_config(arch).n_layers} layers), "
              f"AdamW steps of {LM10_TRAIN_BATCH} x {length} tokens: "
              f"{', '.join(f'{t:.1f}' for t in step_ms)} ms; peak memory "
              f"{peak:.2f} GiB; loss {', '.join(f'{x:.4f}' for x in losses)}"
              f"; a held batch's loss {before:.4f} -> {after:.4f}; kernel "
              f"launches {launched} [{card}]")
        check(all(np.isfinite(losses)), f"{arch}: a non-finite loss")
        check(not any(launched.values()), f"an {arch} train step launched "
              "a kernel")
        if cfg.is_encdec:
            check(after < before, f"the {arch} held batch's loss did not "
                  "fall")
        out[arch] = {"layers": cfg.n_layers, "params": n_params,
                     "step_ms": step_ms, "peak_gib": peak, "losses": losses,
                     "held_before": before, "held_after": after}
        del state, m, step_fn, held
        gc.collect()
        torch.cuda.empty_cache()
    return out


def scn_sharded_path(dev: torch.device, phase: Phases, seed0: dict,
                     card: str) -> dict:
    """Phases "SCN sharded" (slice 9): seed 0's scene at the published
    widths split over each of ``SHARDS`` shards, run as the loop over
    shards on the card (one card holds them all; the process form needs a
    card a shard): host plan seconds, halo rows a conv, logits against the
    unsharded ``reference`` (``LOGITS_TOL``) and two runs bit for bit, the
    forward's ms and busy share beside ``reference``'s, and no kernel
    wrapper launched (the sharded path is plain ops, as the JAX package's
    is). Then a ``SceneEngine(layout=pin_halo(...))`` serves seeds 0-1 as
    one wave of 2: each scene's logits equal its own sharded forward."""
    from repro_torch import engine
    from repro_torch.data.scenes import make_scene
    from repro_torch.serving.scene_engine import SceneEngine, SceneRequest
    from repro_torch.sparse.tensor import SparseVoxelTensor

    cfg, model, feats = seed0["cfg"], seed0["model"], seed0["feats"]
    scenes = []
    for seed in (0, 1):
        coords, f, _, mask = make_scene(seed, RESOLUTION, CAPACITY,
                                        points_per_unit=POINTS_PER_UNIT)
        scenes.append(SparseVoxelTensor(coords, f, mask))
    out = {}
    with torch.inference_mode():
        ref = engine.apply_unet(model, feats, seed0["plan"],
                                backend="reference", device=dev)
        ref_ms = host_ms(lambda: engine.apply_unet(
            model, feats, seed0["plan"], backend="reference", device=dev), 3)
        print(f"SCN sharded: the unsharded reference forward of seed 0 "
              f"{ref_ms:.3f} ms")
        for n in SHARDS:
            phase(f"SCN sharded {n}")
            t0 = time.perf_counter()
            host = engine.build_sharded_scene_plan_host(
                scenes[0], cfg, layout=engine.ShardLayout(n_shards=n))
            plan_s = time.perf_counter() - t0
            plan = host.device_upload(dev)
            halo = [(f"L{lvl['level']} {site}", rows)
                    for lvl in host.stats
                    for site, rows in lvl["halo_rows"].items()]
            zero_kernel_counts()
            a = engine.apply_unet(model, feats, plan, device=dev)
            b = engine.apply_unet(model, feats, plan, device=dev)
            torch.cuda.synchronize()
            check(launched_only(), f"the {n}-shard forward launched a kernel "
                  f"wrapper: {kernel_counts()}")
            check(a.shape == ref.shape and bool(torch.isfinite(a).all()),
                  "sharded logits not finite or of the wrong shape")
            check(torch.equal(a, b), f"two {n}-shard runs differ")
            abs_err, rel_err = max_err(a, ref)
            check(rel_err <= LOGITS_TOL, f"{n}-shard logits disagree with "
                  "reference")
            fwd_ms = host_ms(lambda: engine.apply_unet(model, feats, plan,
                                                       device=dev), 3)
            busy = busy_report(f"SCN sharded {n}", lambda: engine.apply_unet(
                model, feats, plan, device=dev), fwd_ms)
            print(f"SCN sharded {n}: host plan {plan_s:.2f} s; halo rows a "
                  f"conv {', '.join(f'{k} {r}' for k, r in halo)} "
                  f"({host.halo_rows()} a forward, budget "
                  f"{max(max(lvl['halo_budget'].values()) for lvl in host.stats)}"
                  f" a pair); forward {fwd_ms:.3f} ms (the loop over {n} "
                  f"shards; reference {ref_ms:.3f}); logits vs reference max "
                  f"abs {abs_err:.3g} rel {rel_err:.3g} (tol {LOGITS_TOL}), "
                  f"two runs bit for bit; kernel launches {kernel_counts()} "
                  f"[{card}]")
            out[n] = {"plan_s": plan_s, "halo_rows": dict(halo),
                      "halo_rows_total": host.halo_rows(), "forward_ms": fwd_ms,
                      "busy_ms": busy["busy_ms"], "rel_err": rel_err,
                      "max_abs_err": abs_err}
            del plan, a, b

    phase("SCN sharded serving")
    n = SHARDS[0]
    t0 = time.perf_counter()
    layout = engine.pin_halo(scenes, cfg, engine.ShardLayout(n_shards=n))
    pin_s = time.perf_counter() - t0
    ctx = engine.ExecutionContext(device=dev)
    eng = SceneEngine(cfg, model, batch=2, ctx=ctx, layout=layout)
    zero_kernel_counts()
    t0 = time.perf_counter()
    handles = eng.submit([SceneRequest(i, t) for i, t in enumerate(scenes)])
    eng.serve()
    serve_s = time.perf_counter() - t0
    check(launched_only(), "the sharded wave launched a kernel wrapper")
    check(len(eng.wave_stats) == 1 and eng.n_compilations == 1,
          f"{len(eng.wave_stats)} waves, {eng.n_compilations} signatures")
    notes = eng.wave_stats[0].notes
    check(notes["plan_shards"] == n and notes["plan_builds"] == 2
          and notes["halo_rows"] > 0, f"sharded wave notes {notes}")
    with torch.inference_mode():
        for h in handles:
            r = h.result()
            plan = eng.cache.get_or_build(
                r.scene, cfg, topology=ctx.topology_key(),
                builder=engine.build_sharded_scene_plan_host, device=dev,
                layout=layout)
            own = engine.apply_unet(model, r.scene.feats, plan,
                                    device=dev).cpu().numpy()
            check(np.array_equal(own, r.logits), f"scene {r.rid}: the wave's "
                  "logits differ from its own sharded forward")
        _, rel0 = max_err(torch.from_numpy(handles[0].result().logits),
                          ref.cpu())
        check(rel0 <= LOGITS_TOL, "the wave's seed 0 logits disagree with "
              "reference")
    eng.close()
    print(f"SCN sharded serving: layout {layout} pinned in {pin_s:.1f} s; "
          f"a wave of 2 through SceneEngine(layout=) in {serve_s:.2f} s "
          f"(host plans included), notes {notes}; each scene's logits equal "
          f"its own sharded forward, seed 0's within {rel0:.3g} of "
          f"reference; kernel launches {kernel_counts()} [{card}]")
    out["serving"] = {"pin_s": pin_s, "serve_s": serve_s, "halo": layout.halo,
                      "notes": notes}
    out["reference_ms"] = ref_ms
    return out


def dist_moe_layer(dev: torch.device):
    """One Moonshot 16B-A3B MoE layer at its published widths, drawn on the
    card from seed 0, and its input of ``DIST_GROUPS`` groups of
    ``DIST_GROUP_TOKENS`` tokens from seed 1: (params, x, apply_moe's
    keywords). Every rank and the parent draw the same."""
    from repro_torch.configs import get_config
    from repro_torch.models import moe

    cfg = get_config(MOE_ARCH)
    check((cfg.d_model, cfg.d_ff, cfg.moe.n_experts, cfg.moe.top_k,
           cfg.moe.capacity_factor) == (2048, 1408, 64, 6, 1.25),
          f"{MOE_ARCH}'s MoE layer is not at its published widths")
    check(cfg.torch_dtype == torch.bfloat16, "the MoE layer runs in bf16")
    params = moe.init_moe(torch.Generator(device=dev).manual_seed(0),
                          cfg.d_model, cfg.d_ff, cfg.moe.n_experts, cfg.act,
                          cfg.torch_dtype, dev)
    x = torch.randn((DIST_GROUPS, DIST_GROUP_TOKENS, cfg.d_model),
                    generator=torch.Generator(device=dev).manual_seed(1),
                    device=dev).to(cfg.torch_dtype)
    kw = dict(top_k=cfg.moe.top_k, act=cfg.act, capacity=moe.moe_capacity(
        DIST_GROUP_TOKENS, cfg.moe.top_k, cfg.moe.n_experts,
        cfg.moe.capacity_factor))
    return params, x, kw


def dist_grads(part: dict, rank: int, dev: torch.device) -> dict:
    """Rank ``rank``'s gradients of a rank's share of the MoE layer (f32,
    seeded by the rank), the tree ``compressed_psum`` sums."""
    gen = torch.Generator(device=dev).manual_seed(100 + rank)
    return {k: torch.randn(v.shape, generator=gen, device=dev) * 1e-3
            for k, v in sorted(part.items())}


def dist_rank(rank: int, port: int, card: str, out) -> None:
    """One rank of the "dist" phase, in a spawned process (the parent holds
    a CUDA context): its results, or the traceback, go to ``out``."""
    import torch.distributed as dist

    try:
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}",
                                world_size=DIST_RANKS, rank=rank)
        try:
            res = dist_rank_body(rank, card)
        finally:
            dist.destroy_process_group()
        out.put((rank, res, None))
    except Exception:
        out.put((rank, None, traceback.format_exc()))
        raise


def dist_rank_body(rank: int, card: str) -> dict:
    import torch.distributed as dist

    from repro_torch.configs import get_config
    from repro_torch.dist import ShardingRules, compressed_psum, expert_all_to_all
    from repro_torch.dist.compat import make_mesh
    from repro_torch.kernels.moe_gemm.ref import grouped_gemm_ref, moe_gemm_tol
    from repro_torch.models import moe
    from repro_torch.training import checkpoint, grad_compress, train_loop
    from repro_torch.training.optimizer import OptHParams
    from repro_torch.training.tree import tree_leaves, tree_leaves_with_path

    dev = torch.device(DEVICE)
    mesh = make_mesh((DIST_RANKS,), ("model",), device=DEVICE)
    group = mesh.get_group("model")

    def in_turn(fn):
        """``fn()`` on this rank while the other ranks wait at a barrier,
        so its timings see the card alone."""
        got = None
        for r in range(DIST_RANKS):
            if r == rank:
                got = fn()
                torch.cuda.synchronize()
            dist.barrier(group=group)
        return got

    res = {}
    # -- expert-parallel MoE: the rank's groups and experts of the layer
    params, x, kw = dist_moe_layer(dev)
    part, xl = moe.expert_shard(params, x, rank, DIST_RANKS)
    part = {k: v.clone() for k, v in part.items()}
    xl = xl.clone()
    del params, x
    kernel_gemm, calls = moe.grouped_gemm, []

    def record(xin, w, valid, *, out_dtype=None):
        got = kernel_gemm(xin, w, valid, out_dtype=out_dtype)
        calls.append((xin, w, valid, got.dtype))
        return got

    def layer():
        return moe.apply_moe(part, xl, mesh=mesh, dispatch="a2a", **kw)

    with torch.inference_mode():
        zero_kernel_counts()
        moe.grouped_gemm = record
        try:
            y, aux = layer()
        finally:
            moe.grouped_gemm = kernel_gemm
        torch.cuda.synchronize()
        res["launches"] = kernel_counts()
        res["out"] = y.view(torch.int16).cpu().numpy()
        res["aux"] = {k: v.float().cpu().numpy() for k, v in aux.items()}
        res["layer_ms"] = host_ms(layer, DIST_REPS)
        e, cap = part["router"].shape[1], kw["capacity"]
        d = xl.shape[2]
        block = torch.randn((DIST_GROUPS // DIST_RANKS, e, cap, d),
                            device=dev).to(xl.dtype)
        expert_major = torch.randn((DIST_GROUPS, e // DIST_RANKS, cap, d),
                                   device=dev).to(xl.dtype)
        res["exchange_ms"] = host_ms(
            lambda: expert_all_to_all(mesh, block), DIST_REPS)
        res["inverse_ms"] = host_ms(lambda: expert_all_to_all(
            mesh, expert_major, split_axis=0, concat_axis=1), DIST_REPS)
        # what leaves this rank in one exchange: all blocks but its own
        res["exchange_bytes"] = (block.numel() * block.element_size()
                                 * (DIST_RANKS - 1) // DIST_RANKS)
        del block, expert_major
        names = ("gate", "up", "down")[-len(calls):]

        def check_and_time():
            errs = []
            for name, (xin, w, valid, odt) in zip(names, calls):
                got, want = kernel_vs_plain(
                    "moe_gemm",
                    lambda: kernel_gemm(xin, w, valid, out_dtype=odt),
                    lambda: grouped_gemm_ref(xin, w, valid, odt),
                    f"rank {rank} a2a expert GEMM ({name})")
                abs_err, rel_err = max_err(got.float(), want.float())
                errs.append((name, abs_err, rel_err,
                             moe_gemm_tol(xin.dtype, odt)))
                del got, want
            print(f"dist rank {rank}: every expert-GEMM launch of the a2a "
                  "layer vs its plain version: " + "; ".join(
                      f"{n} rel {r:.3g} abs {a:.3g} (tol {t})"
                      for n, a, r, t in errs), flush=True)
            check(all(r <= t for _, _, r, t in errs),
                  f"rank {rank}: an a2a expert-GEMM launch disagrees")
            rows = {name: gemm_row(xin, w, valid, odt,
                                   f"dist rank {rank} a2a {name} [{card}]")
                    for name, (xin, w, valid, odt) in zip(names, calls)}
            return errs, rows

        res["errs"], res["rows"] = in_turn(check_and_time)
        calls.clear()

        # -- the EF-int8 sum of each rank's gradients
        mine = dist_grads(part, rank, dev)
        summed = compressed_psum(mesh, mine, axis="model")
        torch.cuda.synchronize()
        trips = [grad_compress.compress_decompress(
            dist_grads(part, r, dev),
            {k: torch.zeros_like(v) for k, v in mine.items()})[0]
            for r in range(DIST_RANKS)]
        want = trips[0]
        for t in trips[1:]:
            want = {k: want[k] + t[k] for k in want}
        res["psum_equal"] = all(torch.equal(summed[k], want[k]) for k in want)
        del trips, want, summed
        res["psum_ms"] = host_ms(
            lambda: compressed_psum(mesh, mine, axis="model"), 3)
        n_blocks = sum(-(-v.numel() // grad_compress.BLOCK)
                       for v in mine.values())
        res["psum_elems"] = sum(v.numel() for v in mine.values())
        # each rank sends its int8 blocks and f32 scales to every other rank
        res["psum_bytes"] = n_blocks * (grad_compress.BLOCK + 4) * (
            DIST_RANKS - 1)
        del mine, part, xl

    # -- elastic restore of "LM training"'s checkpoint onto the ranks
    ccfg = get_config(LM_TRAIN_ARCH)
    hp = OptHParams(lr=LM_TRAIN_LR, moment_dtype=torch.float32)
    template = train_loop.init_train_state(ccfg, hp, device="meta")
    shardings = ShardingRules(ccfg, mesh).state_shardings(template)
    dist.barrier(group=group)
    t0 = time.perf_counter()
    restored, man = checkpoint.restore(str(LM_CKPT_DIR), LM_CKPT_STEP,
                                       template, device=dev,
                                       shardings=shardings)
    torch.cuda.synchronize()
    res["restore_s"] = time.perf_counter() - t0
    res["restore_step"] = man["step"]
    equal, n_sharded, local_bytes, total_bytes = True, 0, 0, 0
    with np.load(LM_CKPT_DIR / f"step_{LM_CKPT_STEP:08d}" / "arrays.npz") as arrays:
        for (path, leaf), sh in zip(tree_leaves_with_path(restored),
                                    tree_leaves(shardings), strict=True):
            key = "/".join(map(str, path))
            saved = torch.from_numpy(arrays[key])
            if man["dtypes"][key] == checkpoint.BF16:
                saved = saved.view(torch.bfloat16)
            local = leaf.to_local()
            (place,) = leaf.placements
            if place.is_shard():
                n_sharded += 1
                saved = saved.chunk(DIST_RANKS, dim=place.dim)[rank]
            equal &= (local.dtype == saved.dtype
                      and torch.equal(local.cpu(), saved)
                      and ("model" in sh.spec) == place.is_shard())
            local_bytes += local.numel() * local.element_size()
            total_bytes += saved.numel() * saved.element_size() * (
                DIST_RANKS if place.is_shard() else 1)
    res.update(restore_equal=equal, restore_leaves=len(tree_leaves(restored)),
               restore_sharded=n_sharded, restore_local_gib=local_bytes / 2**30,
               restore_total_gib=total_bytes / 2**30)
    return res


def dist_path(dev: torch.device, phase: Phases, card: str) -> dict:
    """Phase "dist": the distribution layer over ``DIST_RANKS`` processes
    that share the card in a gloo group (the expert-parallel MoE layer, the
    compressed sum, the elastic restore; ``dist_rank_body``), held against
    the same MoE layer's gather dispatch in this process. Removes the
    checkpoint of "LM training" at its end. Returns numbers for the JSON."""
    from repro_torch.models import moe

    phase("dist")
    try:
        params, x, kw = dist_moe_layer(dev)
        with torch.inference_mode():
            zero_kernel_counts()
            want, want_aux = moe.apply_moe(params, x, **kw)
            torch.cuda.synchronize()
            gather_launches = kernel_counts()
            gather_ms = host_ms(lambda: moe.apply_moe(params, x, **kw),
                                DIST_REPS)
        want = want.cpu()
        want_aux = {k: v.float().cpu() for k, v in want_aux.items()}
        del params, x
        gc.collect()
        torch.cuda.empty_cache()
        with socket.socket() as s:
            s.bind(("127.0.0.1", 0))
            port = s.getsockname()[1]
        ctx = multiprocessing.get_context("spawn")
        out = ctx.Queue()
        procs = [ctx.Process(target=dist_rank, args=(r, port, card, out))
                 for r in range(DIST_RANKS)]
        for p in procs:
            p.start()
        results, deadline = {}, time.monotonic() + DIST_WAIT_S
        try:
            while len(results) < DIST_RANKS:
                try:
                    rank, res, err = out.get(timeout=5)
                except queue.Empty:
                    died = {p.pid: p.exitcode for p in procs
                            if p.exitcode not in (None, 0)}
                    check(not died, f"a dist rank died: exit codes {died}")
                    check(time.monotonic() < deadline,
                          f"the dist ranks gave no result in {DIST_WAIT_S} s")
                    continue
                check(err is None, f"dist rank {rank} failed:\n{err}")
                results[rank] = res
            for p in procs:
                p.join(60)
        finally:
            for p in procs:
                if p.is_alive():
                    p.kill()
                    p.join(5)
    finally:
        shutil.rmtree(LM_CKPT_DIR, ignore_errors=True)

    got = torch.cat([torch.from_numpy(results[r]["out"]).view(torch.bfloat16)
                     for r in range(DIST_RANKS)])
    bitwise = torch.equal(got, want)
    err = norm_err(got, want)
    n_diff = int((got != want).sum())
    aux_err = max(norm_err(torch.from_numpy(results[r]["aux"][k]),
                           want_aux[k])
                  for r in range(DIST_RANKS) for k in want_aux)
    launches = [results[r]["launches"] for r in range(DIST_RANKS)]
    print(f"dist: {MOE_ARCH} MoE layer (64 experts top-6, d_model 2048, d_ff "
          f"1408, bf16) over {DIST_GROUPS} groups of {DIST_GROUP_TOKENS} "
          f"tokens, dispatch='a2a' over {DIST_RANKS} processes sharing the "
          f"card (gloo): launches per rank {launches}; the ranks' outputs "
          f"against the one-process gather: equal bit for bit {bitwise} "
          f"({n_diff} of {got.numel()} elements differ, max |d| / max(|want|,"
          f" 1) {err:.3g}, tol {MOE_BF16_TOL}); aux max |d| {aux_err:.3g}; "
          f"gather launches {gather_launches['moe_gemm']} [{card}]")
    check(all(n == {"sspnna_fused": 0, "sspnna_tiles": 0, "flash_fwd": 0,
                    "moe_gemm": 3} for n in launches),
          f"a rank's a2a layer launched {launches}, not the expert GEMM 3 "
          "times")
    check(err <= MOE_BF16_TOL, "the a2a layer disagrees with the gather")
    check(aux_err <= 1e-5 and all(torch.equal(
        torch.from_numpy(results[r]["aux"]["expert_load"]),
        want_aux["expert_load"]) for r in range(DIST_RANKS)),
        "the a2a auxiliaries disagree with the gather's")
    for r in range(DIST_RANKS):
        res = results[r]
        print(f"dist rank {r}: a2a layer {res['layer_ms']:.3f} ms (host "
              f"clock ending in a synchronize, median of {DIST_REPS}; both "
              f"ranks at once); exchange (G/S, E, cap, d) -> (G, E/S, cap, d) "
              f"{res['exchange_ms']:.3f} ms, inverse {res['inverse_ms']:.3f} "
              f"ms ({res['exchange_bytes'] / 2**20:.2f} MiB leave the rank "
              f"each way, gloo through the host); the one-process gather "
              f"{gather_ms:.3f} ms [{card}]")
        print(f"dist rank {r}: compressed_psum of {res['psum_elems']} f32 "
              f"gradients (its 32 experts and the router) over {DIST_RANKS} "
              f"ranks: {res['psum_ms']:.3f} ms (median of 3), "
              f"{res['psum_bytes'] / 2**20:.2f} MiB sent by the rank (int8 "
              f"blocks and f32 scales), sum equal to the ranks' round trips "
              f"bit for bit: {res['psum_equal']} [{card}]")
        print(f"dist rank {r}: restore of the {LM_TRAIN_ARCH} state (step "
              f"{res['restore_step']}) with ShardingRules.state_shardings on "
              f"('model',) = ({DIST_RANKS},): {res['restore_s']:.3f} s, "
              f"{res['restore_sharded']} of {res['restore_leaves']} leaves "
              f"split, {res['restore_local_gib']:.2f} GiB of "
              f"{res['restore_total_gib']:.2f} on this rank; local shards "
              f"equal to the saved slices bit for bit: "
              f"{res['restore_equal']} [{card}]")
        check(res["psum_equal"], f"rank {r}: compressed_psum differs from "
              "the ranks' round trips")
        check(res["restore_equal"] and res["restore_step"] == LM_CKPT_STEP,
              f"rank {r}: a restored shard differs from the saved slice")
        check(res["restore_sharded"] > 0, "the restore split no leaf")
    return {"launches": [n["moe_gemm"] for n in launches],
            "bitwise_equal_to_gather": bitwise, "max_err": err,
            "elements_differing": n_diff, "gather_ms": gather_ms,
            "ranks": [{k: v for k, v in results[r].items()
                       if k not in ("out", "aux", "launches")}
                      for r in range(DIST_RANKS)]}


# the "dryrun" phase's cells (registry names), on the 16x16 production mesh
DRYRUN_CELLS = (("stablelm-1.6b", "decode_32k"),
                ("moonshot-v1-16b-a3b", "prefill_32k"))


def analysis_path(dev: torch.device, phase: Phases) -> dict:
    """Phase 26: ``python -m repro_torch.analysis`` (all four passes), then
    its ``hlo`` pass's fused conv held against its plain version, with its
    device kernels and the modeled geometry against the launch's."""
    from repro_torch.analysis.__main__ import (
        C_IN,
        C_OUT,
        FUSED_KERNELS,
        fused_case,
    )
    from repro_torch.analysis.__main__ import main as analysis_main
    from repro_torch.analysis.hlo_gates import (
        device_kernels,
        forbidden_ops,
        geometry,
        only_kernels,
    )
    from repro_torch.kernels.sspnna.sspnna import KERNEL, launch_geometry

    phase("analysis")
    zero_kernel_counts()
    n = analysis_main([])
    check(n == 0, f"python -m repro_torch.analysis found {n} finding(s)")
    passes_launches = kernel_counts()["sspnna_fused"]
    case = fused_case(dev)
    with torch.inference_mode():
        got, want = kernel_vs_plain("sspnna_fused", case.fused, case.plain,
                                    "analysis: the hlo pass's fused conv")
        abs_err, rel_err = max_err(got, want)
        check(rel_err <= KERNEL_TOL, f"analysis: the fused conv is {rel_err} "
              f"from its plain version (tol {KERNEL_TOL})")
        kernels = device_kernels(case.fused)
    print(f"analysis: fused conv's device kernels {sorted(set(kernels))}")
    check(any("tile_kernel" in k for k in kernels),
          "analysis: the profiler traced no sspnna_fused kernel")
    check(not forbidden_ops(kernels) and not only_kernels(kernels,
                                                          FUSED_KERNELS),
          f"analysis: the fused conv ran a kernel it must not: {kernels}")
    t, d_o, k = tuple(case.local_idx.shape)
    launch = launch_geometry(KERNEL, t, d_o, k, C_IN, C_OUT)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    model = geometry(t * d_o, C_IN, C_OUT, k, 4, sms)
    check(all(launch[key] == v for key, v in model.items()),
          f"analysis: modeled geometry {model} != launch {launch}")
    launches = kernel_counts()["sspnna_fused"]
    print(f"analysis: 4 passes clean ({passes_launches} sspnna_fused "
          f"launches); fused conv T={t} dO={d_o}: max abs {abs_err:.3g} rel "
          f"{rel_err:.3g} (tol {KERNEL_TOL}); geometry {model} equals the "
          f"launch's ({sms} SMs); {launches} launches in the phase")
    return {"launches": launches, "max_abs_err": abs_err, "rel_err": rel_err,
            "kernels": sorted(set(kernels)), "geometry": model}


def dryrun_path(phase: Phases) -> dict:
    """Phase 27: ``DRYRUN_CELLS`` through ``launch.dryrun.run_cell`` on a
    fake world of 256 ranks, on this machine's CPU."""
    from repro_torch.launch.dryrun import run_cell

    out = {}
    for arch, shape in DRYRUN_CELLS:
        phase(f"dryrun {arch} x {shape}")
        zero_kernel_counts()
        t0 = time.perf_counter()
        r = run_cell(arch, shape, False)
        secs = time.perf_counter() - t0
        check(r["status"] == "ok", f"dryrun {arch} x {shape}: {r}")
        check(not any(kernel_counts().values()),
              f"dryrun {arch} x {shape} launched kernels: {kernel_counts()}")
        rf, mem = r["roofline"], r["memory"]
        fake = rf["coll_breakdown"]["kernels"]
        if shape.startswith("prefill"):
            check(fake.get("flash_fwd", {}).get("launches", 0) > 0,
                  f"dryrun {arch} x {shape} reached no fake flash launch")
        if "moonshot" in arch:
            check(fake.get("moe_gemm", {}).get("launches", 0) > 0,
                  f"dryrun {arch} x {shape} reached no fake expert GEMM")
        print(f"dryrun {arch} x {shape} x {rf['mesh']}: {secs:.1f} s; "
              f"compute {rf['compute_s']:.6g} s, memory {rf['memory_s']:.6g} "
              f"s, collective {rf['collective_s']:.6g} s; bound {rf['bound']}, "
              f"mfu {rf['mfu']:.4g}; peak {mem['peak_bytes_per_device'] / 1e9:.3f}"
              f" GB a rank, fits_80GB {mem['fits_80GB']}; fake launches "
              f"{ {k: v['launches'] for k, v in fake.items()} }")
        out[f"{arch} x {shape}"] = dict(
            seconds=secs, fits_80GB=mem["fits_80GB"],
            peak_bytes_per_device=mem["peak_bytes_per_device"],
            **{k: rf[k] for k in ("compute_s", "memory_s", "collective_s",
                                  "bound", "mfu", "flops_per_device",
                                  "bytes_per_device",
                                  "coll_bytes_per_device")},
            fake_launches={k: v["launches"] for k, v in fake.items()})
    return out


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    from repro_torch.kernels import build
    from repro_torch.kernels.flash import flash
    from repro_torch.kernels.moe_gemm import moe_gemm
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
    kernels = (sspnna.KERNEL, sspnna.TILES_KERNEL, flash.KERNEL,
               moe_gemm.KERNEL)
    builds = ([(name, ()) for name in kernels]
              + [(sspnna.KERNEL, d) for d in BREAKDOWN_BUILDS.values()])
    # one nvcc per build
    with ThreadPoolExecutor(len(builds), thread_name_prefix="nvcc") as pool:
        list(pool.map(lambda b: build.build(*b), builds))
    print(f"build: {', '.join(kernels)} for sm_90a, and {len(BREAKDOWN_BUILDS)} "
          f"timing builds of {sspnna.KERNEL}")
    ptxas = {int(re.search(r"ILi(\d+)E", name).group(1)): regs_spills
             for name, regs_spills in build.ptxas_report(
                 build.ptxas_log(flash.KERNEL).read_text()).items()
             if "flash_fwd_bf16" in name}
    print("flash bf16 (wgmma) kernels, ptxas -v: " + "; ".join(
        f"D={d}: {r} registers, {sp} bytes spilled"
        for d, (r, sp) in sorted(ptxas.items())))
    check(sorted(ptxas) == list(flash.HEAD_DIMS), "a bf16 flash kernel is "
          "missing from the build")
    check(all(sp == 0 for _, sp in ptxas.values()),
          "a bf16 flash kernel spills registers")
    sspnna_ptxas = {}  # every instantiation of the shared SSpNNA tile kernel
    for kernel in (sspnna.KERNEL, sspnna.TILES_KERNEL):
        for name, regs_spills in build.ptxas_report(
                build.ptxas_log(kernel).read_text()).items():
            if m := re.search(r"tile_kernelI(f|13__nv_bfloat16)Li(\d)E", name):
                dt = "f32" if m.group(1) == "f" else "bf16"
                sspnna_ptxas[f"{kernel} {dt} NT={m.group(2)}"] = regs_spills
    print("sspnna (mma.sync) kernels, ptxas -v: " + "; ".join(
        f"{k}: {r} registers, {sp} bytes spilled"
        for k, (r, sp) in sorted(sspnna_ptxas.items())))
    check(len(sspnna_ptxas) == 12, "an SSpNNA kernel instantiation is missing "
          "from the build (4 fused f32, 4 tile-stack f32, 4 bf16)")
    check(all(sp == 0 for _, sp in sspnna_ptxas.values()),
          "an SSpNNA kernel spills registers")
    moe_ptxas = {moe_gemm_label(name): regs_spills
                 for name, regs_spills in build.ptxas_report(
                     build.ptxas_log(moe_gemm.KERNEL).read_text()).items()}
    print("moe_gemm kernels, ptxas -v: " + "; ".join(
        f"{k}: {r} registers, {sp} bytes spilled"
        for k, (r, sp) in sorted(moe_ptxas.items())))
    check(len(moe_ptxas) == MOE_GEMM_INSTANCES, "an expert-GEMM kernel "
          f"instantiation is missing from the build ({len(moe_ptxas)} of "
          f"{MOE_GEMM_INSTANCES})")
    check(all(sp == 0 for _, sp in moe_ptxas.values()),
          "an expert-GEMM kernel spills registers")

    analysis = analysis_path(dev, phase)
    fused_entry, seed0 = scn_path(dev, phase)
    fused_entry["analysis"] = analysis
    fused_entry["max_abs_err"] = max(fused_entry["max_abs_err"],
                                     analysis["max_abs_err"])
    fused_entry["ptxas"] = {k: {"registers": r, "spill_bytes": sp}
                            for k, (r, sp) in sorted(sspnna_ptxas.items())}
    fused_entry["dataflow"] = scn_dataflow_path(
        dev, phase, seed0["model"], seed0["cfg"], seed0.pop("scenes"))
    fused_entry["max_abs_err"] = max(fused_entry["max_abs_err"],
                                     fused_entry["dataflow"]["max_abs_err"])
    results = [fused_entry]
    with torch.inference_mode():  # the model's parameters require grad
        tiles_entry = pregathered_path(dev, phase, seed0)
    serving, spec, scenes, served = scn_serving_path(
        dev, phase, seed0["model"], seed0["cfg"])
    print(f"sspnna_fused on the device: a wave of {len(SEEDS)} on pinned "
          f"plans {serving['wave_device_ms']:.4f} ms against {len(SEEDS)} x "
          f"seed 0's adaptive forward {len(SEEDS) * fused_entry['device_ms']:.4f}"
          f" ms")
    fused_entry["serving"] = serving
    fused_entry["autotune"] = scn_autotune_path(
        dev, phase, seed0["model"], seed0["cfg"], seed0, spec, scenes, served)
    fused_entry["breakers"] = scn_breaker_path(
        dev, phase, seed0["model"], seed0["cfg"], spec, scenes)
    del spec, scenes, served
    fused_entry["streaming"] = scn_stream_path(dev, phase, seed0["model"],
                                               seed0["cfg"])
    fused_entry["sharded"] = scn_sharded_path(dev, phase, seed0, card)
    fused_entry["training"] = scn_training_path(dev, phase, card, seed0)
    del seed0
    torch.cuda.empty_cache()
    results.append(lm_path(dev, phase))
    results[1]["bf16_ptxas"] = {
        f"D={d}": {"registers": r, "spill_bytes": sp}
        for d, (r, sp) in sorted(ptxas.items())}
    # the Gemma engine's stage callbacks hold it (and its weights) in a
    # cycle: collect it before Moonshot's 55 GB of weights need the room
    gc.collect()
    torch.cuda.empty_cache()
    held = torch.cuda.memory_allocated() / 2**30
    print(f"after the LM path: {held:.2f} GiB still allocated")
    check(held < 1.0, "the LM path's tensors were not freed")
    moe_entry, flash_moe = moe_path(dev, phase)
    moe_entry["ptxas"] = {k: {"registers": r, "spill_bytes": sp}
                          for k, (r, sp) in sorted(moe_ptxas.items())}
    results[1].update(flash_moe)
    results.append(moe_entry)
    results.append(tiles_entry)
    # the Moonshot engine's weights, as Gemma's above
    gc.collect()
    torch.cuda.empty_cache()
    held = torch.cuda.memory_allocated() / 2**30
    print(f"after the MoE path: {held:.2f} GiB still allocated")
    check(held < 1.0, "the MoE path's tensors were not freed")
    # slice 10: each config serves alone, its weights freed after it
    lm10 = {}
    for arch in LM10_ARCHS:
        lm10[arch] = lm_config_path(dev, phase, arch, card)
        # the engine's stage callbacks hold it (and the weights) in a cycle
        gc.collect()
        torch.cuda.empty_cache()
        held = torch.cuda.memory_allocated() / 2**30
        print(f"after the {arch} path: {held:.2f} GiB still allocated")
        check(held < 1.0, f"the {arch} path's tensors were not freed")
    results[1]["lm_configs"] = {
        arch: dict(r["flash"], launches=r["launches"]["flash_fwd"],
                   prefill_ms=r["prefill_ms"], decode=r["decode"])
        for arch, r in lm10.items() if "flash" in r}
    # slice 10 part c: Pixtral-12B and SeamlessM4T-medium, each alone
    part_c = {}
    for arch in (VLM_ARCH, ENCDEC_ARCH):
        part_c[arch] = part_c_path(dev, phase, arch, card)
        gc.collect()
        torch.cuda.empty_cache()
        held = torch.cuda.memory_allocated() / 2**30
        print(f"after the {arch} path: {held:.2f} GiB still allocated")
        check(held < 1.0, f"the {arch} path's tensors were not freed")
    results[1]["part_c"] = part_c
    moe_entry["maverick"] = dict(
        lm10[LM10_MOE]["moe_gemm"],
        launches=lm10[LM10_MOE]["launches"]["moe_gemm"])
    recurrent = {arch: {k: lm10[arch][k] for k in (
        "launches", "prefill_ms", "prefill_busy_ms", "decode", "peak_gib")}
        for arch in ("recurrentgemma-9b", "rwkv6-7b")}
    training = lm_training_path(dev, phase, card)
    gc.collect()
    torch.cuda.empty_cache()
    moe_dist = dist_path(dev, phase, card)
    moe_entry["dist"] = moe_dist
    moe_entry["launches"] += sum(moe_dist["launches"])
    moe_entry["max_abs_err"] = max(
        [moe_entry["max_abs_err"]]
        + [e[1] for r in moe_dist["ranks"] for e in r["errs"]])
    results[1]["training"] = {
        "launches": training["prefill_launches"],
        "train_step_launches": training["step_launches"]["flash_fwd"]}
    moe_entry["training"] = {
        "train_step_launches": training["step_launches"]["moe_gemm"]}
    results[1]["lm_training"] = training
    recurrent["training"] = recurrent_training_path(dev, phase, card)
    results[1]["recurrent"] = recurrent
    part_c["training"] = part_c_training_path(dev, phase, card)
    results[1]["dryrun"] = dryrun_path(phase)
    phase.end()

    print(f"card: {card}")
    print(json.dumps({"kernels": results}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
