"""LM serving engine: prefill + batched greedy decode in waves (port of
``repro.serving.engine``).

``make_prefill``/``make_serve_step`` are the pure steps; ``Engine`` is the
host-side driver, built on the port's ``serving.scheduler.WaveScheduler``:

* **plan** — left-pad each prompt with token 0 into its fixed-length slot
  row (host numpy, planner threads); the pads are attended, not masked, as
  in the JAX package;
* **dispatch** — prefill (attention through the flash kernel) and
  ``max_new`` greedy decode steps, all enqueued on the current CUDA stream
  without host syncs (the emitted tokens stay on the device);
* **drain** — one readback of the wave's token block, then per-request EOS
  truncation on the host.

``sync=False`` pipelines the stages (wave *k+1* packs while wave *k*
decodes); the tokens are identical in both modes because EOS handling
happens at drain time.

On the card the decode steps run as CUDA graphs, the counterpart of the JAX
package's jitted step: one graph per step index, captured once per engine
on its first wave (``serving.graphs``) and replayed by every wave after.
The cache position is a Python int, so each graph bakes in its own; prompt
length, batch and ``max_new`` are fixed per engine, so the graphs hold for
every wave. The graphs read and write buffers the engine owns: a static
cache (each wave's prefill cache is copied into it), a ``(B, 1)`` token
input that each graph reads and overwrites with its token, and the
``(B, max_new)`` token block. A decode step advances the cache buffers in
place, recurrent states too, so each wave's replays start from its own
prefill's state. On the CPU every step runs eagerly.

Each wave's ``WaveStats`` carries the engine's spans inside the
scheduler's (``serving.scheduler``): in ``serve.dispatch``, ``lm.prefill``
(the prompts to the device and the prefill enqueued) and ``lm.decode``
(the first token's argmax and the decode steps); in ``serve.drain``,
``lm.wait`` (the host waits on an event recorded after the token block's
copy), ``lm.readback`` (the block's copy to the host alone) and
``lm.finish`` (EOS truncation), and counts the token block's
``readback_bytes``. On the card, CUDA events at the prefill's start, at
its first token (after the argmax) and after the last decode step give
``event_ms["prefill"]`` and ``event_ms["decode"]``; the first token was
ready on the host's clock ``event_ms["decode"]`` before the end of
``lm.wait``, and each request's ``first_token_ms`` runs from its
``submit_ts`` to then.
"""
from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np
import torch
from torch.distributed.tensor import DTensor, Replicate, Shard

from repro_torch.configs.base import ModelConfig
from repro_torch.device import require_device
from repro_torch.models.transformer import decode_step, forward
from repro_torch.serving.api import AdmissionPolicy, ServeRequest, ServingBase
from repro_torch.serving.graphs import Graphs, timing_event
from repro_torch.serving.scheduler import WaveScheduler


def make_prefill(cfg: ModelConfig, cache_pad: int = 0):
    def prefill(params, tokens, frontend_embeds=None, enc_frames=None):
        """tokens (B, S) -> (last-position logits (B, Vp) f32, cache). A
        vision config takes ``frontend_embeds`` (B, P, d); an
        encoder-decoder config needs ``enc_frames`` (B, S_src, d), and its
        cache then holds each layer's cross keys and values."""
        kw = {}
        if cfg.frontend == "vision" and frontend_embeds is not None:
            kw["frontend_embeds"] = frontend_embeds
        if cfg.is_encdec:
            kw["enc_frames"] = enc_frames
        logits, cache, _ = forward(params, cfg, tokens, mode="prefill",
                                   cache_pad=cache_pad, last_only=True, **kw)
        return logits[:, -1], cache

    return prefill


def _whole_vocab(last):
    """Last-position logits (B, V) with the vocab whole on every rank: a
    ``DTensor`` (the dry run's) has no rule for an argmax over a sharded
    dim, so its vocab shards are gathered first."""
    if not isinstance(last, DTensor):
        return last
    return last.redistribute(last.device_mesh, [
        Replicate() if isinstance(p, Shard) and p.dim == 1 else p
        for p in last.placements])


def make_serve_step(cfg: ModelConfig, moe_groups: int | None = None):
    def serve_step(params, token, cache):
        logits, cache = decode_step(params, cfg, token, cache,
                                    moe_groups=moe_groups)
        next_tok = torch.argmax(_whole_vocab(logits[:, -1, : cfg.vocab_size]),
                                dim=-1)
        return next_tok.to(torch.int32), logits[:, -1], cache

    return serve_step


@dataclass
class Request(ServeRequest):
    """One prompt to serve; SLO fields (tenant/priority/deadline_ms) come
    from :class:`~repro_torch.serving.api.ServeRequest` as keyword-only
    args."""

    prompt: np.ndarray = None
    max_new: int = 16
    out: list = field(default_factory=list)
    done: bool = False


class Engine(ServingBase):
    """Host-side continuous-batching driver (fixed shapes) on one device.

    ``params`` come from ``models.transformer.init_lm`` or
    ``params_from_jax`` and must lie on ``device``. On a CUDA device
    ``graphs`` holds the decode-step graphs (empty until the first wave);
    a wave's ``WaveStats.notes["graph_launches"]`` counts the kernel
    launches its replays ran, which no wrapper's counter sees.
    """

    def __init__(self, cfg: ModelConfig, params, batch: int, prompt_len: int,
                 max_new: int, eos: int | None = None, *,
                 sync: bool = True, depth: int = 2,
                 planner_threads: int = 2,
                 policy: AdmissionPolicy | None = None,
                 faults=None, device: str | torch.device = "cuda"):
        self.device = require_device(device)
        if params["embed"].device.type != self.device.type:
            raise ValueError(f"params lie on {params['embed'].device}, the "
                             f"engine serves on {self.device}")
        self.cfg, self.params = cfg, params
        self.batch, self.prompt_len, self.max_new = batch, prompt_len, max_new
        self.eos = eos
        self.prefill = make_prefill(cfg, cache_pad=max_new)
        self.step = make_serve_step(cfg)
        self.graphs = Graphs(self.device) if self.device.type == "cuda" else None
        # the graphs' buffers: cache, token input, token block (first wave)
        self._cache = self._tok = self._out = None
        self.scheduler = WaveScheduler(
            batch=batch, plan=self._plan_stage, dispatch=self._dispatch_stage,
            drain=self._drain, sync=sync, depth=depth,
            planner_threads=planner_threads, policy=policy, faults=faults)

    # -- pipeline stages -----------------------------------------------------

    def _plan_stage(self, req: Request) -> np.ndarray:
        """Pack one prompt into its fixed-length slot row (host work)."""
        row = np.zeros((self.prompt_len,), np.int32)
        prompt = np.asarray(req.prompt)[: self.prompt_len]
        if len(prompt):
            row[-len(prompt):] = prompt
        return row

    @torch.inference_mode()
    def _dispatch_stage(self, reqs: list[Request], rows,
                        stats) -> torch.Tensor:
        """The wave's prefill and decode, enqueued -> its token block on
        the device."""
        if self.max_new < 1:
            return torch.zeros((self.batch, 0), dtype=torch.int32,
                               device=self.device)
        with stats.span("lm.prefill"):
            toks = np.zeros((self.batch, self.prompt_len), np.int32)
            for i, row in enumerate(rows):
                toks[i] = row
            toks = torch.from_numpy(toks).to(self.device)
            stats.pending["prefill"] = timing_event(self.device)
            last_logits, cache = self.prefill(self.params, toks)
        with stats.span("lm.decode"):
            # early EOS exit needs a host sync per step, which would stall
            # the async pipeline — only the blocking mode pays for it
            check_eos = self.eos is not None and self.scheduler.running_sync
            out = self.decode(last_logits, cache,
                              stop_rows=len(reqs) if check_eos else 0,
                              notes=stats.notes, stats=stats)
        return out

    @torch.inference_mode()
    def decode(self, last_logits, cache, *, stop_rows: int = 0,
               notes: dict | None = None, stats=None) -> torch.Tensor:
        """Greedy tokens ``(batch, <= max_new)`` on the device after a
        prefill's ``(last_logits, cache)``: the prefill's token, then
        ``max_new - 1`` decode steps, as graph replays on the card and eager
        steps on the CPU. With ``stop_rows`` the steps stop early once each
        of the first ``stop_rows`` rows has emitted ``eos`` (a host read per
        step). On the card ``notes["graph_launches"]`` receives the kernel
        launches the replays ran, and with ``stats`` (the wave's
        ``WaveStats``) the first token's and the last step's events go to
        ``stats.pending``."""
        tok = torch.argmax(last_logits[:, : self.cfg.vocab_size], -1)
        tok = tok.to(torch.int32)[:, None]
        if stats is not None:
            stats.pending["first_token"] = timing_event(self.device)
        if self.graphs is not None:
            return self._decode_graphs(tok, cache, stop_rows,
                                       {} if notes is None else notes, stats)
        done = [False] * stop_rows
        emitted = [tok]
        for _ in range(self.max_new - 1):
            if stop_rows:
                for i in range(stop_rows):
                    done[i] = done[i] or int(tok[i, 0]) == self.eos
                if all(done):
                    break
            nxt, _, cache = self.step(self.params, tok, cache)
            tok = nxt[:, None]
            emitted.append(tok)
        return torch.cat(emitted, dim=1)  # (batch, <=max_new), on the device

    def _step_graph(self, i: int) -> None:
        """Decode step ``i`` on the engine's buffers: read the token input,
        write the next token into it and into column ``i + 1`` of the token
        block (what graph ``i`` records)."""
        cache = {"layers": self._cache["layers"],
                 "pos": self.prompt_len + i}
        nxt, _, _ = self.step(self.params, self._tok, cache)
        self._out[:, i + 1].copy_(nxt)
        self._tok.copy_(nxt[:, None])

    def _decode_graphs(self, tok, cache, stop_rows: int, notes: dict,
                       stats=None) -> torch.Tensor:
        """The decode steps as graph replays (captured on the first wave,
        after one eager warm-up step)."""
        first = self._cache is None
        if first:
            self._cache = {"layers": [{k: torch.empty_like(v)
                                       for k, v in layer.items()}
                                      for layer in cache["layers"]],
                           "pos": cache["pos"]}
            self._tok = torch.empty_like(tok)
            self._out = torch.empty((self.batch, self.max_new),
                                    dtype=torch.int32, device=self.device)
        def load():
            """The prefill's cache and token into the graphs' buffers."""
            for mine, theirs in zip(self._cache["layers"], cache["layers"],
                                    strict=True):
                for k, v in theirs.items():
                    mine[k].copy_(v)
            self._tok.copy_(tok)
            self._out[:, :1].copy_(tok)

        load()
        if first and self.max_new > 1:
            # the warm-up step advances the buffers (it writes step 0's KV
            # slot and moves a recurrent state); a capture runs nothing, so
            # one more load puts them back where the replays start
            self._step_graph(0)
            for i in range(self.max_new - 1):
                self.graphs.capture(i, lambda i=i: self._step_graph(i))
            load()
        del cache
        replayed = self.graphs.replayed.copy()
        done = [False] * stop_rows
        n = 1
        for i in range(self.max_new - 1):
            if stop_rows:
                last = self._tok[:stop_rows, 0].tolist()
                done = [d or t == self.eos for d, t in zip(done, last)]
                if all(done):
                    break
            self.graphs.replay(i)
            n += 1
        last = timing_event(self.device)
        notes["graph_launches"] = dict(self.graphs.replayed - replayed)
        # a copy: the next wave's replays overwrite the block
        out = self._out[:, :n].clone()
        if stats is not None:
            stats.pending.update(last=last, done=timing_event(self.device))
        return out

    def _drain(self, reqs: list[Request], emitted, stats) -> None:
        """The scheduler's drain: wait for the wave, copy its token block
        to the host, finish its requests (``_drain_stage``)."""
        with stats.span("lm.wait") as wait:
            done = stats.pending.get("done")
            if done is not None:
                done.synchronize()
        with stats.span("lm.readback"):
            emitted = emitted.cpu().numpy()
            stats.readback_bytes += emitted.nbytes
        with stats.span("lm.finish"):
            self._drain_stage(reqs, emitted)
            self._read_events(reqs, stats, wait.end_ms)

    def _drain_stage(self, reqs: list[Request], emitted) -> None:
        """Each request's tokens from the wave's block on the host, cut
        after its EOS."""
        for i, r in enumerate(reqs):
            for t in emitted[i]:
                r.out.append(int(t))
                if self.eos is not None and int(t) == self.eos:
                    break
            r.done = True

    @staticmethod
    def _read_events(reqs: list[Request], stats, waited_ms: float) -> None:
        """The wave's device ms from its events (``event_ms``) and each
        request's time to its first token (``first_token_ms``): the token
        was ready the decode's device time before the host saw the last
        event done (``waited_ms``)."""
        p = stats.pending
        if p.get("last") is None:
            return
        stats.event_ms["prefill"] = p["prefill"].elapsed_time(
            p["first_token"])
        stats.event_ms["decode"] = p["first_token"].elapsed_time(p["last"])
        ready = waited_ms - stats.event_ms["decode"]
        stats.first_token_ms = tuple(ready - r.submit_ts for r in reqs)
