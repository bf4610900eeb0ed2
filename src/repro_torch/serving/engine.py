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
happens at drain time. Nothing is compiled: each step runs eagerly.
"""
from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.device import require_device
from repro_torch.models.transformer import check_supported, decode_step, forward
from repro_torch.serving.api import AdmissionPolicy, ServeRequest, ServingBase
from repro_torch.serving.scheduler import WaveScheduler


def make_prefill(cfg: ModelConfig, cache_pad: int = 0):
    def prefill(params, tokens):
        """tokens (B, S) -> (last-position logits (B, Vp) f32, cache)."""
        logits, cache, _ = forward(params, cfg, tokens, mode="prefill",
                                   cache_pad=cache_pad, last_only=True)
        return logits[:, -1], cache

    return prefill


def make_serve_step(cfg: ModelConfig, moe_groups: int | None = None):
    def serve_step(params, token, cache):
        logits, cache = decode_step(params, cfg, token, cache,
                                    moe_groups=moe_groups)
        next_tok = torch.argmax(logits[:, -1, : cfg.vocab_size], dim=-1)
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
    ``params_from_jax`` and must lie on ``device``.
    """

    def __init__(self, cfg: ModelConfig, params, batch: int, prompt_len: int,
                 max_new: int, eos: int | None = None, *,
                 sync: bool = True, depth: int = 2,
                 planner_threads: int = 2,
                 policy: AdmissionPolicy | None = None,
                 faults=None, device: str | torch.device = "cuda"):
        check_supported(cfg)
        self.device = require_device(device)
        if params["embed"].device.type != self.device.type:
            raise ValueError(f"params lie on {params['embed'].device}, the "
                             f"engine serves on {self.device}")
        self.cfg, self.params = cfg, params
        self.batch, self.prompt_len, self.max_new = batch, prompt_len, max_new
        self.eos = eos
        self.prefill = make_prefill(cfg, cache_pad=max_new)
        self.step = make_serve_step(cfg)
        self.scheduler = WaveScheduler(
            batch=batch, plan=self._plan_stage, dispatch=self._dispatch_stage,
            drain=self._drain_stage, sync=sync, depth=depth,
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
        del stats  # the LM engine records nothing beyond the shared timings
        if self.max_new < 1:
            return torch.zeros((self.batch, 0), dtype=torch.int32,
                               device=self.device)
        toks = np.zeros((self.batch, self.prompt_len), np.int32)
        for i, row in enumerate(rows):
            toks[i] = row
        last_logits, cache = self.prefill(
            self.params, torch.from_numpy(toks).to(self.device))
        tok = torch.argmax(last_logits[:, : self.cfg.vocab_size], -1)
        tok = tok.to(torch.int32)[:, None]
        # early EOS exit needs a host sync per step, which would stall the
        # async pipeline — only the blocking mode pays for it
        check_eos = self.eos is not None and self.scheduler.running_sync
        done = [False] * len(reqs)
        emitted = [tok]
        for _ in range(self.max_new - 1):
            if check_eos:
                for i in range(len(reqs)):
                    done[i] = done[i] or int(tok[i, 0]) == self.eos
                if all(done):
                    break
            nxt, _, cache = self.step(self.params, tok, cache)
            tok = nxt[:, None]
            emitted.append(tok)
        return torch.cat(emitted, dim=1)  # (batch, <=max_new), on the device

    def _drain_stage(self, reqs: list[Request], emitted) -> None:
        emitted = emitted.cpu().numpy()
        for i, r in enumerate(reqs):
            for t in emitted[i]:
                r.out.append(int(t))
                if self.eos is not None and int(t) == self.eos:
                    break
            r.done = True
