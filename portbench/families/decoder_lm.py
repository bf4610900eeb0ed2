"""The dense decoder LM family: chat served in waves through the program's
``serving.engine.Engine`` (prefill, then greedy decode as CUDA-graph
replays), checked against ``reference/decoder_lm.py``.

The configuration file gives the published sizes; the program's config is
its registered ``port_arch`` with those sizes and the published RoPE base
and norm epsilon put in. Set-up makes the weights on the device from the
seed and serves one wave, which captures the decode-step graphs.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from portbench.families import weights as W
from portbench.frozen import work as fw
from portbench.frozen.tokens import token_rows
from portbench.frozen.traffic import seed_sequence
from portbench.reference import decoder_lm as ref

#: the widest gap, in logits, by which a served token's reference logit may
#: lie below the reference's best; set from the readings in PERF.md
GAP_LIMIT = 0.25


def shape(config: dict) -> dict:
    return dict(layers=config["num_hidden_layers"], d=config["hidden_size"],
                heads=config["num_attention_heads"],
                kv_heads=config["num_key_value_heads"],
                head_dim=config["head_dim"], d_ff=config["intermediate_size"],
                vocab=config["vocab_size"], rope_theta=config["rope_theta"],
                norm_eps=config["rms_norm_eps"])


def make_weights(config: dict, seed: int, device) -> dict:
    """The model's weights in the program's layout, in the served dtype:
    one draw per kind of matrix over all layers (N(0, 1/fan_in)), the tied
    embedding N(0, (1.28/sqrt(d))^2) (0.02 at d = 4096, so logits spread
    alike at any width), norm weights N(1, 0.01). Layer i holds views into
    the stacked draws."""
    s = shape(config)
    dt = getattr(torch, config["torch_dtype"])
    g = W.generator(seed, 20, device)
    L, d, hd, f = s["layers"], s["d"], s["head_dim"], s["d_ff"]
    kinds = {"wq": (d, s["heads"] * hd), "wk": (d, s["kv_heads"] * hd),
             "wv": (d, s["kv_heads"] * hd), "wo": (s["heads"] * hd, d),
             "w_gate": (d, f), "w_up": (d, f), "w_down": (f, d)}
    stacks = {k: W.normal(g, (L, *sh), W.fan_in_std(sh), dt, device)
              for k, sh in kinds.items()}
    norms = W.normal(g, (2 * L + 1, d), 0.1, dt, device, mean=1.0)
    vocab_rows = -(-s["vocab"] // 256) * 256
    out = {"embed": W.normal(g, (vocab_rows, d), 1.28 / d ** 0.5, dt, device),
           "final_norm": norms[2 * L]}
    out["layers"] = [
        {"ln1": norms[2 * i], "ln2": norms[2 * i + 1],
         "attn": {k: stacks[k][i] for k in ("wq", "wk", "wv", "wo")},
         "mlp": {k: stacks[k][i] for k in ("w_gate", "w_up", "w_down")}}
        for i in range(L)]
    return out


def port_config(config: dict):
    from repro_torch.configs import get_config

    s = shape(config)
    return dataclasses.replace(
        get_config(config["port_arch"]), n_layers=s["layers"], d_model=s["d"],
        n_heads=s["heads"], n_kv_heads=s["kv_heads"], head_dim=s["head_dim"],
        d_ff=s["d_ff"], vocab_size=s["vocab"], rope_theta=s["rope_theta"],
        norm_eps=s["norm_eps"], dtype=config["torch_dtype"],
        tie_embeddings=config["tie_word_embeddings"])


def prompt_pool(config: dict, mix: dict, seed: int) -> np.ndarray:
    return token_rows(config["vocab_size"], mix["pool"]["rows"],
                      mix["engine"]["prompt_len"], seed_sequence(seed, 2))


class System:
    """The program under test: an ``Engine`` with the benchmark's weights."""

    def __init__(self, config: dict, mix: dict, seed: int, device):
        from repro_torch.serving.engine import Engine

        eng = mix["engine"]
        self.cfg = port_config(config)
        self.rows = prompt_pool(config, mix, seed)
        self.engine = Engine(self.cfg, make_weights(config, seed, device),
                             eng["batch"], eng["prompt_len"], eng["max_new"],
                             eos=None, device=device)
        # warm-up: one wave at the cell's shape (the prefill, and the
        # decode-step graphs captured and replayed)
        handles = [self.submit({"row": i, "length": eng["prompt_len"]},
                               rid=-1 - i) for i in range(eng["batch"])]
        self.engine.serve()
        for h in handles:
            h.result()
        self.warm_waves = len(self.engine.wave_stats)

    def submit(self, fields: dict, rid: int | None = None):
        from repro_torch.serving.engine import Request

        rid = fields["index"] if rid is None else rid
        prompt = self.rows[fields["row"], : fields["length"]]
        return self.engine.submit(Request(rid, prompt=prompt,
                                          max_new=self.engine.max_new))

    def serve_wave(self) -> None:
        self.engine.serve(max_waves=1)

    @staticmethod
    def answer(handle):
        return list(handle.request.out)

    @staticmethod
    def units(handle) -> dict:
        r = handle.request
        return {"tokens": len(r.out), "prompt_tokens": len(r.prompt)}

    def wave_stats(self) -> list:
        return self.engine.wave_stats

    def counters(self) -> dict:
        from repro_torch.kernels.flash.flash import flash_attention

        g = self.engine.graphs
        return {"graph_replays": 0 if g is None else g.replays,
                "flash_launches": flash_attention.launches}

    def facts(self) -> dict:
        return {"graphs": 0 if self.engine.graphs is None
                else len(self.engine.graphs)}

    def close(self) -> None:
        self.engine.close()
        self.engine = None


def setup(config, mix, seed, device) -> System:
    return System(config, mix, seed, device)


def _sample(kept: list, n: int, seed: int) -> list:
    """``n`` served requests drawn from the seed, the one with the longest
    prompt among them."""
    if len(kept) <= n:
        return list(kept)
    rng = np.random.default_rng(seed_sequence(seed, 3))
    longest = max(range(len(kept)), key=lambda i: kept[i][0]["length"])
    rest = [i for i in range(len(kept)) if i != longest]
    pick = [longest] + list(rng.choice(rest, size=n - 1, replace=False))
    return [kept[i] for i in sorted(pick)]


def served_rows(config, mix, seed, sample) -> torch.Tensor:
    """Each sampled request's engine row (its prompt left-padded with 0 to
    the slot) followed by all but its last served token."""
    rows = prompt_pool(config, mix, seed)
    p = mix["engine"]["prompt_len"]
    out = []
    for fields, tokens in sample:
        row = np.zeros(p + len(tokens) - 1, np.int64)
        prompt = rows[fields["row"], : fields["length"]]
        row[p - len(prompt): p] = prompt
        row[p:] = tokens[:-1]
        out.append(row)
    return torch.from_numpy(np.stack(out))


def token_gaps(weights, config, mix, seed, sample, device,
               precision="f32") -> torch.Tensor:
    """(n, max_new) gaps: the f32 reference's best logit less its logit of
    the served token at each served position; with ``precision`` other
    than f32, of the token that precision's logits put first instead."""
    s = shape(config)
    p = mix["engine"]["prompt_len"]
    toks = served_rows(config, mix, seed, sample).to(device)
    at = slice(p - 1, toks.shape[1])
    want = ref.logits_at(weights, s, toks, at)
    if precision != "f32":
        chosen = ref.logits_at(weights, s, toks, at, precision).argmax(-1)
    else:
        chosen = torch.tensor([t for _, t in sample], device=device)
    got = want.gather(-1, chosen.long()[..., None])[..., 0]
    return want.max(-1).values - got


def after_window(config, mix, seed, device, kept, facts, traced) -> tuple:
    """The sampled requests' served tokens against the reference, and the
    traced waves' work (flash launches of each prefill, model FLOPs of the
    real prompt and generated tokens)."""
    sample = _sample(kept, mix["check"]["sample"], seed)
    weights = make_weights(config, seed, device)
    gaps = token_gaps(weights, config, mix, seed, sample, device)
    worst = float(gaps.max())
    checks = {"token_logit_gap": {"value": worst if np.isfinite(worst)
                                  else float("inf"), "limit": GAP_LIMIT}}
    return checks, _work(config, mix, traced)


def _work(config, mix, traced) -> dict:
    s = shape(config)
    eng = mix["engine"]
    per_prefill = fw.flash_work(eng["batch"], eng["prompt_len"],
                                eng["prompt_len"], s["heads"], s["kv_heads"],
                                s["head_dim"], causal=True)
    flash = None
    for _ in traced:
        for _ in range(s["layers"]):
            flash = per_prefill if flash is None else flash + per_prefill
    params = fw.decoder_matmul_params(s["layers"], s["d"], s["heads"],
                                      s["kv_heads"], s["head_dim"], s["d_ff"],
                                      s["vocab"])
    model_flops = sum(
        fw.decoder_request_flops(params, s["layers"], s["heads"],
                                 s["head_dim"], f["length"], eng["max_new"])
        for wave in traced for f in wave)
    return {"flash": flash, "flash_per_wave": s["layers"],
            "model_flops": model_flops}


def control(config, mix, seed, device, kept) -> dict:
    """The control: the reference with its products in fp8 (e4m3, scales a
    token and a channel) put in the program's place, on the same sampled
    prompts and served tokens: the f32 reference's gap to the token that
    fp8 puts first."""
    sample = _sample(kept, mix["check"]["sample"], seed)
    weights = make_weights(config, seed, device)
    gaps = token_gaps(weights, config, mix, seed, sample, device, "fp8")
    return {"token_logit_gap": float(gaps.max())}
