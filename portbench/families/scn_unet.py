"""The SCN U-Net family: rooms served in waves through the program's
``serving.scene_engine.SceneEngine`` on a plan spec pinned from the room
pool, checked against ``reference/scn_unet.py``.

Set-up makes the weights on the device from the seed, builds the room pool
(``frozen/scenes.make_scene`` at the mix's fixed room seeds), pins the spec
and serves every room once, so every request of the window hits the plan
cache and replays the bucket's CUDA graph.
"""
from __future__ import annotations

import numpy as np
import torch

from portbench.families import weights as W
from portbench.frozen import work as fw
from portbench.frozen.scenes import make_scene
from portbench.reference import scn_unet as ref

#: a conv's logits may differ from the reference by this share of the
#: largest reference logit (at least 1); set from the readings in PERF.md
LOGITS_TOL = 1e-4


def unet_shape(config: dict) -> dict:
    widths = tuple(config["m"] * (i + 1) for i in range(config["num_levels"]))
    return dict(widths=widths, reps=config["block_reps"],
                in_channels=config["in_channels"],
                n_classes=config["n_classes"])


def make_weights(config: dict, seed: int, device) -> dict:
    """Every weight of the network, named as the program's module names
    them: conv weights N(0, 1/fan_in), biases and BatchNorm offsets
    N(0, 0.01), BatchNorm scales N(1, 0.01), the head N(0, 1/C)."""
    g = W.generator(seed, 10, device)
    out = {}
    for name, shape in ref.weight_shapes(**unet_shape(config)).items():
        if name.endswith(".weight") or name == "head.w":
            std, mean = W.fan_in_std(shape), 0.0
        elif name.endswith("bn_scale"):
            std, mean = 0.1, 1.0
        else:
            std, mean = 0.1, 0.0
        out[name] = W.normal(g, shape, std, torch.float32, device, mean)
    return out


def room_pool(config: dict, mix: dict) -> list[tuple]:
    """(coords, feats, labels, mask) of each room of the pool, with the
    first ``in_channels`` of the generator's features (its normals, where
    the configuration takes 3 channels a voxel as the published net takes
    a colour)."""
    pool, c = mix["pool"], config["in_channels"]
    out = []
    for s in pool["room_seeds"]:
        coords, feats, labels, mask = make_scene(
            s, config["spatial_size"], config["capacity"],
            points_per_unit=pool["points_per_unit"],
            n_objects=pool["n_objects"])
        if not 1 <= c <= feats.shape[1]:
            raise ValueError(f"in_channels {c}: the rooms carry "
                             f"{feats.shape[1]} features a voxel")
        out.append((coords, np.ascontiguousarray(feats[:, :c]), labels, mask))
    return out


class System:
    """The program under test: a ``SceneEngine`` over the pool."""

    def __init__(self, config: dict, mix: dict, seed: int, device):
        from repro_torch import engine
        from repro_torch.models.scn import SCNUNet, UNetConfig
        from repro_torch.serving.scene_engine import SceneEngine
        from repro_torch.sparse.tensor import SparseVoxelTensor

        self.device = device
        self.cfg = UNetConfig(resolution=config["spatial_size"],
                              capacity=config["capacity"],
                              **unet_shape(config))
        weights = make_weights(config, seed, device)
        model = SCNUNet(self.cfg, device=device)
        names = dict(model.named_parameters())
        if set(names) != set(weights):
            raise RuntimeError(f"the program's SCN parameters "
                               f"{sorted(set(names) ^ set(weights))} differ "
                               "from the benchmark's")
        with torch.no_grad():
            for name, p in names.items():
                p.copy_(weights[name])
        del weights
        self.scenes = [SparseVoxelTensor(c, f, m)
                       for c, f, _, m in room_pool(config, mix)]
        self.spec = engine.build_plan_spec(self.scenes, self.cfg)
        self.batch = mix["engine"]["batch"]
        self.engine = SceneEngine(self.cfg, model, self.batch, spec=self.spec,
                                  ctx=engine.ExecutionContext(device=device))
        # warm-up: every room planned once (so the window only hits the
        # plan cache), the bucket's graph captured and replayed
        n = -(-max(len(self.scenes), 2 * self.batch) // self.batch) * self.batch
        handles = [self.submit({"room": i % len(self.scenes)}, rid=-1 - i)
                   for i in range(n)]
        self.engine.serve()
        for h in handles:
            h.result()
        self.warm_waves = len(self.engine.wave_stats)
        cache = self.engine.cache
        self._plans_at_warm = (cache.hits, cache.misses)

    def submit(self, fields: dict, rid: int | None = None):
        from repro_torch.serving.scene_engine import SceneRequest

        rid = fields["index"] if rid is None else rid
        return self.engine.submit(SceneRequest(rid, self.scenes[fields["room"]]))

    def serve_wave(self) -> None:
        self.engine.serve(max_waves=1)

    def answer(self, handle):
        return handle.request.logits

    @staticmethod
    def units(handle) -> dict:
        return {"scenes": 1}

    def wave_stats(self) -> list:
        return self.engine.wave_stats

    def counters(self) -> dict:
        """The program's own counts the metrics read (read before and after
        the traced window): CUDA-graph replays."""
        g = self.engine.graphs
        return {"graph_replays": 0 if g is None else g.replays}

    def facts(self) -> dict:
        """What the program decided that the work counts need: the levels
        whose submanifold convs it sends to ``sspnna_fused``, and the
        launches of the kernel one replay of the bucket's graph runs (the
        graphs' own count; none on the CPU)."""
        g = self.engine.graphs
        keys = [] if g is None else g.keys()
        cache = self.engine.cache
        hits = cache.hits - self._plans_at_warm[0]
        misses = cache.misses - self._plans_at_warm[1]
        return {"plan_cache_hit_share": hits / max(hits + misses, 1),
                "sspnna_levels": [li for li, d in enumerate(self.spec.levels)
                                  if d.backend == "sspnna"],
                "batch": self.batch,
                "sspnna_launches_per_wave": (
                    g.launches(keys[0])["sspnna_fused"] if len(keys) == 1
                    else None)}

    def close(self) -> None:
        self.engine.close()
        self.engine = None


def setup(config, mix, seed, device) -> System:
    return System(config, mix, seed, device)


def _conv_list(config: dict) -> list[tuple]:
    """(level, kind, C, N) of every conv of one forward."""
    s = unet_shape(config)
    w, reps, n_lv = s["widths"], s["reps"], len(s["widths"])
    convs = [(0, "sub", s["in_channels"], w[0])]
    for li in range(n_lv):
        convs += [(li, "sub", w[li], w[li])] * reps
        if li < n_lv - 1:
            convs += [(li, "down", w[li], w[li + 1]),
                      (li, "up", w[li + 1], w[li])]
            convs += [(li, "sub", 2 * w[li], w[li])]
            convs += [(li, "sub", w[li], w[li])] * (reps - 1)
    return convs


def after_window(config, mix, seed, device, kept, facts, traced) -> tuple:
    """Checks every answer of the window against the reference, and counts
    the traced waves' work from the reference's rulebooks.

    ``kept`` is [(fields, logits)] of every served request, ``traced`` the
    request fields of each traced wave. Returns ``(checks, work)``."""
    s = unet_shape(config)
    n_lv = len(s["widths"])
    weights = make_weights(config, seed, device)
    pool = room_pool(config, mix)
    ref_logits, books = [], []
    for coords, feats, _, mask in pool:
        rb = ref.Rulebooks(torch.from_numpy(coords[mask]).to(device),
                           config["spatial_size"], n_lv)
        books.append(rb.pairs())
        ref_logits.append(ref.forward(
            weights, rb, torch.from_numpy(feats[mask]).to(device), n_lv,
            s["reps"]).cpu().numpy())
        del rb
    worst = 0.0
    for fields, logits in kept:
        i = fields["room"]
        worst = max(worst, rel_err(logits[pool[i][3]], ref_logits[i]))
    checks = {"logits_rel_err": {"value": worst, "limit": LOGITS_TOL}}
    return checks, _work(config, books, facts, traced)


def rel_err(got: np.ndarray, want: np.ndarray) -> float:
    """Largest difference over the largest reference logit (at least 1)."""
    err = float(np.abs(got - want).max()) / max(float(np.abs(want).max()), 1.0)
    return err if np.isfinite(err) else float("inf")


def control(config, mix, seed, device, kept) -> dict:
    """The control: the reference with its products in TF32 put in the
    program's place, every room of the pool against the f32 reference."""
    s = unet_shape(config)
    n_lv = len(s["widths"])
    weights = make_weights(config, seed, device)
    worst = 0.0
    for coords, feats, _, mask in room_pool(config, mix):
        rb = ref.Rulebooks(torch.from_numpy(coords[mask]).to(device),
                           config["spatial_size"], n_lv)
        f = torch.from_numpy(feats[mask]).to(device)
        want = ref.forward(weights, rb, f, n_lv, s["reps"]).cpu().numpy()
        got = ref.forward(weights, rb, f, n_lv, s["reps"], "tf32")
        worst = max(worst, rel_err(got.cpu().numpy(), want))
    return {"logits_rel_err": worst}


def _work(config, books, facts, traced) -> dict:
    convs = _conv_list(config)
    sub_levels = set(facts["sspnna_levels"])
    per_wave = sum(1 for li, kind, _, _ in convs
                   if kind == "sub" and li in sub_levels)
    fused = None
    model_flops = 0.0
    n_classes = config["n_classes"]
    for wave in traced:
        rooms = [f["room"] for f in wave]
        slots = rooms + rooms[:1] * (facts["batch"] - len(rooms))
        for li, kind, c, n in convs:
            if kind != "sub" or li not in sub_levels:
                continue
            pairs = sum(books[r]["sub"][li] for r in slots)
            rows = sum(books[r]["rows"][li] for r in slots)
            w = fw.sspnna_conv_work(pairs, rows, rows, c, n)
            fused = w if fused is None else fused + w
        for r in rooms:
            b = books[r]
            for li, kind, c, n in convs:
                pairs = b["sub"][li] if kind == "sub" else b["down"][li]
                model_flops += 2.0 * pairs * c * n
            model_flops += 2.0 * b["rows"][0] * config["m"] * n_classes
    return {"sspnna_fused": fused, "sspnna_per_wave": per_wave,
            "sspnna_launches_per_wave": facts["sspnna_launches_per_wave"],
            "model_flops": model_flops}
