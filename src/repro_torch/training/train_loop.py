"""The LM train step: microbatched gradient accumulation, remat, auxiliary
losses and EF-int8 gradients (port of ``repro.training.train_loop``).

``make_train_step(cfg, ...)`` returns ``train_step(state, batch) -> (state,
metrics)``; the state it returns is new and the one it took is left as it
was. A batch is ``{"tokens": (B, S+1)}``: inputs ``[:, :-1]``, targets
``[:, 1:]``, an optional ``"mask"`` (B, S) of the targets that count, and
a vision config's ``"frontend_embeds"`` or an encoder-decoder's
``"enc_frames"``, split into microbatches with the tokens.
Microbatching splits B into ``n_microbatches`` and accumulates their
gradients in ``accum_dtype``, which bounds activation memory. The gradients
come from autograd over ``models.transformer.forward(mode="train")``, which
launches no kernel (the JAX package trains through plain XLA ops). With
``compress_grads`` the accumulated gradient takes the EF-int8 round trip
and the state carries its error as ``err``.

The optimizers read the JAX package's layout, which stacks the layers of
each cycle position: the weight decay reads each leaf's rank there
(``layout_ranks``: a layer's norms have rank 2 and decay), and Adafactor's
update clip, which takes the RMS over a whole leaf, takes it over the
leaves of one stack (``layout_groups``).
"""
from __future__ import annotations

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.device import require_device
from repro_torch.models.transformer import forward, init_lm, lm_loss
from repro_torch.training import grad_compress
from repro_torch.training.optimizer import OptHParams, make_optimizer
from repro_torch.training.tree import tree_leaves, tree_map, tree_map_with_path

AUX_WEIGHTS = {"moe_lb_loss": 1e-2, "moe_z_loss": 1e-3}
METRIC_AUX = ("moe_lb_loss", "moe_z_loss", "moe_dropped")


def init_train_state(cfg: ModelConfig, hp: OptHParams | None = None,
                     params=None, *, device: str | torch.device = "cuda",
                     generator: torch.Generator | None = None) -> dict:
    """{"params", "opt", "step"}: ``params`` (or ``init_lm`` drawn from
    ``generator``), the optimizer ``cfg.optimizer`` names, and step 0 as a
    0-dim int32 on ``device``."""
    hp = hp or OptHParams()
    dev = require_device(device)
    if params is None:
        params = init_lm(cfg, device=dev, generator=generator)
    opt_init, _ = make_optimizer(cfg.optimizer, hp)
    return {"params": params, "opt": opt_init(params, hp),
            "step": torch.zeros((), dtype=torch.int32, device=dev)}


def make_loss_fn(cfg: ModelConfig):
    """-> ``loss_fn(params, batch) -> (total, metrics)``: the next-token
    loss plus the MoE auxiliaries at ``AUX_WEIGHTS``; metrics hold the
    loss without them and the auxiliaries. A vision config's batch may
    hold ``frontend_embeds`` (B, P, d); an encoder-decoder's must hold
    ``enc_frames`` (B, S_src, d), as in the JAX package."""

    def loss_fn(params, batch):
        dev = params["embed"].device
        kw = {}
        if cfg.frontend == "vision" and "frontend_embeds" in batch:
            kw["frontend_embeds"] = torch.as_tensor(batch["frontend_embeds"],
                                                    device=dev)
        if cfg.is_encdec:
            kw["enc_frames"] = torch.as_tensor(batch["enc_frames"],
                                               device=dev)
        tokens = torch.as_tensor(batch["tokens"], device=dev)
        logits, _, aux = forward(params, cfg, tokens[:, :-1], mode="train",
                                 **kw)
        loss = lm_loss(logits, tokens[:, 1:], cfg, batch.get("mask"))
        total = loss
        for k, w in AUX_WEIGHTS.items():
            if k in aux:
                total = total + w * aux[k]
        metrics = {"loss": loss}
        for k in METRIC_AUX:
            if k in aux:
                metrics[k] = aux[k]
        return total, metrics

    return loss_fn


def _value_and_grad(loss_fn):
    """``jax.value_and_grad(loss_fn, has_aux=True)`` over a params tree:
    -> ((total, metrics detached), grads tree in the params' dtypes; a
    leaf the loss does not reach gets zeros)."""
    def grad_fn(params, batch):
        live = tree_map(lambda p: p.detach().requires_grad_(), params)
        leaves = tree_leaves(live)
        with torch.enable_grad():
            total, metrics = loss_fn(live, batch)
            grads = torch.autograd.grad(total, leaves, allow_unused=True)
        it = iter(torch.zeros_like(p) if g is None else g
                  for p, g in zip(leaves, grads))
        return ((total.detach(), {k: v.detach() for k, v in metrics.items()}),
                tree_map(lambda _: next(it), live))

    return grad_fn


def layout_ranks(params, cfg: ModelConfig) -> dict:
    """Each leaf's rank in the JAX package's layout, the one its optimizers'
    weight decay reads: there the layers of every full cycle of
    ``attn_pattern`` are stacked on a leading axis (``params_from_jax``
    un-stacks them), so their leaves, norms too, count one dim more; so do
    the leaves of every encoder layer, all of which the JAX package stacks
    in one cycle."""
    stacked = cfg.n_layers // len(cfg.attn_pattern) * len(cfg.attn_pattern)
    ranks = tree_map(lambda p: p.dim(), params)
    ranks["layers"] = [tree_map(lambda r, e=int(i < stacked): r + e, lr)
                       for i, lr in enumerate(ranks["layers"])]
    if "encoder" in ranks:
        enc = ranks["encoder"]
        enc["layers"] = [tree_map(lambda r: r + 1, lr) for lr in enc["layers"]]
    return ranks


def layout_groups(params, cfg: ModelConfig) -> dict:
    """Which leaves form one leaf of the JAX package's layout: layer
    ``i*len(pattern)+j``, for ``i`` below the number of full cycles, lies
    in the stack of cycle position ``j``, so each of its leaves gets the
    key ``("cycle", j, path in the layer)``; the layers after the last full
    cycle and the leaves outside the layers stand alone (``None``). The
    encoder's layers form one stack: ``("encoder", path in the layer)``."""
    cycle = len(cfg.attn_pattern)
    stacked = cfg.n_layers // cycle * cycle

    def key(path, _):
        if path[0] == "layers" and path[1] < stacked:
            return ("cycle", path[1] % cycle) + path[2:]
        if path[:2] == ("encoder", "layers"):
            return ("encoder",) + path[3:]
        return None

    return tree_map_with_path(key, params)


def make_train_step(cfg: ModelConfig, hp: OptHParams | None = None,
                    n_microbatches: int = 1, compress_grads: bool = False,
                    grad_shardings=None, accum_dtype=torch.float32):
    """-> ``train_step(state, batch) -> (new state, metrics)``; metrics:
    ``loss`` (with microbatches, the mean of the microbatches' totals, as
    in the JAX package), the MoE auxiliaries and ``grad_norm``. A batch
    whose rows ``n_microbatches`` does not divide raises ``ValueError``, as
    the JAX step's reshape does."""
    if grad_shardings is not None:
        raise NotImplementedError(
            "grad_shardings (gradient accumulators sharded over a mesh) come "
            "with the dry run that lowers whole steps (ROADMAP.md, queue 1, "
            "slice 11b)")
    hp = hp or OptHParams()
    _, opt_update = make_optimizer(cfg.optimizer, hp)
    grad_fn = _value_and_grad(make_loss_fn(cfg))

    def train_step(state, batch):
        params = state["params"]
        for k, v in batch.items():
            rows = torch.as_tensor(v).shape[0]
            if rows % n_microbatches:
                raise ValueError(f"batch[{k!r}] has {rows} rows, which "
                                 f"{n_microbatches} microbatches do not "
                                 "divide")
        if n_microbatches == 1:
            (_, metrics), grads = grad_fn(params, batch)
        else:
            def split(x, i):
                x = torch.as_tensor(x)
                b = x.shape[0] // n_microbatches
                return x[i * b:(i + 1) * b]

            grads, msum = None, {}
            for i in range(n_microbatches):
                mb = {k: split(v, i) for k, v in batch.items()}
                (total, metrics), g = grad_fn(params, mb)
                with torch.no_grad():
                    if grads is None:
                        grads = tree_map(lambda x: x.to(accum_dtype), g)
                    else:
                        grads = tree_map(lambda a, x: a.add_(x.to(accum_dtype)),
                                         grads, g)
                del g
                metrics = dict(metrics, loss=total)
                for k, v in metrics.items():
                    v = v.float()
                    msum[k] = msum[k] + v if k in msum else v
            with torch.no_grad():
                grads = tree_map(lambda g: g.float().div_(n_microbatches),
                                 grads)
            metrics = {k: v / n_microbatches for k, v in msum.items()}

        new_err = None
        if compress_grads:
            grads, new_err = grad_compress.compress_decompress(
                grads, state["err"])

        new_params, new_opt, opt_metrics = opt_update(
            params, grads, state["opt"], state["step"], hp,
            layout_ranks(params, cfg), layout_groups(params, cfg))
        del grads
        metrics = dict(metrics, **opt_metrics)
        new_state = dict(state, params=new_params, opt=new_opt,
                         step=state["step"] + 1)
        if new_err is not None:
            new_state["err"] = new_err
        return new_state, metrics

    return train_step
