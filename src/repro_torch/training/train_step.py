"""The training step: loss → grads → clip → AdamW → metrics — PyTorch port
of ``repro/training/train_step.py``."""
from __future__ import annotations

from typing import Any, NamedTuple

import torch

from repro_torch.configs.base import torch_dtype
from repro_torch.models import common as cm
from repro_torch.models import loss_fn, model_specs
from repro_torch.training.optimizer import (AdamWConfig, OptState, apply_updates,
                                            init_opt_state)


class TrainState(NamedTuple):
    params: Any
    opt: OptState


def init_train_state(cfg, seed: int = 0, device=None) -> TrainState:
    """Params from ``seed`` and zero moments on ``device`` (default: the
    card; raises without one unless the caller asks for the CPU)."""
    params = cm.init_params(model_specs(cfg), seed, device)
    return TrainState(params, init_opt_state(params, cfg.moment_dtype))


def _grad_fn(cfg, params, batch):
    """-> ((loss, metrics), {path: grad}) of ``loss_fn`` w.r.t. every leaf."""
    tracked = {path: t.detach().requires_grad_() for path, t in cm.tree_leaves(params)}
    loss, metrics = loss_fn(cfg, cm.tree_from_paths(params, tracked), batch)
    grads = torch.autograd.grad(loss, list(tracked.values()), allow_unused=True,
                                materialize_grads=True)
    return ((loss.detach(), {k: v.detach() for k, v in metrics.items()}),
            dict(zip(tracked, grads)))


def _accumulate_grads(cfg, params, batch, acc: dict):
    """``loss_fn``'s grads added into ``acc`` ({path: accumulator}) as
    backward produces each one, which is then freed: the accumulators stand
    in for a whole tree of grads, which would otherwise be held until
    backward ends (13 GB for llama-3.2-vision-90b at 5 layers in bf16).
    Leaves backward does not reach add nothing.  -> (loss, metrics)."""
    tracked = {path: t.detach().requires_grad_() for path, t in cm.tree_leaves(params)}

    def add(path):
        def hook(leaf):
            acc[path].add_(leaf.grad)
            leaf.grad = None
        return hook

    for path, t in tracked.items():
        t.register_post_accumulate_grad_hook(add(path))
    loss, metrics = loss_fn(cfg, cm.tree_from_paths(params, tracked), batch)
    loss.backward()
    return loss.detach(), {k: v.detach() for k, v in metrics.items()}


def build_train_step(cfg, hp: AdamWConfig = AdamWConfig()):
    """Train step with optional gradient accumulation.

    ``cfg.microbatches > 1`` loops over micro-slices of the global batch,
    accumulating grads in ``cfg.grad_accum_dtype``; grads are divided by the
    count, and the loss and metrics are means over the microbatches.  The
    step updates ``state`` in place (see ``training/optimizer.py``) and
    returns it with the metrics.
    """

    def train_step(state: TrainState, batch):
        m = cfg.microbatches
        if m <= 1:
            (loss, metrics), grads = _grad_fn(cfg, state.params, batch)
        else:
            rows = batch["tokens"].shape[0]
            if rows % m:
                raise ValueError(f"batch of {rows} rows does not split into {m} microbatches")
            adt = torch_dtype(cfg.grad_accum_dtype)
            grads = {path: torch.zeros_like(p, dtype=adt)
                     for path, p in cm.tree_leaves(state.params)}
            losses, per_micro = [], []
            for i in range(m):
                micro = {k: v[i * rows // m:(i + 1) * rows // m] for k, v in batch.items()}
                loss_i, metrics_i = _accumulate_grads(cfg, state.params, micro, grads)
                losses.append(loss_i)
                per_micro.append(metrics_i)
            for acc in grads.values():
                acc.div_(m)
            loss = torch.stack(losses).sum() / m
            metrics = {k: torch.stack([mt[k] for mt in per_micro]).mean()
                       for k in per_micro[0]}
        new_params, new_opt, opt_metrics = apply_updates(
            hp, state.params, cm.tree_from_paths(state.params, grads), state.opt)
        metrics = dict(metrics, loss=loss, **opt_metrics)
        return TrainState(new_params, new_opt), metrics

    return train_step
