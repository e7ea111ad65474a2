"""One training step on one device: loss, gradients (with microbatch
accumulation), global-norm clipping, the LR schedule and the optimizer
update (counterpart of ``repro.train.train_step``, single device, eager).

The precision plan changes the math, so the trainer builds one step per
active plan, as the reference holds one compiled graph per plan; here a
step is a plain Python closure.
"""
from __future__ import annotations

from typing import Dict

import torch

from repro_torch.configs.base import TrainConfig
from repro_torch.core.qlinear import matmul_impl
from repro_torch.core.recipe import as_plan
from repro_torch.models.model import Model
from repro_torch.optim import clip_by_global_norm, get_optimizer, \
    warmup_cosine
from repro_torch.tree import tree_leaves, tree_map

__all__ = ["make_train_step", "make_eval_step", "make_optimizer"]


def make_optimizer(model: Model, tcfg: TrainConfig):
    return get_optimizer(
        model.cfg.optimizer, weight_decay=tcfg.weight_decay,
        beta1=tcfg.beta1, beta2=tcfg.beta2, eps=tcfg.eps)


def _grads(model: Model, plan, params, batch):
    """(loss, metrics, grads): value and gradient of the loss with
    respect to every parameter leaf (a tree like ``params``)."""
    leaves = tree_leaves(params)
    for p in leaves:
        p.requires_grad_(True)
    try:
        loss, metrics = model.loss(params, batch, plan)
        grads = torch.autograd.grad(loss, leaves)
    finally:
        for p in leaves:
            p.requires_grad_(False)
    it = iter(grads)
    return (loss.detach(), {k: v.detach() for k, v in metrics.items()},
            tree_map(lambda _: next(it), params))


def make_train_step(model: Model, tcfg: TrainConfig, plan):
    """Returns ``train_step(params, opt_state, batch, step, lr_scale=1.0)
    -> (params, opt_state, metrics)``.  ``batch`` holds int32 tensors on
    the model's device; ``params`` (f32 masters) and ``opt_state`` are
    updated in place and returned.  Metrics: ``loss``, ``tokens``,
    ``total_loss`` (and ``z_loss`` when set), ``grad_norm``, ``lr``, as
    0-dim tensors."""
    matmul_impl(model.cfg.linear_impl)   # a typo'd impl fails here
    plan = as_plan(plan, model.cfg.n_layers)
    opt = make_optimizer(model, tcfg)
    lr_fn = warmup_cosine(tcfg.learning_rate, tcfg.total_steps,
                          tcfg.warmup_frac, tcfg.min_lr_frac)
    k = tcfg.microbatch

    def compute_grads(params, batch):
        if not (k and k > 1):
            _, metrics, grads = _grads(model, plan, params, batch)
            return grads, metrics
        b = batch["tokens"].shape[0]
        if b % k:
            raise ValueError(f"batch {b} does not split into {k} "
                             "microbatches")
        g_acc, loss_sum, per_mb = None, None, []
        for i in range(k):
            mb = {n: t[i * (b // k):(i + 1) * (b // k)]
                  for n, t in batch.items()}
            loss, metrics, g = _grads(model, plan, params, mb)
            g_acc = g if g_acc is None else tree_map(torch.add, g_acc, g)
            loss_sum = loss if loss_sum is None else loss_sum + loss
            per_mb.append(metrics)
        grads = tree_map(lambda x: x / k, g_acc)
        metrics = {n: torch.stack([m[n].to(torch.float32) for m in per_mb])
                   .mean() for n in per_mb[0]}
        metrics["loss"] = loss_sum / k
        return grads, metrics

    def train_step(params, opt_state, batch: Dict[str, torch.Tensor], step,
                   lr_scale: float = 1.0):
        grads, metrics = compute_grads(params, batch)
        grads, gnorm = clip_by_global_norm(grads, tcfg.grad_clip)
        lr = lr_fn(step) * lr_scale
        params, opt_state = opt.update(grads, opt_state, params, lr)
        metrics = dict(metrics)
        metrics["grad_norm"] = gnorm
        metrics["lr"] = lr
        return params, opt_state, metrics

    return train_step


def make_eval_step(model: Model, plan):
    plan = as_plan(plan, model.cfg.n_layers)

    @torch.no_grad()
    def eval_step(params, batch):
        return model.loss(params, batch, plan)[1]

    return eval_step
