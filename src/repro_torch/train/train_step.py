"""One training step on one device: loss, gradients (with microbatch
accumulation), global-norm clipping, the LR schedule and the optimizer
update (counterpart of ``repro.train.train_step``, single device, eager).

The precision plan changes the math, so the trainer builds one step per
active plan, as the reference holds one compiled graph per plan; here a
step is a plain Python closure.

With ``TrainConfig.telemetry`` the step installs a telemetry collector
around the loss: the forward-side quant stats come back in the loss
metrics, the backward-side ones as the gradients of zero probes
(``telemetry.collect``), and the per-layer gradient norms are added.
With it off the step has no collector and no probes: it is the plain
step.
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
from repro_torch.telemetry import collect as telemetry
from repro_torch.telemetry.profiler import phase_span
from repro_torch.tree import tree_leaves, tree_map

__all__ = ["make_train_step", "make_eval_step", "make_optimizer"]


def make_optimizer(model: Model, tcfg: TrainConfig):
    return get_optimizer(
        model.cfg.optimizer, weight_decay=tcfg.weight_decay,
        beta1=tcfg.beta1, beta2=tcfg.beta2, eps=tcfg.eps)


def _grads(model: Model, plan, params, batch, collector=None):
    """(loss, metrics, grads, probe grads): value and gradient of the loss
    with respect to every parameter leaf (a tree like ``params``) and,
    with a telemetry ``collector``, to fresh probes (else None)."""
    leaves = tree_leaves(params)
    unread = {id(p) for p in model.unread_leaves(params)}
    probes = None
    for p in leaves:
        p.requires_grad_(True)
    try:
        with phase_span("fwd"):
            if collector is None:
                loss, metrics = model.loss(params, batch, plan)
            else:
                probes = telemetry.make_probes(model.cfg.n_layers,
                                               model.device)
                with telemetry.collecting(collector, probes):
                    loss, metrics = model.loss(params, batch, plan)
                    metrics = {**metrics, **collector.drain_root()}
        with phase_span("bwd"):
            extra = list(probes.values()) if probes else []
            grads = torch.autograd.grad(loss, leaves + extra,
                                        allow_unused=bool(extra or unread))
    finally:
        for p in leaves:
            p.requires_grad_(False)
    if any(g is None and id(p) not in unread
           for p, g in zip(leaves, grads)):
        raise RuntimeError("a parameter does not reach the loss")
    # an unread leaf's gradient is zeros, as the reference's: AdamW's
    # moments and weight decay then move it as there
    grads = [torch.zeros_like(p) if g is None and i < len(leaves) else g
             for i, (p, g) in enumerate(zip(leaves + extra, grads))]
    # a class with no tap in this model leaves its probe unused: its
    # gradient is zero, as in the reference
    pg = None if probes is None else {
        c: torch.zeros_like(p) if g is None else g
        for (c, p), g in zip(probes.items(), grads[len(leaves):])}
    it = iter(grads)
    return (loss.detach(), {k: v.detach() for k, v in metrics.items()},
            tree_map(lambda _: next(it), params), pg)


def make_train_step(model: Model, tcfg: TrainConfig, plan):
    """Returns ``train_step(params, opt_state, batch, step, lr_scale=1.0)
    -> (params, opt_state, metrics)``; the scheduled LR times ``lr_scale``
    (the controller's backoff), both f32.  ``batch`` holds int32 tensors on
    the model's device; ``params`` (f32 masters) and ``opt_state`` are
    updated in place and returned.  Metrics: ``loss``, ``tokens``,
    ``total_loss`` (and ``z_loss`` when set), ``grad_norm``, ``lr``, as
    0-dim tensors; with ``tcfg.telemetry`` also the ``tel/...`` stats."""
    matmul_impl(model.cfg.linear_impl)   # a typo'd impl fails here
    plan = as_plan(plan, model.cfg.n_layers)
    opt = make_optimizer(model, tcfg)
    lr_fn = warmup_cosine(tcfg.learning_rate, tcfg.total_steps,
                          tcfg.warmup_frac, tcfg.min_lr_frac)
    k = tcfg.microbatch
    # one collector for the step's life; None keeps the plain step
    collector = telemetry.TelemetryCollector() if tcfg.telemetry else None

    def compute_grads(params, batch):
        if not (k and k > 1):
            _, metrics, grads, pg = _grads(model, plan, params, batch,
                                           collector)
        else:
            b = batch["tokens"].shape[0]
            if b % k:
                raise ValueError(f"batch {b} does not split into {k} "
                                 "microbatches")
            g_acc, pg, loss_sum, per_mb = None, None, None, []
            for i in range(k):
                mb = {n: t[i * (b // k):(i + 1) * (b // k)]
                      for n, t in batch.items()}
                loss, metrics, g, pg_i = _grads(model, plan, params, mb,
                                                collector)
                g_acc = g if g_acc is None else tree_map(torch.add, g_acc,
                                                         g)
                # probe rows are sums with a tap-count slot: adding them
                # keeps them self-normalizing
                if pg_i is not None:
                    pg = pg_i if pg is None else {
                        c: pg[c] + pg_i[c] for c in pg}
                loss_sum = loss if loss_sum is None else loss_sum + loss
                per_mb.append(metrics)
            grads = tree_map(lambda x: x / k, g_acc)
            metrics = {n: torch.stack([m[n].to(torch.float32)
                                       for m in per_mb]).mean()
                       for n in per_mb[0]}
            metrics["loss"] = loss_sum / k
        if pg is not None:
            metrics.update(telemetry.probe_metrics(pg))
        return grads, metrics

    def train_step(params, opt_state, batch: Dict[str, torch.Tensor], step,
                   lr_scale: float = 1.0):
        grads, metrics = compute_grads(params, batch)
        if collector is not None:
            metrics.update(telemetry.grad_norm_metrics(grads))
        grads, gnorm = clip_by_global_norm(grads, tcfg.grad_clip)
        # the scale enters in f32, as the reference's traced scalar: a
        # backed-off LR equals the reference's bit for bit
        lr = lr_fn(step) * torch.tensor(lr_scale, dtype=torch.float32)
        with phase_span("optim"):
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
