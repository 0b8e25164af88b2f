"""Step builders (port of ``repro/launch/steps.py``): the train step that
``launch/train.py`` runs, and the prefill and decode steps that
``launch/serve.serve`` runs. The reference's jit, shardings and donation
have no counterpart here; a step is a plain function over the port's model
API, and the train step updates params and optimizer state in place.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch import tracing
from repro_torch.configs.base import ModelConfig
from repro_torch.core.tree import tree_leaves, tree_map
from repro_torch.models import model as model_lib
from repro_torch.optim import make_optimizer


def make_grads_fn(cfg: ModelConfig, use_kernels: bool = False):
    """grads_of(params, batch, masks=None) -> ((loss, metrics), grads): the
    loss and its gradients (a tree like params). use_kernels is the loss's
    ``ffn_kernels``: the masked FFN through the training kernels, a
    block-remat recompute in the backward included. The params are not
    changed and need no ``requires_grad``. Spans (``tracing``):
    ``train.forward`` around the loss, ``train.backward`` around its
    gradients (a remat recompute included)."""
    def grads_of(params, batch, masks=None):
        live = tree_map(lambda p: p.detach().requires_grad_(), params)
        leaves = tree_leaves(live)
        with tracing.span("train.forward"):
            loss, metrics = model_lib.loss_fn(live, cfg, batch, masks=masks,
                                              ffn_kernels=use_kernels)
        with tracing.span("train.backward"):
            grads = torch.autograd.grad(loss, leaves, allow_unused=True,
                                        materialize_grads=True)
        by_leaf = dict(zip(map(id, leaves), grads))
        metrics = {k: v.detach() for k, v in metrics.items()}
        return (loss.detach(), metrics), tree_map(lambda p: by_leaf[id(p)], live)
    return grads_of


def make_train_step(cfg: ModelConfig, with_masks: bool = False,
                    use_kernels: bool = False):
    """step(params, opt_state, batch[, masks]) -> (params, opt_state,
    metrics), params and state updated in place; metrics {'xent', 'aux',
    'loss'} as device tensors. use_kernels routes the masked FFN through
    the training kernels (forward, dx and dW skip dropped 128-blocks);
    only meaningful with with_masks=True. With cfg.grad_accum > 1 the batch
    is split into that many microbatches, taken in order: gradients summed
    into zeros of the params' dtype and divided by the count, the loss
    their mean, the other metrics the last microbatch's. Spans
    (``tracing``): ``train.step`` around the whole, holding
    ``make_grads_fn``'s, ``train.accumulate`` around each microbatch's
    gradient sum and ``train.optimizer`` around the update."""
    opt = make_optimizer(cfg.optimizer)
    accum = max(cfg.grad_accum, 1)
    grads_of = make_grads_fn(cfg, use_kernels)

    def update(params, opt_state, batch, masks):
        if accum > 1:
            gsum = tree_map(torch.zeros_like, params)
            loss = torch.zeros((), dtype=torch.float32, device=tree_leaves(params)[0].device)
            for k in range(accum):
                mb = tree_map(lambda x: x.reshape(accum, x.shape[0] // accum,
                                                  *x.shape[1:])[k], batch)
                (loss_k, metrics), g = grads_of(params, mb, masks)
                with tracing.span("train.accumulate"):
                    for a, gg in zip(tree_leaves(gsum), tree_leaves(g)):
                        a.add_(gg.to(a.dtype))
                    loss = loss + loss_k
            grads = tree_map(lambda g: g.div_(accum), gsum)
            loss = loss / accum
        else:
            (loss, metrics), grads = grads_of(params, batch, masks)
        with tracing.span("train.optimizer"):
            params, opt_state = opt.update(grads, opt_state, params, cfg.learning_rate)
        return params, opt_state, dict(metrics, loss=loss)

    def step(params, opt_state, batch, masks=None):
        with tracing.span("train.step"):
            return update(params, opt_state, batch, masks)

    if with_masks:
        return step
    return lambda params, opt_state, batch: step(params, opt_state, batch)


def make_prefill_step(cfg: ModelConfig, cache_len: Optional[int] = None,
                      window_override: Optional[int] = None):
    """step(params, batch) -> (last-position logits (B, V), caches): the
    caches hold cache_len positions (default the prompt's);
    window_override windows every full-attention layer."""
    def step(params, batch):
        logits, caches, _ = model_lib.forward_seq(params, cfg, batch, want_cache=True,
                                                  cache_len=cache_len,
                                                  window_override=window_override)
        return logits[:, -1], caches
    return step


def make_serve_step(cfg: ModelConfig, mla_absorb: bool = False,
                    window_override: Optional[int] = None,
                    grouped_decode: bool = False):
    """step(params, caches, token (B,1), pos (B,)) -> (logits (B, V),
    caches), the caches updated in place. grouped_decode: GQA layers attend
    by ``attention._sdpa_grouped`` in place of the flash-decode kernel (the
    dry-run's sequence-sharded-cache variants)."""
    def step(params, caches, token, pos):
        logits, caches = model_lib.decode_step(params, cfg, caches, token, pos,
                                               mla_absorb=mla_absorb,
                                               window_override=window_override,
                                               grouped_decode=grouped_decode)
        return logits[:, -1], caches
    return step
