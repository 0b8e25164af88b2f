"""Model API (port of ``repro/models/model.py``) over every registered
architecture: decoder stacks (GQA/MQA, MLA, local attention, RG-LRU and
RWKV-6 mixers, sequential or parallel blocks, dense or MoE FFNs) and the
encoder–decoder (SeamlessM4T).

  init_params(cfg, seed, device, dtype)        -> params dict
  forward_seq(params, cfg, batch, ...)         -> (logits, caches, aux)
  loss_fn(params, cfg, batch, masks)           -> (loss, {'xent', 'aux'})
  decode_step(params, cfg, caches, ...)        -> (logits, caches)
  cache_specs(cfg, batch, seq_len, ...)        -> pytree of TensorSpec
  param_specs(cfg), count_params(params)
"""
from __future__ import annotations

import math

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core.tree import tree_leaves, tree_map
from repro_torch.models import encdec, transformer
from repro_torch.models.layers import (TensorSpec, apply_norm, embed_tokens,
                                       init_embed, init_norm, lm_logits, pdtype,
                                       softmax_xent)

ENC_MEM_LEN = 4096      # encoder memory length of the decode-shape caches


def init_params(cfg: ModelConfig, seed: int = 0, device="cuda", dtype=None):
    """Random params with the reference's keys and stacked layout:
    normal * 1/sqrt(fan_in) per matrix from a torch.Generator on ``device``
    seeded with ``seed``. Matrices are stored in ``dtype`` (default
    cfg.param_dtype), cast one layer at a time as they are drawn; vectors
    (norm scales, biases, RWKV-6's mixing, decay and bonus vectors,
    RG-LRU's gate vectors and a_param) stay in cfg.param_dtype, and an MoE
    router stays in fp32, as the reference keeps it. The numbers differ
    from the reference's jax.random init: to compare the two packages,
    convert the reference's params with
    ``repro_torch.interop.params_from_numpy``. On the meta device nothing
    is drawn (``param_specs``)."""
    device = torch.device(device)
    dtype = dtype or pdtype(cfg)
    gen = None
    if device.type != "meta":
        gen = torch.Generator(device=device)
        gen.manual_seed(seed)
    if cfg.is_encdec:
        stack = encdec.init_encdec_stack(gen, cfg, device, dtype)
        return {"tok": init_embed(gen, cfg, device, dtype),
                "final_norm": init_norm(cfg, device), "stack": stack,
                "enc_norm": init_norm(cfg, device)}
    seg_params, _ = transformer.init_stack(gen, cfg, device, dtype)
    return {"tok": init_embed(gen, cfg, device, dtype),
            "final_norm": init_norm(cfg, device),
            "stack": {f"seg{i}": sp for i, sp in enumerate(seg_params)}}


def _seg_list(params, cfg):
    segs = transformer.build_segments(cfg)
    return [params["stack"][f"seg{i}"] for i in range(len(segs))], segs


def forward_seq(params, cfg: ModelConfig, batch, masks=None,
                want_cache=False, cache_len=None, window_override=None,
                ffn_kernels=False):
    """batch: {'tokens': (B,S) int}, and for an encoder–decoder 'frames'
    (B,M,d) with masks {'enc': ..., 'dec': ...}. Returns (logits, caches,
    aux); aux is the MoE router loss summed over layers (0 without MoE).
    window_override: every full-attention layer (the decoder's
    self-attention) windowed, the long-context variant. ffn_kernels: a
    decoder stack's dense FFNs under an (f,) mask run the training kernels
    (``layers.apply_ffn``); the encoder–decoder has FFN biases, which the
    kernels refuse, and ignores it."""
    tokens = batch["tokens"]
    S = tokens.shape[1]
    positions = torch.arange(S, dtype=torch.int32, device=tokens.device)
    x = embed_tokens(params["tok"], tokens, cfg)
    if cfg.is_encdec:
        mem = encdec.run_encoder(params["stack"], batch["frames"], cfg,
                                 masks=masks["enc"] if masks else None)
        mem = apply_norm(params["enc_norm"], mem, cfg)
        x, caches = encdec.run_decoder_seq(
            params["stack"], x, mem, cfg, positions,
            masks=masks["dec"] if masks else None, want_cache=want_cache,
            cache_len=cache_len, window_override=window_override)
        caches = [caches]
        aux = torch.zeros((), dtype=torch.float32, device=x.device)
    else:
        seg_params, segs = _seg_list(params, cfg)
        x, caches, aux = transformer.run_stack_seq(
            seg_params, segs, x, cfg, positions, masks=masks,
            want_cache=want_cache, cache_len=cache_len, window_override=window_override,
            ffn_kernels=ffn_kernels)
    x = apply_norm(params["final_norm"], x, cfg)
    logits = lm_logits(params["tok"], x, cfg)
    return logits, (caches if want_cache else None), aux


def loss_fn(params, cfg: ModelConfig, batch, masks=None, window_override=None,
            ffn_kernels=False):
    """The training loss: the mean next-token xent (``batch['loss_mask']``
    weights it when given) plus cfg.router_aux_coef × the MoE router loss.
    Returns (loss, {'xent', 'aux'}). ffn_kernels as in ``forward_seq``."""
    logits, _, aux = forward_seq(params, cfg, batch, masks=masks,
                                 window_override=window_override,
                                 ffn_kernels=ffn_kernels)
    xent = softmax_xent(logits, batch["targets"], batch.get("loss_mask"))
    return xent + cfg.router_aux_coef * aux, {"xent": xent, "aux": aux}


def decode_hidden(params, cfg: ModelConfig, caches, token, pos, masks=None,
                  mla_absorb=False, window_override=None, grouped_decode=False):
    """The final-normed hidden state (B,1,d) of one decode step; the caches
    are updated in place. mla_absorb: MLA layers attend in latent space.
    grouped_decode: GQA layers attend by ``attention._sdpa_grouped`` in
    place of the flash-decode kernel (``attention.attn_decode``)."""
    x = embed_tokens(params["tok"], token, cfg)
    if cfg.is_encdec:
        x = encdec.run_decoder_decode(params["stack"], caches[0], x, cfg, pos,
                                      masks=masks["dec"] if masks else None,
                                      window_override=window_override,
                                      grouped_decode=grouped_decode)
    else:
        seg_params, segs = _seg_list(params, cfg)
        x = transformer.run_stack_decode(seg_params, segs, caches, x, cfg, pos,
                                         masks=masks, mla_absorb=mla_absorb,
                                         window_override=window_override,
                                         grouped_decode=grouped_decode)
    return apply_norm(params["final_norm"], x, cfg)


def decode_step(params, cfg: ModelConfig, caches, token, pos, masks=None,
                mla_absorb=False, window_override=None, grouped_decode=False):
    """token: (B,1) int; pos: (B,) int. Returns (logits, caches); unlike
    the reference the caches are updated in place and returned as given.
    The routes as in ``decode_hidden``."""
    x = decode_hidden(params, cfg, caches, token, pos, masks=masks,
                      mla_absorb=mla_absorb, window_override=window_override,
                      grouped_decode=grouped_decode)
    return lm_logits(params["tok"], x, cfg), caches


def cache_specs(cfg: ModelConfig, batch, seq_len, window_override=None):
    if cfg.is_encdec:
        return [encdec.dec_cache_specs(cfg, batch, seq_len, ENC_MEM_LEN,
                                       window_override)]
    return transformer.stack_cache_specs(cfg, batch, seq_len, window_override)


def init_caches(cfg: ModelConfig, batch, seq_len, device):
    """Zero caches of ``cache_specs`` shape on ``device``."""
    def alloc(tree):
        if isinstance(tree, dict):
            return {k: alloc(v) for k, v in tree.items()}
        return torch.zeros(tree.shape, dtype=tree.dtype, device=device)
    return [alloc(s) for s in cache_specs(cfg, batch, seq_len)]


def count_params(params) -> int:
    """Elements of a params tree, of tensors or of ``param_specs``."""
    return sum(math.prod(t.shape) for t in tree_leaves(params))


def param_specs(cfg: ModelConfig):
    """The TensorSpec tree of ``init_params(cfg)``, allocating and drawing
    nothing (built on the meta device)."""
    return tree_map(lambda t: TensorSpec(tuple(t.shape), t.dtype),
                    init_params(cfg, device="meta"))
