"""Step builders (port of ``repro/launch/steps.py``, its serving half):
the prefill step and the decode step that ``launch/serve.serve`` runs.
The reference's jit, shardings and donation have no counterpart here; a
step is a plain function over the port's model API.
"""
from __future__ import annotations

from typing import Optional

from repro_torch.configs.base import ModelConfig
from repro_torch.models import model as model_lib


def make_prefill_step(cfg: ModelConfig, cache_len: Optional[int] = None):
    """step(params, batch) -> (last-position logits (B, V), caches): the
    caches hold cache_len positions (default the prompt's)."""
    def step(params, batch):
        logits, caches, _ = model_lib.forward_seq(params, cfg, batch, want_cache=True,
                                                  cache_len=cache_len)
        return logits[:, -1], caches
    return step


def make_serve_step(cfg: ModelConfig, mla_absorb: bool = False):
    """step(params, caches, token (B,1), pos (B,)) -> (logits (B, V),
    caches), the caches updated in place."""
    def step(params, caches, token, pos):
        logits, caches = model_lib.decode_step(params, cfg, caches, token, pos,
                                               mla_absorb=mla_absorb)
        return logits[:, -1], caches
    return step
