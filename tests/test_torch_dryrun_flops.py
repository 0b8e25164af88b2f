"""The dry-run's FLOPs against a real step: for every arch at smoke size,
the train (AdamW), prefill and decode steps run once on the meta device
(``launch/dryrun.dry_step``) and once for real on the CPU under
``FlopCounterMode``: the two counts are equal. The port's steps take no
aten route that depends on the device.
"""
import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from repro_torch.configs import ARCH_IDS, get_config, input_specs
from repro_torch.configs.shapes import InputShape
from repro_torch.launch import dryrun, steps
from repro_torch.models import model
from repro_torch.optim import make_optimizer


def _real_inputs(cfg, shape, gen):
    """input_specs' tree as CPU tensors: random tokens, frames, zero caches,
    every row at position seq_len // 2."""
    def make(s):
        if s.dtype == torch.int32:
            return torch.randint(0, 64, s.shape, generator=gen, dtype=torch.int32)
        return torch.zeros(s.shape, dtype=s.dtype)
    spec = input_specs(cfg, shape)
    if shape.mode != "decode":
        b = {k: make(s) for k, s in spec["batch"].items()}
        if "frames" in b:
            b["frames"] = torch.randn(b["frames"].shape, generator=gen).to(b["frames"].dtype)
        return b
    caches = [{k: _tree(v, make) for k, v in c.items()} for c in spec["caches"]]
    pos = torch.full(spec["pos"].shape, shape.seq_len // 2, dtype=torch.int32)
    return caches, make(spec["token"]), pos


def _tree(t, fn):
    return {k: _tree(v, fn) for k, v in t.items()} if isinstance(t, dict) else fn(t)


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_meta_flops_equal_a_real_cpu_step(arch):
    cfg = get_config(arch).smoke()
    cfg = cfg.with_overrides(dtype="float32", grad_accum=min(cfg.grad_accum, 2))
    gen = torch.Generator().manual_seed(0)
    for mode in ("train", "prefill", "decode"):
        shape = InputShape(f"tiny_{mode}", 16, max(2, cfg.grad_accum), mode)
        terms, _ = dryrun.dry_step(cfg, shape)
        params = model.init_params(cfg, seed=0, device="cpu")
        if mode == "train":
            opt = make_optimizer(cfg.optimizer)
            fn, args = steps.make_train_step(cfg), (params, opt.init(params),
                                                    _real_inputs(cfg, shape, gen))
        elif mode == "prefill":
            fn, args = steps.make_prefill_step(cfg), (params, _real_inputs(cfg, shape, gen))
        else:
            fn, args = steps.make_serve_step(cfg), (params, *_real_inputs(cfg, shape, gen))
        with FlopCounterMode(display=False) as fc:
            fn(*args)
        assert terms.flops == fc.get_total_flops() > 0, (arch, mode)
