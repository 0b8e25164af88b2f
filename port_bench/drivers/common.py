"""What both drivers share: the program's configuration held to the
configuration file, the window's profiler, and freeing the card."""
from __future__ import annotations

import gc
import time
from types import SimpleNamespace

import torch

# the configuration file's key -> the program's ModelConfig field
FIELDS = {"hidden_size": "d_model", "intermediate_size": "d_ff",
          "num_attention_heads": "n_heads", "num_key_value_heads": "n_kv_heads",
          "head_dim": "head_dim", "num_hidden_layers": "n_layers",
          "vocab_size": "vocab_size", "ffn_kind": "ffn_kind", "norm_kind": "norm_kind",
          "rope_theta": "rope_theta", "parallel_block": "parallel_block",
          "tie_word_embeddings": "tie_embeddings", "use_bias": "use_bias",
          "dtype": "dtype"}


def program_config(c):
    """The program's ModelConfig for configuration c, cut to its depth; it
    must agree with every size the file states."""
    from repro_torch.configs import get_config
    cfg = get_config(c["port_config"]).with_overrides(
        n_layers=c["num_hidden_layers"], **c.get("port_overrides", {}))
    diff = {k: (c[k], getattr(cfg, f)) for k, f in FIELDS.items()
            if c[k] != getattr(cfg, f)}
    if cfg.padded_vocab != cfg.vocab_size:
        diff["padded_vocab"] = (cfg.vocab_size, cfg.padded_vocab)
    if diff:
        raise SystemExit(f"the program's {c['port_config']} is not the configuration "
                         f"file's: {diff}")
    return cfg


def check_layout(params, cfg, weight_dtype):
    """The benchmark's params tree has the program's keys and shapes, its
    matrices in ``weight_dtype`` and its vectors in float32."""
    from repro_torch.models import model
    from harness.weights import leaves
    want = {p: (tuple(s.shape), weight_dtype if len(s.shape) > 1 + ("stack" in p)
                else torch.float32) for p, s in leaves(model.param_specs(cfg))}
    got = {p: (tuple(t.shape), t.dtype) for p, t in leaves(params)}
    if want != got:
        raise SystemExit(f"params layout differs from the program's: "
                         f"{set(want.items()) ^ set(got.items())}")


def log(*parts):
    """A progress line on standard error, stamped with the process's age."""
    import sys
    print(f"port_bench: [{time.perf_counter() - _T0:.2f}]", *parts, file=sys.stderr, flush=True)


_T0 = time.perf_counter()


def sync():
    if torch.cuda.is_available():
        torch.cuda.synchronize()


def peak_bytes(device) -> int:
    return torch.cuda.max_memory_allocated(device) if device.type == "cuda" else 0


class Window:
    """The measured window, traced by torch.profiler (CUDA activity) when
    asked, with the benchmark's spans (``span(name)``) kept beside it."""

    def __init__(self, trace: bool):
        from harness.trace import Spans
        self.prof, self.span = None, Spans(trace)

    def __enter__(self):
        if self.span.on:
            from torch.profiler import ProfilerActivity, profile
            # the CPU's operations only where there is no card (the tests)
            self.prof = profile(activities=[ProfilerActivity.CUDA if torch.cuda.is_available()
                                            else ProfilerActivity.CPU])
            self.prof.__enter__()
        self._window = self.span("window")
        self._window.__enter__()
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        self._window.__exit__(*exc)
        if self.prof is not None:
            self.prof.__exit__(*exc)
        return False

    def read_trace(self):
        if self.prof is None:
            return None
        from harness.trace import Trace
        return Trace.from_profiler(self.prof, self.span.kept)


def free():
    gc.collect()
    if torch.cuda.is_available():
        torch.cuda.empty_cache()


def result(**kw):
    return SimpleNamespace(**kw)
