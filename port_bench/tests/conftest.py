"""Smoke-size cells for the benchmark's CPU tests: the cells' own files with
every size cut to what a test run holds, and the program cut the same way."""
import sys
from pathlib import Path

import pytest

PB = Path(__file__).resolve().parents[1]
for p in (str(PB), str(PB.parent / "src")):
    if p not in sys.path:
        sys.path.insert(0, p)

SMALL = dict(hidden_size=256, intermediate_size=512, num_attention_heads=4,
             num_key_value_heads=2, head_dim=32, num_hidden_layers=2, vocab_size=512)
SMALL_PORT = dict(d_model=256, d_ff=512, n_heads=4, n_kv_heads=2, head_dim=32,
                  vocab_size=512, vocab_pad_multiple=64)
TRAIN = "stablelm12b-train-straggler-r075"
SERVE = "commandr35b-serve-cohort-mix"
SEED = 2 ** 31 + 12345


def small_cell(workload):
    from harness import cell
    w, c, t = cell.resolve(cell.benchmark(), workload)
    c = dict(c, **SMALL, port_overrides=dict(c.get("port_overrides", {}), **SMALL_PORT))
    if t["driver"] == "train_step":
        t = dict(t, batch=4, seq=32)
    else:
        t = dict(t, slots=4, max_prompt_len=32, max_gen_len=12, chunk=4, bank_size=5,
                 cohort=[{"clients": 4, "rate": 1.0}, {"clients": 2, "rate": 0.75},
                         {"clients": 2, "rate": 0.5}],
                 prompt_len=[8, 32], gen_len=[6, 12], check_requests=4)
    return w, c, t


def run_small(workload, seed=SEED, seconds=0.5, trace=False):
    """A whole run at smoke size on the CPU, the look for a chip skipped."""
    import importlib
    w, c, t = small_cell(workload)
    driver = importlib.import_module(f"drivers.{t['driver']}")
    return driver.run(w, c, t, seed, seconds, trace, lambda tp: 0.0, device="cpu")


@pytest.fixture
def cuda_device():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")
