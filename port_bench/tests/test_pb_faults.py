"""Whole runs at smoke size with the timed path broken underneath: each
fault a cell can have makes ``correct`` come out false."""
import pytest
import torch

from conftest import SERVE, TRAIN, run_small


def _patch_masked_step(monkeypatch, make):
    from repro_torch.launch import steps
    real = steps.make_train_step

    def patched(cfg, with_masks=False, use_kernels=False):
        step = real(cfg, with_masks=with_masks, use_kernels=use_kernels)
        return make(step, cfg) if with_masks else step
    monkeypatch.setattr(steps, "make_train_step", patched)


def unchanged(step, cfg):
    """The step computes its loss and leaves params and state as they were."""
    from repro_torch.launch import steps
    grads_of = steps.make_grads_fn(cfg, use_kernels=True)

    def broken(params, state, batch, masks):
        (loss, metrics), _ = grads_of(params, batch, masks)
        return params, state, dict(metrics, loss=loss)
    return broken


def half_batch(step, cfg):
    """The step sees half of the batch and takes the mean over it."""
    def broken(params, state, batch, masks):
        return step(params, state, {k: v[: v.shape[0] // 2] for k, v in batch.items()}, masks)
    return broken


@pytest.mark.parametrize("fault", [unchanged, half_batch], ids=lambda f: f.__name__)
def test_train_fault_fails(monkeypatch, fault):
    _patch_masked_step(monkeypatch, fault)
    assert not run_small(TRAIN).correct


def test_serve_state_unchanged_fails(monkeypatch):
    """Decoding never writes the KV cache: each step attends to stale slots."""
    from repro_torch.models import attention
    monkeypatch.setattr(attention, "write_slot", lambda cache, pos, new: None)
    assert not run_small(SERVE).correct


def test_serve_token_altered_fails(monkeypatch):
    """The first token of every request is moved by one where the prefill
    produces it."""
    from repro_torch.launch.serving import ServeEngine
    real = ServeEngine._prefill

    def altered(self, tokens, length, row):
        first, caches = real(self, tokens, length, row)
        return (first + 1) % self.cfg.vocab_size, caches
    monkeypatch.setattr(ServeEngine, "_prefill", altered)
    assert not run_small(SERVE).correct


@pytest.mark.cuda
def test_cuda_smoke_run(cuda_device):
    """The train cell's whole run at smoke size on the card."""
    import importlib
    from conftest import SEED, small_cell
    w, c, t = small_cell(TRAIN)
    run = importlib.import_module("drivers.train_step").run(
        w, c, t, SEED, 0.5, True, lambda tp: 0.0, device=cuda_device)
    assert run.correct, run.rows
    assert run.trace is not None and run.trace.busy_s() > 0
    torch.cuda.empty_cache()
