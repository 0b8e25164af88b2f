"""The work counts against hand counts at smoke size, and mfu's count the
same for every route that computes one sub-model."""
from conftest import TRAIN, run_small, small_cell
from harness import counts


def test_train_step_flops_by_hand():
    _, c, t = small_cell(TRAIN)
    kept = [384, 384]                      # 3 of 4 blocks in both layers
    proj = 2 * 256 * (4 * 32 + 2 * 2 * 32) + 2 * 4 * 32 * 256
    context = 4 * 4 * 32 * sum(p + 1 for p in range(32))
    ffn = 3 * 2 * 256 * 384
    head = 2 * 256 * 512
    forward = 2 * (32 * proj + context + 32 * ffn) + 32 * head
    assert counts.train_step_flops(c, kept, 4, 32) == 3 * 4 * forward == 711131136


def test_serve_request_flops_by_hand():
    _, c, _ = small_cell(TRAIN)
    kept = [512, 256]
    n = 10 + 5 - 1                          # prompt 10, 5 tokens served
    proj = 2 * 256 * 256 + 2 * 128 * 256
    context = 4 * 4 * 32 * sum(p + 1 for p in range(n))
    want = 2 * (n * proj + context) + n * 6 * 256 * (512 + 256) + 5 * 2 * 256 * 512
    assert counts.serve_request_flops(c, kept, 10, 5) == want


def test_kernel_work_by_hand():
    _, c, _ = small_cell(TRAIN)
    w = counts.train_kernel_work(c, 3, 128)
    product = 2 * 128 * 256 * 384
    io, weights, mask = 128 * 256 * 2, 3 * 128 * 256 * 2 * 3, 128 * 512 * 4
    assert w["fwd"] == (3 * product, 2 * io + weights + mask)
    assert w["dx"] == (5 * product, 3 * io + weights + mask)
    assert w["dw"] == (6 * product, 2 * io + weights + mask + 256 * 512 * 2 * 3)
    assert counts.serve_ffn_bytes(c, 3, 8) == weights + 2 * 8 * 256 * 2 + 8 * 512 * 4


def test_mfu_counts_the_sub_model_not_the_route(monkeypatch):
    import conftest
    base = conftest.small_cell
    reads = {}
    for route in ("kernels", "dense"):
        monkeypatch.setattr(conftest, "small_cell",
                            lambda wl, route=route: (lambda w, c, t: (w, c, dict(t, route=route)))(
                                *base(wl)))
        run = run_small(TRAIN)
        reads[route] = run.step_flops
        assert run.kept_blocks == [3, 3]
    assert reads["kernels"] == reads["dense"]
