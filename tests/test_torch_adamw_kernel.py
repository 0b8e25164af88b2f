"""AdamW's one-pass update of a leaf (``kernels/adamw.py``,
``csrc/adamw.cu``) and its plain version.

On the CPU: CPU leaves take the plain version (the chain the optimizer
ran before, the same bits) and launch nothing; meta leaves take the
card's checks first. (The kernel's order cannot be held to the CPU's
chain bit for bit: PyTorch's vectorised CPU sqrt is not correctly
rounded, its CUDA one is.) On the card (marked ``cuda``: each test skips
without a CUDA device, decided inside the fixture): the kernel against
the plain version bitwise over three steps, one launch a leaf, the
refusals, and a CUDA graph's replay. Run there with

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_adamw_kernel.py
"""
import pytest
import torch

from repro_torch import optim
from repro_torch.core.tree import tree_leaves, tree_map
from repro_torch.kernels import adamw as adamw_kernel

B1, B2, EPS, LR = 0.9, 0.95, 1e-8, 3e-4
SIZES = (1, 3, 4, 4097, (2, 7, 130))
CARD_SIZES = (1, 3, 4, 4097, 2 ** 20 + 3, (4, 96, 130))
DTYPES = {"fp32": torch.float32, "bf16": torch.bfloat16}
PAIRS = [("fp32", "fp32"), ("bf16", "bf16"), ("bf16", "fp32"), ("fp32", "bf16")]


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _shape(s):
    return s if isinstance(s, tuple) else (s,)


def _tree(sizes, p_dtype, g_dtype, device, seed):
    """(params, [grads of 3 steps]): params near 0.02, grads over seven
    decades, so that every rounding of the chain is exercised."""
    g = torch.Generator(device=device).manual_seed(seed)
    draw = lambda s: torch.randn(_shape(s), generator=g, device=device)
    params = {f"w{i}": (0.02 * draw(s)).to(p_dtype) for i, s in enumerate(sizes)}
    grads = [{k: (draw(p.shape) * torch.pow(10.0, 6 * torch.rand(p.shape, generator=g,
                                                                  device=device) - 5)
                  ).to(g_dtype)
              for k, p in params.items()} for _ in range(3)]
    return params, grads


def _chain_steps(params, grads, wd):
    """The plain version over three steps, as the optimizer drives it:
    (params, m, v) as lists of leaves."""
    ps = [p.clone() for p in tree_leaves(params)]
    ms = [torch.zeros_like(p, dtype=torch.float32) for p in ps]
    vs = [torch.zeros_like(p, dtype=torch.float32) for p in ps]
    t = torch.zeros((), dtype=torch.int32, device=ps[0].device)
    for gt in grads:
        tf = t.add_(1).float()
        bc1, bc2 = 1 - torch.pow(B1, tf), 1 - torch.pow(B2, tf)
        for p, m, v, g in zip(ps, ms, vs, tree_leaves(gt)):
            adamw_kernel.adamw_plain(p, g, m, v, bc1, bc2, B1, B2, EPS, wd, LR)
    return ps, ms, vs


def _optimizer_steps(params, grads, wd):
    opt = optim.adamw(b1=B1, b2=B2, eps=EPS, weight_decay=wd)
    params = tree_map(torch.clone, params)
    state = opt.init(params)
    for gt in grads:
        params, state = opt.update(gt, state, params, LR)
    return tree_leaves(params), tree_leaves(state["m"]), tree_leaves(state["v"]), state


def _assert_bitwise(got, want):
    for a, b in zip(got, want):
        assert a.dtype == b.dtype and a.shape == b.shape
        assert torch.equal(a, b), float((a.float() - b.float()).abs().max())


# ---------------------------------------------------------------------------
# CPU


@pytest.mark.parametrize("wd", [0.0, 0.1])
@pytest.mark.parametrize("p_name,g_name", PAIRS)
def test_cpu_leaves_take_the_plain_version(p_name, g_name, wd):
    params, grads = _tree(SIZES, DTYPES[p_name], DTYPES[g_name], "cpu", seed=1)
    before = adamw_kernel.launches.n
    ps, ms, vs, state = _optimizer_steps(params, grads, wd)
    assert adamw_kernel.launches.n == before
    assert int(state["t"]) == 3
    want = _chain_steps(params, grads, wd)
    for got, ref in zip((ps, ms, vs), want):
        _assert_bitwise(got, ref)


def _meta(shape, dtype=torch.float32):
    return torch.empty(shape, dtype=dtype, device="meta")


def _meta_leaf(**over):
    """(p, g, m, v, bc1, bc2) on the meta device, one of them replaced."""
    args = {"p": _meta((6, 8)), "g": _meta((6, 8)), "m": _meta((6, 8)), "v": _meta((6, 8)),
            "bc1": _meta(()), "bc2": _meta(())}
    args.update(over)
    return [args[k] for k in ("p", "g", "m", "v", "bc1", "bc2")]


@pytest.mark.parametrize("case,over", [
    ("non_contiguous_param", {"p": _meta((8, 6)).t()}),
    ("non_contiguous_grad", {"g": _meta((8, 6)).t()}),
    ("fp16_moment", {"v": _meta((6, 8), torch.float16)}),
    ("fp16_param", {"p": _meta((6, 8), torch.float16)}),
    ("shape_mismatch", {"g": _meta((6, 9))}),
    ("bias_correction_of_two_values", {"bc1": _meta((2,))}),
])
def test_meta_leaves_take_the_card_checks(case, over):
    before = adamw_kernel.launches.n
    with pytest.raises(ValueError):
        adamw_kernel.adamw_update(*_meta_leaf(**over), b1=B1, b2=B2, eps=EPS,
                                  weight_decay=0.0, lr=LR)
    assert adamw_kernel.launches.n == before


def test_meta_tree_updates_through_the_checks():
    """A clean meta tree (the dry-run's) passes the checks, runs the plain
    version and launches nothing."""
    params = {"w": _meta((4, 6)), "b": _meta((6,), torch.bfloat16)}
    opt = optim.adamw(weight_decay=0.1)
    state = opt.init(params)
    before = adamw_kernel.launches.n
    out, state = opt.update(tree_map(torch.empty_like, params), state, params, LR)
    assert out is params and adamw_kernel.launches.n == before
    assert state["m"]["b"].dtype == torch.float32


# ---------------------------------------------------------------------------
# the card


@pytest.mark.cuda
@pytest.mark.parametrize("wd", [0.0, 0.1])
@pytest.mark.parametrize("p_name,g_name", PAIRS)
def test_kernel_matches_plain_bitwise(dev, p_name, g_name, wd):
    """Three optimizer steps (t on the card) through the kernel give the
    plain version's params, m and v bit for bit, at leaf sizes 1, 3, 4,
    4097, 2**20 + 3 and a stacked 3-D leaf; one launch a leaf a step."""
    params, grads = _tree(CARD_SIZES, DTYPES[p_name], DTYPES[g_name], dev, seed=3)
    before = adamw_kernel.launches.n
    ps, ms, vs, state = _optimizer_steps(params, grads, wd)
    torch.cuda.synchronize()
    assert adamw_kernel.launches.n == before + 3 * len(CARD_SIZES)
    assert state["t"].device.type == "cuda" and int(state["t"]) == 3
    want = _chain_steps(params, grads, wd)
    for got, ref in zip((ps, ms, vs), want):
        _assert_bitwise(got, ref)


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["non_contiguous", "misaligned", "fp16_moment",
                                  "grad_on_cpu"])
def test_kernel_refuses_what_it_does_not_take(dev, case):
    p, g, m, v = (torch.zeros(64, 48, device=dev) for _ in range(4))
    if case == "non_contiguous":
        p = torch.zeros(48, 64, device=dev).t()
    elif case == "misaligned":
        p = torch.zeros(64 * 48 + 1, device=dev)[1:].view(64, 48)
    elif case == "fp16_moment":
        m = m.half()
    else:
        g = g.cpu()
    bc = torch.full((), 0.1, device=dev)
    before = adamw_kernel.launches.n
    with pytest.raises(ValueError):
        adamw_kernel.adamw_update(p, g, m, v, bc, bc, b1=B1, b2=B2, eps=EPS,
                                  weight_decay=0.0, lr=LR)
    assert adamw_kernel.launches.n == before


@pytest.mark.cuda
def test_kernel_step_replays_from_a_cuda_graph(dev):
    """The update issues no host sync: captured in a CUDA graph, two
    replays give what two eager steps give, bit for bit."""
    params, grads = _tree((4097, (3, 40, 70)), torch.float32, torch.float32, dev, seed=4)
    opt = optim.adamw(weight_decay=0.1)
    eager, graphed = tree_map(torch.clone, params), tree_map(torch.clone, params)
    se, sg = opt.init(eager), opt.init(graphed)
    opt.update(grads[0], se, eager, LR)             # builds and loads the kernel
    opt.update(grads[0], sg, graphed, LR)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        opt.update(grads[1], sg, graphed, LR)
    for _ in range(2):
        graph.replay()
        opt.update(grads[1], se, eager, LR)
    torch.cuda.synchronize()
    assert int(sg["t"]) == int(se["t"]) == 3
    for key in ("m", "v"):
        _assert_bitwise(tree_leaves(sg[key]), tree_leaves(se[key]))
    _assert_bitwise(tree_leaves(graphed), tree_leaves(eager))
