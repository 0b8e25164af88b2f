"""Dynamic contract checker (port of ``repro/analysis/contracts.py``, pass 2
of ``repro_torch.analysis``).

Where lint.py reads source text, this pass runs the real programs under a
``TorchDispatchMode`` (``OpRecorder``: every aten op, the shapes, dtypes and
devices of its tensor inputs, and the dtypes of its outputs) and asserts the
invariants the port's performance story depends on:

  * **no-f64**: the smoke train step of every zoo arch, the gradients of
    the paper-scale and kernel fleet models and all three optimizers'
    updates run without producing a float64 tensor. They run on the meta
    device, whatever ``device`` says: like the reference's ``make_jaxpr``,
    this needs the program's dtypes and not its values.
  * **mask-as-data** (the reference's ``single-trace-*``): "the mask is
    data, not shape" (DESIGN.md §8). A torch program is not traced, so its
    structure is the sequence of (aten op, input shapes, dtypes) that the
    recorder sees: the masked train step, the fleet's cohort program, the
    ServeEngine's prefill, insert and decode chunk, the sharded population
    program and the async dispatch and buffer aggregation must each repeat
    that sequence exactly across the reference's mask contents and mixed
    hyperparameters. On ``cuda`` two more conditions hold: after the first
    call, ``kernels._build`` builds and loads nothing new (its libraries
    and the sources' digest are unchanged), and every call launches the
    same kernels as the first (``ops.launch_counts`` deltas).
  * **no-host-sync** (the reference's ``population-no-host-sync``): the
    device programs the reference traces run without a host sync: a
    kernel-fleet cohort SGD program and the cohort combine, a ServeEngine
    decode chunk and a zoo train step. On the CPU the recorder flags
    ``aten._local_scalar_dense`` (``.item()``, ``bool()``, ``int()`` of a
    tensor, a scalar's ``.tolist()``), ops whose output shape depends on
    values (``nonzero``, boolean-mask indexing, ``unique``, ...) and
    device-to-host copies; on ``cuda`` the region also runs under
    ``torch.cuda.set_sync_debug_mode("error")``. The population's
    ``ClientStore`` is host numpy by design (``fl/population.py``), as the
    reference's straggler calibration is host-side, so the store's sampling
    and updates stay outside every region. The engine loop's ``.tolist()``
    (``launch/serving.py`` ``run``) takes the chunk's tokens after the
    chunk's program has returned them, and the ragged MoE form's group
    sizes (``models/moe.py`` ``_moe_tokens``) are read on a route none of
    these steps takes: neither lies inside a region.
  * **dropped-dW-zero**: the structural guarantee of DESIGN.md §10. Dropped
    weight tiles are poisoned with NaN; the forward must stay finite and the
    dropped blocks' and heads' weight gradients must come back bitwise zero,
    for every distinct FFN width and head count of the zoo. On the CPU the
    kernels' plain versions run, which select and never multiply by the
    mask; on ``cuda`` the hand-written kernels B1-B3 and B4-B9 run.

Not ported: the reference's jaxpr walker (``walk_jaxpr``,
``_iter_subjaxprs``, ``_trace_violations``) and ``CALLBACK_PRIMITIVES``. A
torch program has no jaxpr to walk and no callback primitive to find; the
dispatch-mode recorder takes their place. ``jax.jit``'s ``_cache_size`` has
no counterpart either: the op sequence is the port's program structure.

Checks return lists of :class:`Violation`; ``run_contracts()`` runs the
registry (unexpected exceptions become violations, not crashes).
"""
from __future__ import annotations

import contextlib
import traceback
from dataclasses import dataclass
from typing import Callable, Dict, List

import numpy as np
import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves as _pytree_leaves

BLOCK_NEURONS = 128

# ops that read a device value on the host, or whose output shape depends
# on the values of their inputs (so the host must wait for them)
SYNC_OPS = {"aten._local_scalar_dense", "aten.nonzero", "aten.argwhere",
            "aten.masked_select", "aten.unique", "aten._unique",
            "aten._unique2", "aten.unique_dim", "aten.unique_consecutive",
            "aten.bincount", "aten.equal", "aten.is_nonzero", "aten.allclose"}


@dataclass
class Violation:
    check: str          # registry key, e.g. "no-f64-zoo"
    where: str          # the program checked, e.g. "train_step[stablelm-12b]"
    message: str

    def __str__(self):
        return f"{self.check}: {self.where}: {self.message}"


# ---------------------------------------------------------------------------
# the recorder

def _meta_of(t):
    return tuple(t.shape), str(t.dtype), t.device.type


class OpRecorder(TorchDispatchMode):
    """Records every aten op that runs under it: ``ops`` holds (op, the
    (shape, dtype, device) of each tensor input) in order, ``f64`` the ops
    that returned a float64 tensor, ``syncs`` the ops that make the host
    wait for the device (``SYNC_OPS``, boolean-mask indexing, copies from
    a device to the host)."""

    def __init__(self):
        super().__init__()
        self.ops: list = []
        self.f64: List[str] = []
        self.syncs: List[str] = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        name = str(func.overloadpacket)
        ins = [t for t in _pytree_leaves((args, kwargs)) if isinstance(t, torch.Tensor)]
        self.ops.append((name, tuple(_meta_of(t) for t in ins)))
        out = func(*args, **kwargs)
        outs = [t for t in _pytree_leaves(out) if isinstance(t, torch.Tensor)]
        for t in outs:
            if t.dtype == torch.float64:
                self.f64.append(f"{func} -> float64{list(t.shape)}")
        if name in SYNC_OPS:
            self.syncs.append(f"{func}{_caller()}")
        elif name in ("aten.index", "aten.index_put", "aten.index_put_") and any(
                t.dtype == torch.bool for t in ins[1:]):
            self.syncs.append(f"{func} with a boolean mask{_caller()}")
        elif (name in ("aten._to_copy", "aten.copy_") and outs
              and outs[0].device.type == "cpu"
              and any(t.device.type not in ("cpu", "meta") for t in ins)):
            self.syncs.append(f"{func}: a copy from the device to the host{_caller()}")
        return out


def _frames(frames):
    """'file:line function' of the port's frames (not this package's)."""
    return [f"{f.filename.split('src/')[-1]}:{f.lineno} {f.name}" for f in frames
            if "repro_torch" in f.filename and "analysis" not in f.filename]


def _caller() -> str:
    inner = _frames(traceback.extract_stack())[-1:]
    return f" (at {inner[0]})" if inner else ""


def _recorded(fn, calls):
    """fn, recording each call's op sequence into ``calls``, with the
    launches it made and ``_build``'s state after it. The first call runs
    unrecorded: it warms the port's per-device caches (the rope
    frequencies, the loaded kernels), as the reference's first call
    traces."""
    from repro_torch.kernels import ops
    seen = [0]

    def wrapped(*a, **kw):
        seen[0] += 1
        if seen[0] == 1:
            return fn(*a, **kw)
        before = ops.launch_counts()
        with OpRecorder() as rec:
            out = fn(*a, **kw)
        after = ops.launch_counts()
        calls.append({"ops": rec.ops,
                      "launches": {k: after[k] - before[k] for k in after},
                      "build": _build_state()})
        return out
    return wrapped


_MISSING = object()


@contextlib.contextmanager
def _patched(target, attr, make):
    """Context: ``target.attr`` (a module's function, a class's method or
    an object's) replaced by ``make(the original)``."""
    raw = vars(target).get(attr, _MISSING)
    setattr(target, attr, make(getattr(target, attr)))
    try:
        yield
    finally:
        if raw is _MISSING:
            delattr(target, attr)
        else:
            setattr(target, attr, raw)


def _build_state():
    from repro_torch.kernels import _build
    return tuple(sorted(_build._libs)), _build._digest()


def _first_difference(a, b) -> str:
    for i, (x, y) in enumerate(zip(a, b)):
        if x != y:
            return f"op {i}: {x[0]}{list(x[1])} vs {y[0]}{list(y[1])}"
    return f"{len(a)} ops vs {len(b)}"


def _same_program(check, where, calls, device, what="call") -> List[Violation]:
    """Every recorded call repeats the first one's op sequence; on cuda,
    also its launches, and nothing is built after the first call."""
    out = []
    if not calls:
        return [Violation(check, where, "the program never ran")]
    first = calls[0]
    for i, c in enumerate(calls[1:], start=2):
        if c["ops"] != first["ops"]:
            out.append(Violation(
                check, where,
                f"{what} {i} ran another op sequence than {what} 1 "
                f"({_first_difference(first['ops'], c['ops'])}): a mask's "
                f"contents are leaking into the program's structure"))
        if torch.device(device).type == "cuda":
            if c["launches"] != first["launches"]:
                out.append(Violation(check, where,
                                     f"{what} {i} launched {c['launches']}, "
                                     f"{what} 1 {first['launches']}"))
            if c["build"] != first["build"]:
                out.append(Violation(check, where,
                                     f"kernels were built or loaded after {what} 1: "
                                     f"{first['build']} -> {c['build']}"))
    return out


# ---------------------------------------------------------------------------
# host-sync regions

_SYNC_ERROR = "synchroniz"          # set_sync_debug_mode("error")'s RuntimeError


@contextlib.contextmanager
def host_sync_region(device):
    """Run the block as a region no host sync may enter; yields the
    ``OpRecorder`` that watches it. On a CUDA device the region also runs
    under ``torch.cuda.set_sync_debug_mode("error")``, so a synchronizing
    CUDA call raises there."""
    cuda = torch.device(device).type == "cuda"
    prev = torch.cuda.get_sync_debug_mode() if cuda else 0
    rec = OpRecorder()
    if cuda:
        torch.cuda.set_sync_debug_mode("error")
    try:
        with rec:
            yield rec
    finally:
        if cuda:
            torch.cuda.set_sync_debug_mode(prev)


def sync_violations(check, where, fn, *args, device="cpu"):
    """(violations, result): run fn(*args) in a ``host_sync_region``; the
    result is None when the card refused a synchronizing call."""
    out, result = [], None
    try:
        with host_sync_region(device) as rec:
            result = fn(*args)
    except RuntimeError as e:
        if _SYNC_ERROR not in str(e):
            raise
        frames = _frames(traceback.extract_tb(e.__traceback__))
        out.append(Violation(check, where, f"host sync on the card: {e} "
                                           f"(at {' <- '.join(reversed(frames[-4:]))})"))
        return out, None
    for s in sorted(set(rec.syncs)):
        out.append(Violation(check, where, f"host sync inside the region: {s}"))
    return out, result


class _Refused(Exception):
    """The card refused a synchronizing call inside a watched program."""


@contextlib.contextmanager
def watching_syncs(target, attr, where, device):
    """Context: every call of ``target.attr`` inside the block runs in a
    ``host_sync_region``; yields the list its violations go to (one per
    distinct message). A call the card refused ends the block."""
    found: list = []
    with _patched(target, attr, lambda f: _watched(f, where, device, found)):
        try:
            yield found
        except _Refused:
            pass
    found[:] = [v for i, v in enumerate(found)
                if v.message not in {u.message for u in found[:i]}]


def _watched(fn, where, device, found):
    """fn, each call run in a ``host_sync_region``; its violations go to
    ``found``, and a call the card refused raises ``_Refused``."""
    def wrapped(*args):
        v, res = sync_violations("no-host-sync", where, fn, *args, device=device)
        found.extend(v)
        if res is None:
            raise _Refused(where)
        return res
    return wrapped


# ---------------------------------------------------------------------------
# inputs

def _zoo_batch(cfg, device, batch=2, seq=8, seed=0):
    """The reference's probe batch: tokens and targets drawn from
    RandomState(seed), int32 as jnp.asarray gives them; encdec frames."""
    from repro_torch.models.layers import cdtype
    rng = np.random.RandomState(seed)
    t = rng.randint(0, 64, (batch, seq + 1))
    b = {"tokens": torch.tensor(t[:, :-1], dtype=torch.int32, device=device),
         "targets": torch.tensor(t[:, 1:], dtype=torch.int32, device=device)}
    if cfg.is_encdec:
        b["frames"] = torch.zeros((batch, seq, cfg.d_model), dtype=cdtype(cfg),
                                  device=device)
    return b


def _model_batch(model_cls, device, batch=2):
    """(x, y, v) for a paper-scale model; the LSTM takes int tokens."""
    if model_cls.__name__ == "ShakespeareLSTM":
        x = torch.zeros((batch, model_cls.seq_len), dtype=torch.int64, device=device)
    else:
        x = torch.zeros((batch, *model_cls.input_shape), dtype=torch.float32, device=device)
    return (x, torch.zeros((batch,), dtype=torch.int64, device=device),
            torch.ones((batch,), dtype=torch.float32, device=device))


def _f64_violations(check, where, rec) -> List[Violation]:
    out = [Violation(check, where, f"float64 value in the program: {h}")
           for h in rec.f64[:5]]
    if len(rec.f64) > 5:
        out.append(Violation(check, where, f"... {len(rec.f64) - 5} more float64 values"))
    return out


# ---------------------------------------------------------------------------
# no-f64

def check_zoo_train_no_f64(device="cpu") -> List[Violation]:
    """Run make_train_step of every zoo arch's smoke config on meta
    tensors, recording every op's output dtype."""
    from repro_torch.configs.base import all_configs
    from repro_torch.launch.steps import make_train_step
    from repro_torch.models import model as model_lib
    from repro_torch.optim import make_optimizer
    out = []
    for arch, cfg in sorted(all_configs().items()):
        cfg = cfg.smoke().with_overrides(grad_accum=1)
        params = model_lib.init_params(cfg, device="meta")
        state = make_optimizer(cfg.optimizer).init(params)
        step = make_train_step(cfg)
        batch = _zoo_batch(cfg, "meta")
        with OpRecorder() as rec:
            step(params, state, batch)
        out += _f64_violations("no-f64-zoo", f"train_step[{arch}]", rec)
    return out


def check_models_no_f64(device="cpu") -> List[Violation]:
    """The gradients of make_weighted_loss for the paper-scale and kernel
    fleet models, on meta tensors."""
    from repro_torch.fl.client import make_weighted_loss
    from repro_torch.models.kernel_models import KERNEL_MODELS
    from repro_torch.models.small import MODELS
    out = []
    for name, cls in {**MODELS, **KERNEL_MODELS}.items():
        params = cls.init(0, device="meta")
        leaves = [p.requires_grad_() for p in _pytree_leaves(params)]
        with OpRecorder() as rec:
            loss = make_weighted_loss(cls)(params, *_model_batch(cls, "meta"))
            torch.autograd.grad(loss, leaves, allow_unused=True)
        out += _f64_violations("no-f64-models", f"grad[{name}]", rec)
    return out


def check_optim_no_f64(device="cpu") -> List[Violation]:
    """Every optimizer's update on a small fp32 tree of meta tensors."""
    from repro_torch.optim import make_optimizer

    def tree():
        return {"w": torch.empty((4, 4), dtype=torch.float32, device="meta"),
                "b": torch.empty((4,), dtype=torch.float32, device="meta")}
    out = []
    for name in ("sgd", "sgdm", "adamw"):
        opt = make_optimizer(name)
        params = tree()
        state = opt.init(params)
        with OpRecorder() as rec:
            opt.update(tree(), state, params, 0.01)
        out += _f64_violations("no-f64-optim", f"update[{name}]", rec)
    return out


# ---------------------------------------------------------------------------
# mask-as-data

def _zoo_train_setup(arch, device):
    """A smoke-size masked train step on ``device`` that routes the FFN
    through the training kernels: (step, params, opt_state, batch, cfg)."""
    from repro_torch.configs.base import get_config
    from repro_torch.launch.steps import make_train_step
    from repro_torch.models import model as model_lib
    from repro_torch.optim import make_optimizer
    cfg = get_config(arch).smoke().with_overrides(grad_accum=1)
    params = model_lib.init_params(cfg, 0, device=device)
    state = make_optimizer(cfg.optimizer).init(params)
    step = make_train_step(cfg, with_masks=True, use_kernels=True)
    return step, params, state, _zoo_batch(cfg, device), cfg


def _on(device, masks):
    from repro_torch.core.tree import tree_map
    return tree_map(lambda m: m.to(device), masks)


def check_train_step_mask_as_data(device="cpu", arch="stablelm-12b",
                                  calls=None) -> List[Violation]:
    """The masked train step (FFN through the training kernels) runs one
    program across the reference's three mask contents: full, ordered at
    0.5, random at 0.75. ``calls`` (a list) receives the recorded steps."""
    from repro_torch.core import transformer_hooks as hooks
    from repro_torch.launch.serving import rate_masks
    step, params, state, batch, cfg = _zoo_train_setup(arch, device)
    calls = [] if calls is None else calls
    step = _recorded(step, calls)
    for masks in (hooks.full_masks(cfg), hooks.full_masks(cfg), rate_masks(cfg, 0.5),
                  rate_masks(cfg, 0.75, policy="random")):
        step(params, state, batch, _on(device, masks))
    return _same_program("mask-as-data-train",
                         f"make_train_step[{arch}, with_masks, use_kernels]",
                         calls, device, what="step")


def check_fleet_mask_as_data(device="cpu") -> List[Violation]:
    """One cohort program (``FleetEngine._run``) across rounds with other
    mask-bank contents and mixed per-client (lr, n_steps). The bank's ROW
    COUNT is shape (it changes only on calibration steps): both rounds hold
    two distinct straggler masks, so the bank has 3 rows in each."""
    from repro_torch.fl.client import FleetClient
    from repro_torch.fl.fleet import FleetEngine
    from repro_torch.models.small import FemnistCNN
    rng = np.random.RandomState(0)
    clients = [FleetClient(id=i, model_cls=FemnistCNN,
                           x=rng.randn(n, 28, 28, 1).astype(np.float32),
                           y=rng.randint(0, 62, (n,)).astype(np.int32),
                           speed=1.0, batch_size=20, local_epochs=1,
                           lr=0.01, seed=0)
               for i, n in enumerate((60, 40, 60, 40))]
    engine = FleetEngine(FemnistCNN, clients, FemnistCNN.UNIT_SPECS, device=device)
    params = FemnistCNN.init(0, device=device)

    def km(c1, c2, f1):
        return {"conv1": np.arange(c1), "conv2": np.arange(c2), "fc1": np.arange(f1)}
    calls: list = []
    with _patched(engine, "_run", lambda f: _recorded(f, calls)):
        for _ in range(2):            # the first round warms the caches
            engine.run_cohort(params, {0: km(12, 48, 90), 1: km(8, 32, 60)},
                              rates={0: 0.75, 1: 0.5})
        engine.run_cohort(params, {0: km(10, 40, 80), 2: km(14, 56, 100)},
                          rates={0: 0.6, 2: 0.9},
                          lr=np.array([0.01, 0.02, 0.005, 0.01], np.float32),
                          n_steps=np.array([1, 2, 1, 2], np.int32))
    return _same_program("mask-as-data-fleet", "FleetEngine._run", calls, device,
                         what="round")


def check_serve_mask_as_data(device="cpu", arch="stablelm-12b") -> List[Violation]:
    """ServeEngine's prefill, insert and decode chunk each run one program
    over a queue of mixed dropout rates, prompt lengths and generation
    lengths (prompts are padded to max_prompt_len, the reference's shape)."""
    from repro_torch.configs.base import get_config
    from repro_torch.launch.serving import ServeEngine, ServeRequest, rate_masks
    from repro_torch.models import model as model_lib
    cfg = get_config(arch).smoke()
    params = model_lib.init_params(cfg, 0, device=device)
    eng = ServeEngine(cfg, params, batch_size=2, max_prompt_len=8,
                      max_gen_len=4, chunk=2, bank_size=4, device=device)
    rng = np.random.RandomState(0)

    def prompt(n):
        return rng.randint(0, 64, (n,)).astype(np.int32)
    eng.submit(ServeRequest(tokens=prompt(8), gen_len=4, masks=None))
    eng.submit(ServeRequest(tokens=prompt(5), gen_len=3, masks=rate_masks(cfg, 0.5)))
    eng.submit(ServeRequest(tokens=prompt(7), gen_len=4,
                            masks=rate_masks(cfg, 0.75, policy="random")))
    calls = {k: [] for k in ("_prefill", "_insert", "_decode_program")}
    with contextlib.ExitStack() as stack:
        for k in calls:
            stack.enter_context(_patched(eng, k, lambda f, c=calls[k]: _recorded(f, c)))
        eng.run()
    out = []
    for k, c in calls.items():
        out += _same_program("mask-as-data-serve", f"ServeEngine.{k}[{arch}]", c, device)
    return out


def _population_cfg(device, **over):
    from repro_torch.fl.population import PopulationConfig
    kw = dict(n_clients=512, cohort_size=4, workload="synth", policy="none",
              n_partitions=8, samples_per_partition=20, seed=0, device=device)
    return PopulationConfig(**{**kw, **over})


def check_population_mask_as_data(device="cpu") -> List[Violation]:
    """The sharded cohort program (``ShardedFleetEngine._execute``: both
    shards' SGD and their partial sums) runs one program across four
    population rounds, each with another sampled cohort. policy='none'
    holds the mask bank at one row (bank rows are shape, and move only on
    calibration), as in the reference."""
    from repro_torch.fl.population import build_population
    from repro_torch.fl.shard_fleet import ShardedFleetEngine
    sim = build_population(_population_cfg(device, backend="sharded_fleet", n_shards=2))
    calls: list = []
    with _patched(ShardedFleetEngine, "_execute", lambda f: _recorded(f, calls)):
        sim.run(4)
    return _same_program("mask-as-data-population", "ShardedFleetEngine._execute",
                         calls, device, what="round")


def check_async_mask_as_data(device="cpu") -> List[Violation]:
    """The async dispatch program (``FleetEngine._run`` of every
    capacity-padded dispatch group) and ``aggregate_buffered`` each run one
    program over five rounds of buffers, whatever arrival order the
    virtual clock produces; policy='none' holds the rebuilt bank at one
    row, as in the reference."""
    from repro_torch.core.straggler import ArrivalModel
    from repro_torch.fl import async_rounds
    from repro_torch.fl.async_rounds import AsyncConfig
    from repro_torch.fl.fleet import FleetEngine
    from repro_torch.fl.population import build_population
    acfg = AsyncConfig(buffer_k=4, concurrency=8,
                       arrival=ArrivalModel(tail_sigma=0.5, seed=0))
    sim = build_population(_population_cfg(device, backend="async", async_cfg=acfg))
    runs: list = []
    aggs: list = []
    with _patched(FleetEngine, "_run", lambda f: _recorded(f, runs)), \
            _patched(async_rounds, "aggregate_buffered", lambda f: _recorded(f, aggs)):
        sim.run(2)
        sim.run(3)
    return (_same_program("mask-as-data-async", "async dispatch program", runs, device,
                          what="dispatch")
            + _same_program("mask-as-data-async", "aggregate_buffered", aggs, device,
                            what="buffer"))


# ---------------------------------------------------------------------------
# no-host-sync

def fleet_sync_program(device, n_clients=5, n_data=400, workload="femnist_kernel"):
    """A kernel-fleet cohort at ``workload``'s model with two stragglers:
    (program, args), where program(*args) runs the cohort's masked SGD
    (``FleetEngine._run``) and the cohort combine (``aggregate_stacked``)
    on inputs already on the device."""
    from repro_torch.core.aggregate import aggregate_stacked
    from repro_torch.fl.client import FleetClient
    from repro_torch.fl.fleet import FleetEngine
    from repro_torch.fl.simulation import WORKLOADS
    from repro_torch.models.kernel_models import KERNEL_MODELS
    _, model_name, lr, bs = WORKLOADS[workload]
    cls = KERNEL_MODELS[model_name]
    rng = np.random.RandomState(0)
    n = n_data // n_clients
    clients = [FleetClient(id=i, model_cls=cls,
                           x=rng.randn(n, *cls.input_shape).astype(np.float32),
                           y=rng.randint(0, cls.num_classes, (n,)).astype(np.int32),
                           speed=1.0, batch_size=bs, lr=lr, seed=0)
               for i in range(n_clients)]
    engine = FleetEngine(cls, clients, cls.UNIT_SPECS, use_kernels=True, device=device)
    params = cls.init(0, device=device)
    keep = {g["name"]: np.arange(g["size"] // 2) for g in cls.UNIT_SPECS}
    bank, idx, _ = engine._mask_bank(params, {0: keep, 1: keep})
    xs, ys, sw = engine._stacked_data()
    lrs = torch.full((n_clients,), lr, dtype=torch.float32, device=device)
    weights = torch.full((n_clients,), float(n), dtype=torch.float32, device=device)

    def program(params, bank, idx, xs, ys, sw, lrs, weights):
        deltas = engine._run(params, bank, idx, xs, ys, sw, lrs)
        return aggregate_stacked(params, deltas, weights, bank, idx)
    return program, (params, bank, idx, xs, ys, sw, lrs, weights)


def check_no_host_sync(device="cpu") -> List[Violation]:
    """The three device programs at test size: a femnist_kernel cohort's
    SGD and combine, StableLM-2-12B's (smoke) ServeEngine decode chunks,
    and its masked train step through the training kernels."""
    from repro_torch.configs.base import get_config
    from repro_torch.launch.serving import ServeEngine, ServeRequest, rate_masks
    from repro_torch.models import model as model_lib
    program, args = fleet_sync_program(device)
    program(*args)                    # warms the caches outside the region
    out, _ = sync_violations("no-host-sync", "fleet cohort program + combine",
                             program, *args, device=device)

    cfg = get_config("stablelm-12b").smoke()
    eng = ServeEngine(cfg, model_lib.init_params(cfg, 0, device=device), batch_size=2,
                      max_prompt_len=8, max_gen_len=4, chunk=2, device=device)
    rng = np.random.RandomState(0)
    for r in (1.0, 0.5):
        eng.submit(ServeRequest(tokens=rng.randint(0, 64, (8,)).astype(np.int32),
                                gen_len=4, masks=rate_masks(cfg, r)))
    with watching_syncs(eng, "_decode_program", "ServeEngine._decode_program",
                        device) as found:
        eng.run()
    out += found

    step, params, state, batch, cfg = _zoo_train_setup("stablelm-12b", device)
    masks = _on(device, rate_masks(cfg, 0.5))
    step(params, state, batch, masks)             # warms the caches outside the region
    v, _ = sync_violations("no-host-sync", "make_train_step[stablelm-12b, use_kernels]",
                           step, params, state, batch, masks, device=device)
    return out + v


# ---------------------------------------------------------------------------
# dropped-dW-zero (NaN poison)

def _ffn_cases():
    """Unique (F, ffn_kind) over all configs/ FFN widths, incl. MoE expert
    width; kernel fleet models ride along with their gelu FFNs."""
    from repro_torch.configs.base import all_configs
    cases = {}
    for arch, cfg in all_configs().items():
        for F in filter(None, (cfg.d_ff, cfg.moe_ff)):
            cases.setdefault((F, cfg.ffn_kind), arch)
    cases.setdefault((1024, "gelu"), "kernel_mlp")
    cases.setdefault((256, "gelu"), "kernel_attn")
    return cases


def _rel_inf(got, want) -> float:
    return float((got.float() - want.float()).abs().max()
                 / want.float().abs().max().clamp_min(1e-30))


def _draw(gen, shape, dtype, device, scale=1.0):
    """Normal draws from ``gen`` on ``device`` (fp32, then ``dtype``)."""
    return (torch.randn(shape, generator=gen, device=device) * scale).to(dtype)


def _poisoned(gen, shape, dropped, axis, dtype, device, scale):
    """(poisoned, clean): one draw, with the dropped units along ``axis``
    (a bool tensor) set to NaN in the first."""
    clean = _draw(gen, shape, dtype, device, scale)
    bad = clean.clone()
    bad.index_fill_(axis, dropped.nonzero()[:, 0], float("nan"))
    return bad, clean


def ffn_poison_case(F, kind, device="cpu", d=16, M=8, dtype=torch.float32, seed=0):
    """One dw-zero-ffn case through ``ops.masked_ffn`` with every other
    128-block dropped and NaN-poisoned. Returns a dict: ``refused`` (the
    ValueError of a width the kernels do not take, else None), ``finite``
    (the forward), ``dropped_zero`` {name: dropped dW all exactly 0},
    ``kept_err`` (relative ∞-norm of y and the kept dW against the plain
    versions on the clean weights), and ``run`` (a function that repeats
    the poisoned forward and backward, for timing)."""
    from repro_torch.kernels import masked_ffn as mffn
    from repro_torch.kernels import ops
    from repro_torch.models.layers import _KERNEL_ACT
    nb = max(F // BLOCK_NEURONS, 1)
    if F % BLOCK_NEURONS:
        mk = lambda *s: torch.empty(s, dtype=dtype, device="meta")
        try:
            ops.masked_ffn(mk(M, d), mk(d, F), mk(F, d), mk(nb), act="silu")
        except ValueError as e:
            return {"refused": str(e)}
        return {"refused": None, "accepted_misaligned": True}
    act, gated = _KERNEL_ACT[kind]
    mask = torch.ones((nb,), device=device)
    mask[1::2] = 0.0
    dropped = (mask == 0).repeat_interleave(BLOCK_NEURONS)
    gen = torch.Generator(device=device).manual_seed(seed)
    x = _draw(gen, (M, d), dtype, device)
    w_in, w_in_c = _poisoned(gen, (d, F), dropped, 1, dtype, device, d ** -0.5)
    w_out, w_out_c = _poisoned(gen, (F, d), dropped, 0, dtype, device, F ** -0.5)
    w_gate = w_gate_c = None
    if gated:
        w_gate, w_gate_c = _poisoned(gen, (d, F), dropped, 1, dtype, device, d ** -0.5)
    gy = _draw(gen, (M, d), dtype, device)
    ws = [w_in, w_out] + ([w_gate] if gated else [])

    def run():
        leaves = [w.detach().requires_grad_() for w in ws]
        y = ops.masked_ffn(x, leaves[0], leaves[1], mask,
                           leaves[2] if gated else None, act=act)
        grads = torch.autograd.grad(y, leaves, gy)
        return y.detach(), grads
    y, grads = run()
    res = {"refused": None, "finite": bool(torch.isfinite(y).all())}
    cuts = {"dW_in": (grads[0], 1), "dW_out": (grads[1], 0)}
    if gated:
        cuts["dW_gate"] = (grads[2], 1)
    keep_t = ~dropped
    sel = lambda g, ax, m: g[:, m] if ax == 1 else g[m]
    res["dropped_zero"] = {k: bool((sel(g, ax, ~keep_t) == 0).all())
                           for k, (g, ax) in cuts.items()}
    # the plain versions on the clean weights, the same row mask
    rm = keep_t.to(torch.float32).expand(M, F)[None].contiguous()
    one = lambda t: None if t is None else t.contiguous()[None]
    plain_args = (one(x), one(w_in_c), one(w_out_c), rm, one(w_gate_c), act)
    want_y = mffn.masked_ffn_batch_plain(*plain_args)[0]
    want_dw = mffn.masked_ffn_dw_plain(one(gy), *plain_args)
    errs = {"y": _rel_inf(y, want_y) if res["finite"] else float("inf")}
    for (k, (g, ax)), w in zip(cuts.items(), want_dw):
        errs[k] = _rel_inf(sel(g, ax, keep_t), sel(w[0], ax, keep_t))
    res["kept_err"] = errs
    res["run"] = run
    return res


def _kept_tol(dtype):
    """The on-card tests' tolerance (tests/test_torch_cuda.py ``_tol``)."""
    return 1e-2 if dtype == torch.bfloat16 else 1e-4


def ffn_case_violations(where, res, dtype) -> List[Violation]:
    """The dw-zero-ffn verdicts on one ``ffn_poison_case`` result."""
    if res.get("accepted_misaligned"):
        return [Violation("dw-zero-ffn", where,
                          "the width is not 128-aligned but masked_ffn accepted it silently")]
    if res["refused"] is not None:
        return []
    if not res["finite"]:
        return [Violation("dw-zero-ffn", where,
                          "forward read a dropped (NaN-poisoned) weight tile")]
    out = [Violation("dw-zero-ffn", where,
                     f"{k} of dropped blocks is not bitwise zero — the backward "
                     f"touched a dropped tile")
           for k, ok in res["dropped_zero"].items() if not ok]
    out += [Violation("dw-zero-ffn", where,
                      f"kept {k} differs from the plain version on clean weights "
                      f"by {e:.3g} (> {_kept_tol(dtype)})")
            for k, e in res["kept_err"].items() if not e <= _kept_tol(dtype)]
    return out


def check_dropped_dw_zero_ffn(device="cpu", cases=None) -> List[Violation]:
    """For every distinct FFN width in the zoo (``cases``: {(F, kind):
    arch}, default ``_ffn_cases()``; d 16, M 8, fp32, as the reference):
    poison the dropped 128-blocks with NaN, demand a finite forward and
    bitwise-zero dropped dW; a misaligned width must raise ValueError."""
    out = []
    for (F, kind), arch in sorted((cases or _ffn_cases()).items()):
        res = ffn_poison_case(F, kind, device)
        out += ffn_case_violations(f"masked_ffn[F={F}, {kind}] ({arch})", res, torch.float32)
    return out


def attn_poison_case(H, device="cpu", B=1, S=4, d=16, hd=8, dtype=torch.float32, seed=0):
    """One dw-zero-attn case through ``ops.masked_attention`` at C 1, every
    other head dropped and its Q/K/V columns and O rows NaN-poisoned.
    Returns ``finite``, ``dropped_zero`` {dWq, dWk, dWv, dWo}, ``kept_err``
    (y and the kept dW against the plain versions on clean weights) and
    ``run`` (repeats the poisoned forward and backward)."""
    from repro_torch.kernels import masked_attn as mattn
    from repro_torch.kernels import ops
    hm = torch.ones((1, H), device=device)
    hm[0, 1::2] = 0.0
    dropped = (hm[0] == 0).repeat_interleave(hd)
    gen = torch.Generator(device=device).manual_seed(seed)
    x = _draw(gen, (1, B, S, d), dtype, device)
    bad, clean = {}, {}
    for name in ("wq", "wk", "wv"):
        bad[name], clean[name] = _poisoned(gen, (d, H * hd), dropped, 1, dtype, device,
                                           d ** -0.5)
    bad["wo"], clean["wo"] = _poisoned(gen, (H * hd, d), dropped, 0, dtype, device,
                                       (H * hd) ** -0.5)
    gy = _draw(gen, (1, B, S, d), dtype, device)
    names = ("wq", "wk", "wv", "wo")

    def run(ws=bad, plain=False):
        leaves = [ws[k].detach()[None].requires_grad_() for k in names]
        if plain:        # the plain versions' forward, differentiated by autograd
            y = mattn.masked_attention(x, *leaves, hm, H, proj=mattn.masked_head_proj_plain,
                                       merge=mattn.masked_head_merge_plain)
        else:
            y = ops.masked_attention(x, *leaves, hm, H)
        return y.detach(), torch.autograd.grad(y, leaves, gy)
    y, grads = run()
    keep_t = ~dropped
    axes = {"dWq": 1, "dWk": 1, "dWv": 1, "dWo": 0}
    sel = lambda g, ax, m: g[0][:, m] if ax == 1 else g[0][m]
    res = {"finite": bool(torch.isfinite(y).all())}
    res["dropped_zero"] = {k: bool((sel(g, axes[k], ~keep_t) == 0).all())
                           for k, g in zip(axes, grads)}
    want_y, want_g = run(clean, plain=True)
    errs = {"y": _rel_inf(y, want_y) if res["finite"] else float("inf")}
    for k, g, w in zip(axes, grads, want_g):
        errs[k] = _rel_inf(sel(g, axes[k], keep_t), sel(w, axes[k], keep_t))
    res["kept_err"] = errs
    res["run"] = run
    return res


def attn_case_violations(where, res, dtype) -> List[Violation]:
    """The dw-zero-attn verdicts on one ``attn_poison_case`` result."""
    if not res["finite"]:
        return [Violation("dw-zero-attn", where,
                          "forward read a dropped (NaN-poisoned) head slab")]
    out = [Violation("dw-zero-attn", where,
                     f"{k} of dropped heads is not bitwise zero — the backward "
                     f"touched a dropped head slab")
           for k, ok in res["dropped_zero"].items() if not ok]
    out += [Violation("dw-zero-attn", where,
                      f"kept {k} differs from the plain version on clean weights "
                      f"by {e:.3g} (> {_kept_tol(dtype)})")
            for k, e in res["kept_err"].items() if not e <= _kept_tol(dtype)]
    return out


def zoo_head_counts():
    from repro_torch.configs.base import all_configs
    return sorted({cfg.n_heads for cfg in all_configs().values()} | {4})


def check_dropped_dw_zero_attn(device="cpu", heads=None) -> List[Violation]:
    """For every distinct head count in the zoo (and 4; B 1, S 4, d 16, hd
    8, fp32, as the reference): poison the dropped heads' slabs with NaN,
    demand a finite forward and bitwise-zero dropped dW."""
    out = []
    for H in heads or zoo_head_counts():
        res = attn_poison_case(H, device)
        out += attn_case_violations(f"masked_attention[H={H}]", res, torch.float32)
    return out


# ---------------------------------------------------------------------------
# registry and runner

CHECKS: Dict[str, Callable[..., List[Violation]]] = {
    "no-f64-zoo": check_zoo_train_no_f64,
    "no-f64-models": check_models_no_f64,
    "no-f64-optim": check_optim_no_f64,
    "mask-as-data-train": check_train_step_mask_as_data,
    "mask-as-data-fleet": check_fleet_mask_as_data,
    "mask-as-data-serve": check_serve_mask_as_data,
    "mask-as-data-population": check_population_mask_as_data,
    "mask-as-data-async": check_async_mask_as_data,
    "no-host-sync": check_no_host_sync,
    "dw-zero-ffn": check_dropped_dw_zero_ffn,
    "dw-zero-attn": check_dropped_dw_zero_attn,
}


def resolve_device(device=None) -> str:
    """The device the contracts run on: the card unless the caller asks for
    the CPU, as the port's entry points default. Raises when the card is
    asked for and absent."""
    device = device or "cuda"
    if torch.device(device).type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("repro_torch.analysis runs its contracts on the card by "
                           "default and no CUDA device is available: pass "
                           "--device cpu (device='cpu') to run them on the CPU")
    return device


def run_contracts(progress=None, only=None, device="cpu") -> List[Violation]:
    """Run the contracts on ``device``; `only` narrows to a list of CHECKS
    names (unknown names are a loud error, not an empty green run)."""
    device = resolve_device(device)
    checks = CHECKS
    if only:
        unknown = [n for n in only if n not in CHECKS]
        if unknown:
            raise KeyError(f"unknown contract(s) {unknown}; "
                           f"available: {sorted(CHECKS)}")
        checks = {n: CHECKS[n] for n in only}
    out = []
    for name, fn in checks.items():
        if progress:
            progress(name)
        try:
            out.extend(fn(device=device))
        except Exception as e:                       # noqa: BLE001
            out.append(Violation(name, fn.__name__,
                                 f"check crashed: {type(e).__name__}: {e}"))
    return out
