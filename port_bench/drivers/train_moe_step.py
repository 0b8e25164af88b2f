"""Driver of the MLA + MoE training cell: FLuID's straggler step on
DeepSeek-V2's block.

What ``drivers/train_step.py`` runs (its ``drive``: the start, then the
checked steps through the window's own call and feed), on a model of
leading dense layers and MoE layers: the benchmark's weights from the
seed, an FFN snapshot, the traffic's full steps, the unit statistics
(``ffn_unit_stats``: the dense layers' units, each MoE layer's (E, f)
expert units) and ``build_masks`` at ``pick_rate(slowdown)``; then the
seed's weights again with AdamW zeroed, the checked sub-model steps under
the masks, and the window, back to back on fresh batches. A traced window
records the program's spans (``repro_torch.tracing``) and charges each
device operation to one (``harness/attribution.py``).

``correct``: once the program is freed, the plain reference
(``reference/mla_moe.py``) does the same from the seed with its own
statistics and masks. Compared: each step's loss; the first full step's
gradient (AdamW's first moment over 1 - b1) and the first checked step's,
by leaf; the change over the checked steps by leaf; per MoE layer, the
routed experts' gradient and change over the units both sides' masks
keep; the dropped units' gradient (exactly 0); the statistics and masks;
and ``route_flip``, the share of (token, MoE layer) top-k sets that differ
between the two sides' first checked steps, each side's picks read from
its own run. The picks that overflow an expert's capacity in the checked
steps' forward passes are counted on the card and read once, after the
set-up: a check row with no limit.
"""
from __future__ import annotations

import contextlib
import statistics
import time

import torch

from drivers import common
from drivers.train_step import _unflatten, drive
from harness import compare, counts_mla_moe as counts, traffic as gen, weights_mla_moe as weights
from harness.weights import DTYPES, leaves
from reference import calibration, mla_moe
from reference.adamw import AdamW

# the configuration file's key -> the program's ModelConfig field
FIELDS = {"hidden_size": "d_model", "intermediate_size": "d_ff",
          "num_attention_heads": "n_heads", "num_key_value_heads": "n_kv_heads",
          "num_hidden_layers": "n_layers", "vocab_size": "vocab_size",
          "kv_lora_rank": "kv_lora_rank", "qk_nope_head_dim": "qk_nope_dim",
          "qk_rope_head_dim": "qk_rope_dim", "v_head_dim": "v_head_dim",
          "n_routed_experts": "n_experts", "n_shared_experts": "n_shared_experts",
          "num_experts_per_tok": "top_k", "moe_intermediate_size": "moe_d_ff",
          "first_k_dense_replace": "first_k_dense", "rope_theta": "rope_theta",
          "tie_word_embeddings": "tie_embeddings", "attention_bias": "use_bias",
          "norm_topk_prob": "norm_topk_prob", "seq_aux": "seq_aux", "dtype": "dtype"}
# the file's keys whose values the program has no field for, and must be these
FIXED = {"hidden_act": "silu", "routed_scaling_factor": 1, "scoring_func": "softmax",
         "topk_method": "greedy", "n_group": 1, "topk_group": 1, "moe_layer_freq": 1,
         "q_lora_rank": None, "rms_norm_eps": 1e-06}
MASKED = ("stack/seg0/l0/ffn/w_in", "stack/seg0/l0/ffn/w_gate", "stack/seg0/l0/ffn/w_out",
          "stack/seg1/l0/moe/w_in", "stack/seg1/l0/moe/w_gate", "stack/seg1/l0/moe/w_out")
EXPERTS = MASKED[3:]


def program_config(c):
    """The program's ModelConfig for configuration c, cut to its depth; it
    must agree with every size and setting the file states. Built before
    anything is drawn: a program without the published block's fields
    stops here."""
    from repro_torch.configs import get_config
    cfg = get_config(c["port_config"]).with_overrides(
        n_layers=c["num_hidden_layers"], **c.get("port_overrides", {}))
    diff = {k: (c[k], getattr(cfg, f)) for k, f in FIELDS.items() if c[k] != getattr(cfg, f)}
    diff.update({k: (c[k], v) for k, v in FIXED.items() if c[k] != v})
    if cfg.yarn != c["rope_scaling"]:
        diff["rope_scaling"] = (c["rope_scaling"], cfg.yarn)
    if (cfg.ffn_kind, cfg.norm_kind, cfg.use_mla, cfg.q_lora_rank, cfg.parallel_block,
            cfg.padded_vocab) != ("swiglu", "rmsnorm", True, 0, False, c["vocab_size"]):
        diff["block"] = (cfg.ffn_kind, cfg.norm_kind, cfg.use_mla, cfg.q_lora_rank,
                         cfg.parallel_block, cfg.padded_vocab)
    if cfg.router_aux_coef != c["assumed"]["aux_loss_alpha"] or \
            cfg.moe_capacity_factor != c["assumed"]["moe_capacity_factor"] or \
            cfg.moe_impl != "capacity":
        diff["assumed"] = (c["assumed"], cfg.router_aux_coef, cfg.moe_capacity_factor,
                           cfg.moe_impl)
    if diff:
        raise SystemExit(f"the program's {c['port_config']} is not the configuration "
                         f"file's: {diff}")
    return cfg


def _norm(x):
    return float(torch.linalg.vector_norm(x, dtype=torch.float64))


def unit_sq(path, x):
    """float64 on the host: the squared norm of each hidden unit of one
    layer's masked matrix x, (f,) for a dense FFN, (E, f) for the experts
    (units are w_out's rows, the other matrices' columns)."""
    axis = -1 if path.endswith("w_out") else -2
    return x.double().square().sum(dim=axis).cpu()


def _keep_of(keep, path, r):
    return keep["moe" if "/moe/" in path else "ffn"][r]


def _dropped_nonzero(path, g, keep):
    """Elements of a layer's dropped units' gradient that are not exactly 0."""
    drop = keep.to(g.device) == 0
    rows = g[drop] if path.endswith("w_out") else g.transpose(-1, -2)[drop]
    return int((rows != 0).sum())


class _Side:
    """What the check reads of a side: gradients from its AdamW first
    moment, its change from the seed's weights, by leaf and, for the masked
    matrices, by layer and unit."""

    def moment_grads(self, keep=None):
        b1 = self.c["optimizer"]["b1"]
        norms, nonzero = {}, 0
        for p, m in self.leaves("m"):
            g = m / (1 - b1)
            norms[p] = _norm(g)
            if p in MASKED:
                for r in range(g.shape[0]):
                    norms[f"{p}@{r}"] = unit_sq(p, g[r])
                    if keep is not None:
                        nonzero += _dropped_nonzero(p, g[r], _keep_of(keep, p, r))
            del g
        return norms, nonzero

    def change(self):
        out = {}
        for p, x in self.leaves("params"):
            if p.startswith("stack/"):
                total, first = 0.0, weights.first_layer(self.c, p)
                for r in range(x.shape[0]):
                    dx = x[r] - weights.initial(self.c, self.seed, p, first + r, x[r])
                    total += _norm(dx) ** 2
                    if p in MASKED:
                        out[f"{p}@{r}"] = unit_sq(p, dx)
                    del dx
                out[p] = total ** 0.5
            else:
                out[p] = _norm(x - weights.initial(self.c, self.seed, p, 0, x))
        return out


class ProgramSide(_Side):
    """The program's train step, params and AdamW state."""

    def __init__(self, c, t, seed, device):
        self.cfg = program_config(c)
        from repro_torch.launch import steps
        from repro_torch.optim import make_optimizer
        self.c, self.t, self.seed, self.device = c, t, seed, device
        self.params = weights.make_params(c, seed, device)
        common.check_layout(self.params, self.cfg, DTYPES[c["weight_dtype"]])
        self.opt = make_optimizer(self.cfg.optimizer)
        self.state_ = self.opt.init(self.params)
        self.full = steps.make_train_step(self.cfg)
        self.step = steps.make_train_step(self.cfg, with_masks=True,
                                          use_kernels=t["route"] == "kernels")
        self.masks, self.routes = None, None

    def snapshot(self):
        from repro_torch.launch import train
        self.snap = train.ffn_snapshot(self.params, self.cfg)

    def full_step(self, b):
        self.params, self.state_, met = self.full(self.params, self.state_, b)
        return float(met["loss"])

    def calibrate(self):
        """(rate, {"ffn", "moe"} statistics on the host, the same of the
        keep masks)."""
        from repro_torch.core import transformer_hooks as hooks
        from repro_torch.core.straggler import pick_rate
        stats = hooks.ffn_unit_stats(self.snap, self.params, self.cfg)
        del self.snap
        r = pick_rate(self.t["straggler_slowdown"])
        masks = hooks.build_masks(stats, self.cfg, r)
        dense, moe = masks[0]["l0"]["ffn"], masks[1]["l0"]["moe"]
        self.masks = [{"l0": {"ffn": dense.to(self.device)}},
                      {"l0": {"moe": moe.to(self.device)}}]
        return r, {"ffn": stats[0]["l0"]["ffn"].double().cpu(),
                   "moe": stats[1]["l0"]["moe"].double().cpu()}, \
            {"ffn": dense.clone(), "moe": moe.clone()}

    def restart(self):
        """The seed's weights again, in place, AdamW's state zeroed, and the
        next masked steps' routes recorded (``RouteRecorder``)."""
        weights.fill(self.params, self.c, self.seed)
        for w in ("m", "v"):
            for _, x in leaves(self.state_[w]):
                x.zero_()
        self.state_["t"].zero_()
        self.routes = RouteRecorder(self.cfg)

    def masked_step(self, b):
        with self.routes or contextlib.nullcontext():
            self.params, self.state_, met = self.step(self.params, self.state_, b, self.masks)
        return float(met["loss"])

    @property
    def picks(self):
        return self.routes.picks

    def leaves(self, which):
        return leaves(self.params if which == "params" else self.state_[which])

    def free(self):
        for k in ("params", "state_", "masks", "full", "step", "opt"):
            setattr(self, k, None)
        common.free()


class RouteRecorder:
    """Around a masked step, the program's spans recorded
    (``repro_torch.tracing``) and the route's outcome read from the
    ``moe.dispatch`` spans of the forward pass (one an MoE layer and token
    chunk, the first by start; the remat recompute's come later and are
    left out): in the first step each token's picks as a (T, E) bool on the
    host, in every step each expert's load, kept on the card."""

    def __init__(self, cfg):
        self.cfg, self.picks = cfg, None
        self.layers = cfg.n_layers - cfg.first_k_dense
        self.loads = []

    def __enter__(self):
        from repro_torch import tracing
        tracing.drain()
        tracing.enable()
        return self

    def __exit__(self, *exc):
        from repro_torch import tracing
        from repro_torch.models import moe
        tracing.disable()
        calls = sorted((p for p in tracing.drain() if p.name == "moe.dispatch"),
                       key=lambda p: p.start)[:self.layers]
        chunks = []
        for i, p in enumerate(calls):
            gs, tok, row_e = p.attrs["load"], p.attrs["token_of"], p.attrs["expert_of"]
            T = tok.shape[0] // self.cfg.top_k
            self.loads.append((i, gs.clone(), moe.capacity(T, self.cfg)))
            if self.picks is None:
                sets = torch.zeros(T, self.cfg.n_experts, dtype=torch.bool, device=tok.device)
                sets[tok, row_e] = True
                chunks.append(sets)
        if self.picks is None:
            self.picks = [x.cpu() for x in chunks]
        return False

    def _host_loads(self):
        return [(i, gs.double().cpu(), cap) for i, gs, cap in self.loads]

    def dropped_share(self):
        """The share of the recorded forward picks that the capacity drops:
        those past an expert's capacity and an overflowing expert's slot
        cap - 1."""
        loads = self._host_loads()
        dropped = sum(float((g - cap).clamp(min=0).sum() + (g > cap).sum())
                      for _, g, cap in loads)
        return dropped / sum(float(g.sum()) for _, g, _ in loads) if loads else 0.0

    def by_layer(self):
        """Per MoE layer, over the recorded steps: the largest expert load
        over the mean, and the share of picks past capacity (the slot
        cap - 1 overwrite left out)."""
        out = {}
        for i, g, cap in self._host_loads():
            a = out.setdefault(i, [0.0, 0.0, 0.0])
            a[0] = max(a[0], float(g.max() / g.mean()))
            a[1] += float((g - cap).clamp(min=0).sum())
            a[2] += float(g.sum())
        return [[round(a[0], 3), round(a[1] / a[2], 4)] for _, a in sorted(out.items())]


class ReferenceSide(_Side):
    """The plain reference in float32; or, in the program's place, the
    control (``precision`` "fp8", every matmul operand rounded) or a
    planted fault (``half_batch``: the checked steps see half of each
    batch; ``renormalised``: the routed experts' weights divided by their
    sum, as the program's module default does). Its AdamW takes each layer
    of a stacked leaf as a leaf of its own, so that its temporaries are a
    layer's and not five (3.4 GB a matrix at the published widths), and so
    does its autograd (``_grads``)."""

    def __init__(self, c, t, seed, device, precision="fp32", fault=None):
        self.c, self.t, self.seed, self.device = c, t, seed, device
        self.precision, self.fault = precision, fault
        self.tree = weights.make_params(c, seed, device, torch.float32)
        self.flat = dict(leaves(self.tree))
        self.opt = AdamW(_by_layer(self.flat), c["optimizer"])
        self.keep, self.picks = None, None

    def _grads(self, b, keeps, record=None):
        """(loss, gradients by ``_by_layer`` key): each layer of a stacked
        leaf a leaf of its own, so that no layer's gradient is put into a
        zeroed stack of all five."""
        live = {k: t.detach().requires_grad_() for k, t in _by_layer(self.flat).items()}
        tree = {}
        for k, t in live.items():
            p, _, r = k.partition("#")
            if r:
                tree.setdefault(p, []).append(t)
            else:
                tree[p] = t
        real = mla_moe.pick_weights
        if self.fault == "renormalised":
            # in place for the backward too: its recompute runs the layers again
            mla_moe.pick_weights = lambda probs, picks: _renormalised(real(probs, picks))
        try:
            with mla_moe.exact_fp32():
                loss = mla_moe.loss(_unflatten(tree), b, self.c, keeps, self.precision, record)
                grads = torch.autograd.grad(loss, list(live.values()))
        finally:
            mla_moe.pick_weights = real
        return float(loss.detach()), dict(zip(live, grads))

    def snapshot(self):
        self.snap = {p: self.flat[p].clone() for p in MASKED if p not in EXPERTS[1:]}

    def full_step(self, b):
        loss, g = self._grads(b, None)
        self.opt.step(g)
        return loss

    def calibrate(self):
        """Its own statistics (a dense layer's units over its three
        matrices, an expert's units over its w_in, the program's rule) and
        the top blocks (or units, where f is no multiple of 128) at the
        traffic's rate."""
        ffn = lambda p: p.rsplit("/", 1)[1]
        dense = calibration.unit_stats({ffn(p): self.snap[p] for p in MASKED[:3]},
                                       {ffn(p): self.flat[p] for p in MASKED[:3]}).cpu()
        w0, w1 = self.snap[EXPERTS[0]], self.flat[EXPERTS[0]]
        moe = torch.stack([_expert_stats(w0[r], w1[r]) for r in range(w0.shape[0])]).cpu()
        del self.snap
        r = self.t["rate"]
        self.keep = {"ffn": top_units(dense, r), "moe": top_units(moe, r)}
        return r, {"ffn": dense, "moe": moe}, {k: v.clone() for k, v in self.keep.items()}

    def restart(self):
        weights.fill(self.tree, self.c, self.seed)
        for w in (self.opt.m, self.opt.v):
            for x in w.values():
                x.zero_()
        self.opt.t = 0
        self.picks = None

    def masked_step(self, b):
        if self.fault == "half_batch":
            b = {k: v[: v.shape[0] // 2] for k, v in b.items()}
        keeps = [k.to(self.device) > 0 for k in self.keep["ffn"]] + \
                [k.to(self.device) > 0 for k in self.keep["moe"]]
        record = [] if self.picks is None else None
        loss, g = self._grads(b, keeps, record)
        if record is not None:
            self.picks = [x.cpu() for x in record]
        self.opt.step(g)
        return loss

    def leaves(self, which):
        """(path, tensor) of the params, or of AdamW's ``m`` or ``v`` with each
        stacked leaf's layers stacked again, one leaf at a time."""
        if which == "params":
            yield from self.flat.items()
            return
        state = getattr(self.opt, which)
        for p, x in self.flat.items():
            if p.startswith("stack/"):
                yield p, torch.stack([state[f"{p}#{r}"] for r in range(x.shape[0])])
            else:
                yield p, state[p]

    def free(self):
        self.tree = self.flat = self.opt = None
        common.free()


def _renormalised(w):
    return w / w.sum(-1, keepdim=True)


def _by_layer(flat):
    """{path#r: layer r} of each stacked leaf (views), the others as they are."""
    out = {}
    for p, t in flat.items():
        if p.startswith("stack/"):
            out.update({f"{p}#{r}": t[r] for r in range(t.shape[0])})
        else:
            out[p] = t
    return out


def _expert_stats(w0, w1):
    """(E, f) float64: each expert unit's norm-relative update over its
    column of w_in (E, d, f)."""
    a, b = w0.double(), w1.double()
    return (b - a).square().sum(1).sqrt() / (a.square().sum(1).sqrt() + 1e-8)


def granule(n: int) -> int:
    """The units a mask keeps together: 128-unit blocks where n allows."""
    return calibration.BLOCK if n % calibration.BLOCK == 0 else 1


def granules(stats):
    """(..., n // g) means of the statistics over each granule."""
    n = stats.shape[-1]
    g = granule(n)
    return stats.reshape(*stats.shape[:-1], n // g, g).mean(-1)


def top_units(stats, r):
    """float32 0/1 (..., n): the kept_count(n // g, r) highest granules of
    each row."""
    n = stats.shape[-1]
    gs = granules(stats)
    top = gs.argsort(dim=-1, descending=True)[..., :calibration.kept_count(gs.shape[-1], r)]
    keep = torch.zeros_like(gs).scatter_(-1, top, 1.0)
    return keep.repeat_interleave(granule(n), dim=-1).float()


def mask_numbers(t, prog, ref_stats):
    """stat_gap: the worst gap between the sides' granule statistics,
    against the layer's median; mask_flip: how far a row's kept granules
    reach below its dropped ones by the reference's statistics, against
    the layer's median (a row: a dense layer, or one expert of an MoE
    layer); mask_errors: rows whose mask is not granular or keeps another
    count than round(granules * rate), and a rate other than the
    traffic's."""
    out = {"stat_gap": 0.0, "mask_flip": 0.0,
           "mask_errors": int(prog["rate"] != t["rate"])}
    for group in ("ffn", "moe"):
        pb, rb = granules(prog["stats"][group]), granules(ref_stats[group])
        keep = prog["keep"][group]
        g = granule(keep.shape[-1])
        kg = keep.reshape(*keep.shape[:-1], -1, g)
        granular = kg.amin(-1) == kg.amax(-1)
        kb = kg[..., 0] > 0
        want = calibration.kept_count(pb.shape[-1], t["rate"])
        out["mask_errors"] += int((~granular.all(-1) | (kb.sum(-1) != want)).sum())
        for layer in range(rb.shape[0]):
            med = float(rb[layer].median())
            out["stat_gap"] = max(out["stat_gap"],
                                  float((pb[layer] - rb[layer]).abs().max()) / med)
            rows_r, rows_k = rb[layer].reshape(-1, rb.shape[-1]), kb[layer].reshape(-1, rb.shape[-1])
            for s, k in zip(rows_r, rows_k):
                if k.any() and (~k).any():
                    out["mask_flip"] = max(out["mask_flip"],
                                           float(s[~k].max() - s[k].min()) / med)
    return out


def split_norms(norms):
    return ({k: v for k, v in norms.items() if "@" not in k},
            {k: v for k, v in norms.items() if "@" in k})


def common_unit_norms(prog_sq, ref_sq, prog_keep, ref_keep, paths=EXPERTS):
    """Per (masked leaf, layer) among ``paths``, each side's norm over the
    units both sides' masks keep."""
    def norm(sq, key):
        path, r = key.rsplit("@", 1)
        both = (_keep_of(prog_keep, path, int(r)) > 0) & (_keep_of(ref_keep, path, int(r)) > 0)
        return float(sq[key][both].sum()) ** 0.5
    keys = [k for k in ref_sq if k.rsplit("@", 1)[0] in paths]
    return {k: norm(prog_sq, k) for k in keys}, {k: norm(ref_sq, k) for k in keys}


def route_flip(prog_picks, ref_picks):
    """The share of (token, MoE layer) top-k sets that differ."""
    differ = sum(int((a != b).any(-1).sum()) if a.shape == b.shape else b.shape[0]
                 for a, b in zip(prog_picks, ref_picks))
    return differ / sum(a.shape[0] for a in ref_picks)


def numbers(t, prog, ref):
    """Everything ``correct`` compares, by name."""
    pc, rc = prog["checked"], ref["checked"]
    out = mask_numbers(t, prog, ref["stats"])
    losses = list(zip(prog["losses"] + pc["losses"], ref["losses"] + rc["losses"]))
    out["loss_gap"] = max(abs(a - b) / abs(b) for a, b in losses)
    out["first_grad_gap"] = compare.worst_norm_gap(split_norms(prog["first_grad"])[0],
                                                   split_norms(ref["first_grad"])[0])[0]
    keeps = (prog["keep"], ref["keep"])
    (pg, pu), (rg, ru) = split_norms(pc["grad"]), split_norms(rc["grad"])
    out["grad_gap"] = compare.worst_norm_gap(pg, rg)[0]
    out["expert_grad_gap"] = compare.worst_norm_gap(*common_unit_norms(pu, ru, *keeps))[0]
    med = statistics.median(rg.values())
    moved = [p for p, g in rg.items() if g >= 1e-3 * med]
    (pw, pl), (rw, rl) = split_norms(pc["change"]), split_norms(rc["change"])
    out["change_gap"] = compare.worst_norm_gap(pw, rw, moved)[0]
    out["expert_change_gap"] = compare.worst_norm_gap(*common_unit_norms(pl, rl, *keeps))[0]
    out["dropped_nonzero"] = pc["dropped_nonzero"]
    out["route_flip"] = route_flip(prog["picks"], ref["picks"])
    return out


def details(prog, ref):
    """Where the gaps sit: each step's loss gap, the leaves with the widest
    gaps, and the granules whose keep differs between the two sides."""
    def top(a, b):
        gaps = {p: abs(a[p] - b[p]) / b[p] for p in b if "@" not in p and b[p]}
        return sorted(((round(g, 6), p) for p, g in gaps.items()), reverse=True)[:3]
    pc, rc = prog["checked"], ref["checked"]
    differ = {k: int((granules(prog["keep"][k]) != granules(ref["keep"][k])).sum())
              for k in ("ffn", "moe")}
    return {"loss_gaps": [abs(a - b) / abs(b) for a, b in
                          zip(prog["losses"] + pc["losses"], ref["losses"] + rc["losses"])],
            "first_grad_leaves": top(prog["first_grad"], ref["first_grad"]),
            "grad_leaves": top(pc["grad"], rc["grad"]),
            "change_leaves": top(pc["change"], rc["change"]),
            "mask_granules_differ": differ}


def side_run(side, feed, t, clock=None):
    """``train_step.drive`` of one side, with its first checked step's picks."""
    rec = drive(side, feed, t, clock)
    rec["picks"] = side.picks
    return rec


def kept(keep):
    """(dense layers' kept units, MoE layers' mean kept units an expert)."""
    dense = [int(x) for x in (keep["ffn"] > 0).sum(-1)]
    return dense, [float(x) for x in (keep["moe"] > 0).sum(-1).float().mean(-1)]


def run(w, c, t, seed, seconds, trace, setup_clock, device="cuda"):
    device = torch.device(device)
    clock = {}
    t0 = time.perf_counter()
    side = ProgramSide(c, t, seed, device)
    common.sync()
    common.log(f"weights and AdamW state {time.perf_counter() - t0:.2f} s")
    feed = gen.TrainFeed(t, seed, device)
    prog = side_run(side, feed, t, clock)
    dropped = side.routes.dropped_share()
    common.log(f"set-up steps {time.perf_counter() - t0:.2f} s, clock {clock}, "
               f"dropped picks {dropped}, by MoE layer (max load / mean, past capacity) "
               f"{side.routes.by_layer()}")
    side.routes = None
    tokens_a_step = t["batch"] * t["seq"]
    ends = []
    from repro_torch import tracing
    from harness.attribution import AttributedTrace
    tracing.drain()
    if trace:
        tracing.enable()
    try:
        with common.Window(trace) as win:
            while time.perf_counter() - win.t0 < seconds:
                with win.span("feed"):
                    b = feed.next()
                with win.span("step"):
                    side.masked_step(b)
                ends.append(time.perf_counter())
    finally:
        tracing.disable()
    program = tracing.drain()
    peak = common.peak_bytes(device)
    setup_s = setup_clock(win.t0) - clock.get("check_s", 0.0)
    common.log(f"window {len(ends)} steps in {ends[-1] - win.t0:.3f} s, peak {peak}")
    t1 = time.perf_counter()
    tr = AttributedTrace.from_profiler(win.prof, win.span.kept, program) if trace else None
    common.log(f"trace read {time.perf_counter() - t1:.2f} s")
    side.free()
    t1 = time.perf_counter()
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    ref = ReferenceSide(c, t, seed, device)
    r = side_run(ref, gen.TrainFeed(t, seed, device), t)
    common.log(f"reference {time.perf_counter() - t1:.2f} s, peak {common.peak_bytes(device)}")
    ref.free()
    nums = numbers(t, prog, r)
    common.log(f"where the gaps sit: {details(prog, r)}")
    ok, rows = compare.judge(nums, compare.limits(w["name"]))
    rows.append(("dropped_picks", dropped, None))
    dense, moe_mean = kept(prog["keep"])
    step_flops = counts.train_step_flops(c, dense, moe_mean, t["batch"], t["seq"])
    return common.result(
        kind="train", c=c, t=t, correct=ok, rows=rows, attempted=len(ends), failed=0,
        setup_s=setup_s, window_s=ends[-1] - win.t0, tokens=len(ends) * tokens_a_step,
        steps=len(ends), flops=len(ends) * step_flops, step_flops=step_flops,
        peak_bytes=peak, trace=tr, calibration_s=clock["calibration_s"],
        expert_units=[int(x) for x in (prog["keep"]["moe"] > 0).sum((-2, -1))])


SIDES = {"control": dict(precision="fp8"), "half_batch": dict(fault="half_batch"),
         "renormalised": dict(fault="renormalised")}


def reading(c, t, seed, side_name, device):
    """Every number ``correct`` compares, and where the gaps sit, of one
    side put in the program's place (``program``, or a ``SIDES`` entry)
    against the reference (``train_readings.py``)."""
    if side_name == "program":
        side = ProgramSide(c, t, seed, device)
    else:
        side = ReferenceSide(c, t, seed, device, **SIDES[side_name])
    prog = side_run(side, gen.TrainFeed(t, seed, device), t)
    dropped = side.routes.dropped_share() if side_name == "program" else None
    loads = side.routes.by_layer() if side_name == "program" else None
    side.free()
    ref = ReferenceSide(c, t, seed, device)
    r = side_run(ref, gen.TrainFeed(t, seed, device), t)
    ref.free()
    return dict(numbers(t, prog, r), dropped_picks=dropped, loads=loads, **details(prog, r))
