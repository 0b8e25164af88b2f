"""Driver of a training cell: FLuID's straggler step.

Set-up builds one object, the program's train step with its params and
AdamW state, from the seed: the benchmark's weights, an FFN snapshot, the
traffic's full steps, the invariant-unit statistics against the snapshot
and ``build_masks`` at ``pick_rate(slowdown)``. The same object then takes
the seed's weights again, with its AdamW state zeroed, and runs the
traffic's checked sub-model steps under its masks through the window's own
call and feed. The window runs that call back to back on fresh batches;
every step ends in the host read of its loss.

``correct``: once the window has closed and the program is freed, the plain
reference (``reference/``) makes the same weights, takes the same batches
and does the same from its own state: the full steps, its own statistics
and masks, then the seed's weights again and the checked steps under its
own masks. Nothing the program made reaches it. Compared: each step's loss;
the first full step's gradient as AdamW got it (its first moment after one
step, over 1 - b1); the statistics and the masks; the first checked step's
gradient the same way, by leaf and, for the masked FFN's three matrices, by
layer; its dropped units' gradient (exactly 0); and the parameters' change
over the checked steps, by leaf and by FFN layer.
"""
from __future__ import annotations

import statistics
import time

import torch

from drivers import common
from harness import compare, counts, traffic as gen, weights
from reference import calibration, decoder
from reference.adamw import AdamW

FFN = ("stack/seg0/l0/ffn/w_in", "stack/seg0/l0/ffn/w_gate", "stack/seg0/l0/ffn/w_out")


def _dropped_nonzero(path, g, keep):
    """Elements of a dropped unit's gradient that are not exactly 0."""
    drop = keep.to(g.device) == 0                                # (L, F)
    rows = g[drop] if path.endswith("w_out") else g.transpose(1, 2)[drop]
    return int((rows != 0).sum())


def _norm(x):
    return float(torch.linalg.vector_norm(x, dtype=torch.float64))


def by_layer(path, r):
    """The key of layer r of a stacked FFN leaf among the norms."""
    return f"{path}@{r}"


def _block_sq(path, x):
    """(blocks,) float64 on the host: the squared norm of each 128-unit
    block of one layer's FFN matrix x (units are w_out's rows, the other
    matrices' columns)."""
    sq = x.double().square().sum(dim=1 if path.endswith("w_out") else 0)
    return sq.reshape(-1, calibration.BLOCK).sum(-1).cpu()


class _Side:
    """What the check reads of a side: its leaves, gradients worked out
    from its AdamW first moment, and its change from the seed's weights."""

    def moment_grads(self, keep=None):
        """Per leaf the norm, and per layer of the FFN leaves the squared
        norm of each 128-unit block, of g = m / (1 - b1), m the side's first
        moment after one step from a zeroed state; with ``keep``, the
        dropped units' nonzero elements of g."""
        b1 = self.c["optimizer"]["b1"]
        norms, nonzero = {}, 0
        for p, m in self.leaves("m"):
            g = m / (1 - b1)
            norms[p] = _norm(g)
            if p in FFN:
                norms.update({by_layer(p, r): _block_sq(p, g[r]) for r in range(g.shape[0])})
                if keep is not None:
                    nonzero += _dropped_nonzero(p, g, keep)
            del g
        return norms, nonzero

    def change(self):
        """Per leaf the norm, and per layer of the FFN leaves the squared
        norm of each block, of the parameters' change from the seed's
        weights."""
        out = {}
        for p, x in self.leaves("params"):
            if p.startswith("stack/") and x.ndim > 2:
                total = 0.0
                for r in range(x.shape[0]):
                    dx = x[r] - weights.initial(self.c, self.seed, p, r, x[r])
                    total += _norm(dx) ** 2
                    if p in FFN:
                        out[by_layer(p, r)] = _block_sq(p, dx)
                    del dx
                out[p] = total ** 0.5
            else:
                out[p] = _norm(x - weights.initial(self.c, self.seed, p, 0, x))
        return out


class ProgramSide(_Side):
    """The program's train step, params and AdamW state."""

    def __init__(self, c, t, seed, device):
        from repro_torch.launch import steps
        from repro_torch.optim import make_optimizer
        self.c, self.t, self.seed, self.device = c, t, seed, device
        self.cfg = common.program_config(c)
        self.params = weights.make_params(c, seed, device)
        common.check_layout(self.params, self.cfg, weights.DTYPES[c["weight_dtype"]])
        self.opt = make_optimizer(self.cfg.optimizer)
        self.state_ = self.opt.init(self.params)
        self.full = steps.make_train_step(self.cfg)
        self.step = steps.make_train_step(self.cfg, with_masks=True,
                                          use_kernels=t["route"] == "kernels")
        self.masks = None

    def snapshot(self):
        from repro_torch.launch import train
        self.snap = train.ffn_snapshot(self.params, self.cfg)

    def full_step(self, b):
        self.params, self.state_, met = self.full(self.params, self.state_, b)
        return float(met["loss"])

    def calibrate(self):
        """(rate, unit statistics (L, F) on the host, keep mask (L, F))."""
        from repro_torch.core import transformer_hooks as hooks
        from repro_torch.core.straggler import pick_rate
        stats = hooks.ffn_unit_stats(self.snap, self.params, self.cfg)
        del self.snap
        r = pick_rate(self.t["straggler_slowdown"])
        masks = hooks.build_masks(stats, self.cfg, r)
        self.masks = [{"l0": {"ffn": masks[0]["l0"]["ffn"].to(self.device)}}]
        return r, stats[0]["l0"]["ffn"].double().cpu(), masks[0]["l0"]["ffn"].clone()

    def restart(self):
        """The seed's weights again, in place, and AdamW's state zeroed."""
        weights.fill(self.params, self.c, self.seed)
        for w in ("m", "v"):
            for _, x in weights.leaves(self.state_[w]):
                x.zero_()
        self.state_["t"].zero_()

    def masked_step(self, b):
        self.params, self.state_, met = self.step(self.params, self.state_, b, self.masks)
        return float(met["loss"])

    def leaves(self, which):
        return weights.leaves(self.params if which == "params" else self.state_[which])

    def free(self):
        for k in ("params", "state_", "masks", "full", "step", "opt"):
            setattr(self, k, None)
        common.free()


class ReferenceSide(_Side):
    """The plain reference in float32; or, in the program's place, the
    control (``precision`` for the full steps, ``masked_precision`` for the
    checked ones: "fp8", or "fp8_ffn" for the FFN's matmuls alone) or a
    planted fault (``half_batch``: the checked steps see half of each batch
    and take the mean over it; ``unchanged``: they leave params and state as
    they were)."""

    def __init__(self, c, t, seed, device, precision="fp32", masked_precision=None,
                 fault=None):
        self.c, self.t, self.seed, self.device = c, t, seed, device
        self.precision, self.fault = precision, fault
        self.masked_precision = masked_precision or precision
        self.tree = weights.make_params(c, seed, device, torch.float32)
        self.flat = dict(weights.leaves(self.tree))
        self.opt = AdamW(self.flat, c["optimizer"])
        self.keep = None

    def _grads(self, b, keep, precision):
        live = {p: t.detach().requires_grad_() for p, t in self.flat.items()}
        keeps = None if keep is None else (keep.to(self.device) > 0)
        with decoder.exact_fp32():
            loss = decoder.loss(_unflatten(live), b, self.c, keeps, precision)
            grads = torch.autograd.grad(loss, list(live.values()))
        return float(loss.detach()), dict(zip(live, grads))

    def snapshot(self):
        self.snap = {p: self.flat[p].clone() for p in FFN}

    def full_step(self, b):
        loss, g = self._grads(b, None, self.precision)
        self.opt.step(g)
        return loss

    def calibrate(self):
        """Its own statistics and top-k blocks at the traffic's rate."""
        key = lambda p: p.rsplit("/", 1)[1]
        s = calibration.unit_stats({key(p): t for p, t in self.snap.items()},
                                   {key(p): self.flat[p] for p in FFN}).cpu()
        del self.snap
        r = self.t["rate"]
        bs = calibration.block_stats(s)
        top = bs.argsort(dim=1, descending=True)[:, :calibration.kept_count(bs.shape[1], r)]
        blocks = torch.zeros_like(bs).scatter_(1, top, 1.0)
        self.keep = blocks.repeat_interleave(calibration.BLOCK, dim=1).float()
        return r, s, self.keep.clone()

    def restart(self):
        weights.fill(self.tree, self.c, self.seed)
        for w in (self.opt.m, self.opt.v):
            for x in w.values():
                x.zero_()
        self.opt.t = 0

    def masked_step(self, b):
        if self.fault == "half_batch":
            b = {k: v[: v.shape[0] // 2] for k, v in b.items()}
        loss, g = self._grads(b, self.keep, self.masked_precision)
        if self.fault != "unchanged":
            self.opt.step(g)
        return loss

    def leaves(self, which):
        return list((self.flat if which == "params" else getattr(self.opt, which)).items())

    def free(self):
        self.tree = self.flat = self.opt = None
        common.free()


def _unflatten(flat):
    tree = {}
    for path, t in flat.items():
        node = tree
        *head, last = path.split("/")
        for k in head:
            node = node.setdefault(k, {})
        node[last] = t
    return tree


def _timed(clock, key, fn):
    common.sync()
    t0 = time.perf_counter()
    out = fn()
    common.sync()
    clock[key] = clock.get(key, 0.0) + time.perf_counter() - t0
    return out


def start(side, feed, t, clock):
    """The start: snapshot, the full steps (the first gradient read from
    AdamW's first moment after the first), and the calibration."""
    rec = {"losses": []}
    _timed(clock, "calibration_s", side.snapshot)
    for i in range(t["calibration_full_steps"]):
        rec["losses"].append(_timed(clock, f"full_step{i}_s", lambda: side.full_step(feed.next())))
        if i == 0:
            rec["first_grad"] = _timed(clock, "check_s", lambda: side.moment_grads()[0])
    rec["rate"], rec["stats"], rec["keep"] = _timed(clock, "calibration_s", side.calibrate)
    return rec


def checked(side, batches, keep, clock):
    """The checked steps from the seed's weights and a zeroed AdamW state:
    each loss, the first one's gradient from AdamW's first moment, the
    dropped units' gradient, and the parameters' change over the steps."""
    _timed(clock, "check_s", side.restart)
    rec = {"losses": [side.masked_step(batches[0])]}
    rec["grad"], rec["dropped_nonzero"] = _timed(
        clock, "check_s", lambda: side.moment_grads(keep))
    for i, b in enumerate(batches[1:]):
        rec["losses"].append(_timed(clock, f"checked_step{i + 1}_s",
                                    lambda: side.masked_step(b)))
    rec["change"] = _timed(clock, "check_s", side.change)
    return rec


def drive(side, feed, t, clock=None):
    """A side's run as the traffic has it: the start, then the checked
    steps through the window's own call and feed, under the side's own
    masks. ``clock`` collects the calibration's seconds and the check's own
    bookkeeping (``check_s``)."""
    clock = clock if clock is not None else {}
    rec = start(side, feed, t, clock)
    batches = [feed.next() for _ in range(t["checked_steps"])]
    if not all(gen.rows_differ(b) for b in batches):
        raise SystemExit("two rows of a checked batch are the same")
    rec["checked"] = checked(side, batches, rec["keep"], clock)
    return rec


def mask_numbers(t, prog, ref_stats):
    """stat_gap: the worst gap between the program's and the reference's
    block statistics, against the layer's median; mask_flip: how far the
    program's kept blocks reach below its dropped ones by the reference's
    statistics (0 when every kept block scores at least every dropped
    one), against the layer's median; mask_errors: layers whose mask is
    not block-granular or keeps another count than round(blocks * rate),
    and a rate other than the traffic's."""
    pb, rb = calibration.block_stats(prog["stats"]), calibration.block_stats(ref_stats)
    keep = prog["keep"].reshape(pb.shape[0], pb.shape[1], calibration.BLOCK)
    granular = (keep.amin(-1) == keep.amax(-1)).all(-1)
    kb = keep[..., 0] > 0
    want = calibration.kept_count(pb.shape[1], t["rate"])
    errors = int((~granular | (kb.sum(-1) != want)).sum()) + int(prog["rate"] != t["rate"])
    stat_gap = flip = 0.0
    for layer in range(rb.shape[0]):
        med = float(rb[layer].median())
        stat_gap = max(stat_gap, float((pb[layer] - rb[layer]).abs().max()) / med)
        if kb[layer].any() and (~kb[layer]).any():
            reach = float(rb[layer][~kb[layer]].max() - rb[layer][kb[layer]].min())
            flip = max(flip, reach / med)
    return {"stat_gap": stat_gap, "mask_flip": max(flip, 0.0), "mask_errors": errors}


def split_norms(norms):
    """(whole leaves, FFN layers) of a side's norms."""
    return ({k: v for k, v in norms.items() if "@" not in k},
            {k: v for k, v in norms.items() if "@" in k})


def common_block_norms(prog_sq, ref_sq, prog_keep, ref_keep):
    """Per FFN layer, each side's norm over the blocks that both sides'
    masks keep: a block kept on one side alone (a near-tie of the two
    sides' statistics) is left out of both."""
    both = ((prog_keep.cpu()[:, ::calibration.BLOCK] > 0)
            & (ref_keep.cpu()[:, ::calibration.BLOCK] > 0))          # (L, blocks)
    norm = lambda sq, k: float(sq[both[int(k.rsplit("@", 1)[1])]].sum()) ** 0.5
    return ({k: norm(v, k) for k, v in prog_sq.items()},
            {k: norm(v, k) for k, v in ref_sq.items()})


def numbers(t, prog, ref):
    """Everything ``correct`` compares, by name."""
    pc, rc = prog["checked"], ref["checked"]
    out = mask_numbers(t, prog, ref["stats"])
    losses = list(zip(prog["losses"] + pc["losses"], ref["losses"] + rc["losses"]))
    out["loss_gap"] = max(abs(a - b) / abs(b) for a, b in losses)
    out["first_grad_gap"] = compare.worst_norm_gap(split_norms(prog["first_grad"])[0],
                                                   split_norms(ref["first_grad"])[0])[0]
    keeps = (prog["keep"], ref["keep"])
    (pg, pf), (rg, rf) = split_norms(pc["grad"]), split_norms(rc["grad"])
    out["grad_gap"] = compare.worst_norm_gap(pg, rg)[0]
    out["ffn_grad_gap"] = compare.worst_norm_gap(*common_block_norms(pf, rf, *keeps))[0]
    med = statistics.median(rg.values())
    moved = [p for p, g in rg.items() if g >= 1e-3 * med]
    (pw, pl), (rw, rl) = split_norms(pc["change"]), split_norms(rc["change"])
    out["change_gap"] = compare.worst_norm_gap(pw, rw, moved)[0]
    out["ffn_change_gap"] = compare.worst_norm_gap(*common_block_norms(pl, rl, *keeps))[0]
    out["dropped_nonzero"] = pc["dropped_nonzero"]
    return out


def details(prog, ref):
    """Where the gaps sit: each step's loss gap, the leaves with the widest
    gaps, and the blocks whose keep differs between the two sides' masks."""
    def top(a, b):
        gaps = {p: abs(a[p] - b[p]) / b[p] for p in b if "@" not in p and b[p]}
        return sorted(((round(g, 6), p) for p, g in gaps.items()), reverse=True)[:3]
    pc, rc = prog["checked"], ref["checked"]
    differ = (prog["keep"].cpu()[:, ::calibration.BLOCK] != ref["keep"].cpu()[:, ::calibration.BLOCK])
    return {"loss_gaps": [abs(a - b) / abs(b) for a, b in
                          zip(prog["losses"] + pc["losses"], ref["losses"] + rc["losses"])],
            "first_grad_leaves": top(prog["first_grad"], ref["first_grad"]),
            "grad_leaves": top(pc["grad"], rc["grad"]),
            "change_leaves": top(pc["change"], rc["change"]),
            "mask_blocks_differ": int(differ.sum())}


def kept_units(keep):
    return [int(x) for x in (keep > 0).sum(-1)]


def run(w, c, t, seed, seconds, trace, setup_clock, device="cuda"):
    device = torch.device(device)
    clock = {}
    t0 = time.perf_counter()
    side = ProgramSide(c, t, seed, device)
    common.sync()
    common.log(f"weights and AdamW state {time.perf_counter() - t0:.2f} s")
    feed = gen.TrainFeed(t, seed, device)
    prog = drive(side, feed, t, clock)
    common.log(f"set-up steps {time.perf_counter() - t0:.2f} s, clock {clock}")
    tokens_a_step = t["batch"] * t["seq"]
    ends = []
    with common.Window(trace) as win:
        while time.perf_counter() - win.t0 < seconds:
            with win.span("feed"):
                b = feed.next()
            with win.span("step"):
                side.masked_step(b)
            ends.append(time.perf_counter())
    peak = common.peak_bytes(device)
    setup_s = setup_clock(win.t0) - clock.get("check_s", 0.0)
    common.log(f"window {len(ends)} steps in {ends[-1] - win.t0:.3f} s, peak {peak}")
    t1 = time.perf_counter()
    tr = win.read_trace()
    common.log(f"trace read {time.perf_counter() - t1:.2f} s")
    side.free()
    t1 = time.perf_counter()
    ref = ReferenceSide(c, t, seed, device)
    r = drive(ref, gen.TrainFeed(t, seed, device), t)
    ref.free()
    common.log(f"reference {time.perf_counter() - t1:.2f} s")
    nums = numbers(t, prog, r)
    common.log(f"where the gaps sit: {details(prog, r)}")
    ok, rows = compare.judge(nums, compare.limits(w["name"]))
    kept = kept_units(prog["keep"])
    step_flops = counts.train_step_flops(c, kept, t["batch"], t["seq"])
    return common.result(
        kind="train", c=c, t=t, correct=ok, rows=rows, attempted=len(ends), failed=0,
        setup_s=setup_s, window_s=ends[-1] - win.t0, tokens=len(ends) * tokens_a_step,
        steps=len(ends), flops=len(ends) * step_flops, step_flops=step_flops,
        peak_bytes=peak, trace=tr, calibration_s=clock["calibration_s"],
        kept_blocks=[k // counts.BLOCK for k in kept], rows_m=tokens_a_step)
