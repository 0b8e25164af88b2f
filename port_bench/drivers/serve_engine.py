"""Driver of a serving cell: per-client sub-model serving through the
program's ``ServeEngine``.

Set-up makes the weights from the seed in the served type, builds the engine
and the cohort's keep-masks, and warms up the one prefill shape (every prompt
is padded to max_prompt_len) and the one decode shape (all slots) with two
requests, a straggler's and the full model's. The window sends a fixed
number of whole waves (``traffic.waves``): one request a client, all
submitted at once and drained by ``run()``; the rates divide by the time
from the first submit to the last return.

``correct``: once the window has closed and the engine is freed, a sample of
the finished requests drawn from the seed, the longest among them, goes
through the plain reference (``reference/decoder.py``, float32) layer by
layer, each layer's weights made again from the seed: the prompt and the
served tokens, under the client's mask. Compared: the widest gap by which a
served token's logit lies below the reference's best, and every request
answered with its length of in-vocabulary tokens.
"""
from __future__ import annotations

import contextlib
import time

import numpy as np
import torch

from drivers import common
from harness import compare, counts, traffic as gen, weights
from reference import decoder


def _spanned(span, name, fn):
    def call(*a, **kw):
        with span(name):
            return fn(*a, **kw)
    return call


def _blocks(keep, c):
    """(L, blocks) bool of a client's kept blocks (all for the full model)."""
    L, nb = c["num_hidden_layers"], c["intermediate_size"] // counts.BLOCK
    if keep is None:
        return np.ones((L, nb), bool)
    return keep.numpy().reshape(L, nb, counts.BLOCK).max(-1) > 0


def build(c, t, seed, device):
    """The engine over the seed's weights and the cohort's masks (None for
    the full model); warmed up on the prefill shape and a chunk at every
    slot (a straggler's request and the full model's), and with every
    straggler's mask in the bank."""
    from repro_torch.launch.serving import ServeEngine, ServeRequest
    cfg = common.program_config(c)
    params = weights.make_params(c, seed, device)
    common.check_layout(params, cfg, weights.DTYPES[c["weight_dtype"]])
    engine = ServeEngine(cfg, params, batch_size=t["slots"], max_prompt_len=t["max_prompt_len"],
                         max_gen_len=t["max_gen_len"], chunk=t["chunk"],
                         bank_size=t["bank_size"], device=device)
    clients = gen.cohort(t, c, seed)
    masks = {k: None if keep is None else [{"l0": {"ffn": keep}}] for k, _, keep in clients}
    rng = np.random.RandomState(seed % (1 << 32))
    prompt = lambda: rng.randint(0, c["vocab_size"], t["max_prompt_len"])
    for k in (len(clients) - 1, 0):
        engine.submit(ServeRequest(tokens=prompt(), gen_len=t["chunk"] + 1, masks=masks[k]))
    # every sub-model of the cohort enters the mask bank now, as a deployment's
    # bank holds its clients' masks, so that no wave restacks the bank
    for k, _, keep in clients:
        if keep is not None:
            engine.submit(ServeRequest(tokens=prompt(), gen_len=1, masks=masks[k]))
    engine.run()
    common.sync()
    return engine, clients, masks


def send_wave(engine, c, t, seed, number, masks, span=None):
    """One wave, submitted at once and drained (inside ``span("run")``);
    its requests as dicts."""
    from repro_torch.launch.serving import ServeRequest
    sent = {}
    for client, prompt, g in gen.wave(t, c, seed, number):
        req = ServeRequest(tokens=prompt, gen_len=g, masks=masks[client])
        req.client = client
        sent[engine.submit(req)] = (client, prompt, g)
    with span("run") if span else contextlib.nullcontext():
        out = engine.run()
    return [{"client": k, "prompt": p, "gen_len": g, "out": out.get(rid)}
            for rid, (k, p, g) in sent.items()]


def answered(c, finished):
    """Marks each request ok when it came back with its length of
    in-vocabulary tokens."""
    for f in finished:
        f["ok"] = (f["out"] is not None and len(f["out"]) == f["gen_len"]
                   and bool(((f["out"] >= 0) & (f["out"] < c["vocab_size"])).all()))
    return [f for f in finished if f["ok"]]


def run(w, c, t, seed, seconds, trace, setup_clock, device="cuda"):
    device = torch.device(device)
    t0 = time.perf_counter()
    engine, clients, masks = build(c, t, seed, device)
    common.log(f"weights, engine and warm-up {time.perf_counter() - t0:.2f} s")
    blocks = {k: _blocks(keep, c) for k, _, keep in clients}
    chunk_unions = []
    decode = engine._decode_chunk

    def decode_chunk():
        live = [blocks[st["req"].client] for st in engine.live.values()]
        chunk_unions.append((engine.chunk, np.logical_or.reduce(live).sum(-1).tolist()))
        return decode()
    win = common.Window(trace)
    engine._decode_chunk = _spanned(win.span, "decode_chunk", decode_chunk)
    engine._admit = _spanned(win.span, "admit", engine._admit)
    before = dict(engine.stats)

    finished, wave_s = [], []
    number = gen.waves(t, seconds)
    with win:
        for i in range(number):
            w0 = time.perf_counter()
            finished += send_wave(engine, c, t, seed, i, masks, win.span)
            wave_s.append(round(time.perf_counter() - w0, 3))
        t_end = time.perf_counter()
    peak = common.peak_bytes(device)
    setup_s = setup_clock(win.t0)
    common.log(f"window {number} waves ({wave_s} s), {len(finished)} requests in "
               f"{t_end - win.t0:.3f} s, peak {peak}")
    t1 = time.perf_counter()
    tr = win.read_trace()
    common.log(f"trace read {time.perf_counter() - t1:.2f} s")
    stats = {k: engine.stats[k] - before[k] for k in before}
    engine.params = engine.caches = engine.bank = engine = decode = None
    common.free()

    good = answered(c, finished)
    keeps = {k: keep for k, _, keep in clients}
    picked = gen.sample(seed, good, t["check_requests"]) if good else []
    nums = {"unanswered": len(finished) - len(good), "logit_gap": float("inf")}
    if picked:
        t1 = time.perf_counter()
        ref = reference_logits(c, seed, picked, keeps, device)
        nums["logit_gap"] = served_gap(ref, picked)
        common.log(f"reference over {len(picked)} requests, {ref.shape[0]} served tokens "
                   f"{time.perf_counter() - t1:.2f} s")
    ok, rows = compare.judge(nums, compare.limits(w["name"]))
    kept = {k: [int(x) * counts.BLOCK for x in b.sum(-1)] for k, b in blocks.items()}
    flops = sum(counts.serve_request_flops(c, kept[f["client"]], len(f["prompt"]), f["gen_len"])
                for f in good)
    return common.result(
        kind="serve", c=c, t=t, correct=ok, rows=rows, attempted=len(finished),
        failed=len(finished) - len(good), setup_s=setup_s, window_s=t_end - win.t0,
        tokens=sum(f["gen_len"] for f in good), flops=flops, peak_bytes=peak, trace=tr,
        stats=stats, decode_steps=stats["decode_steps"], chunk_unions=chunk_unions)


def sequences(picked):
    """(tokens (N, S) int64 right-padded, [(row, first, last)]): each
    request's prompt and its served tokens but the last; the positions
    first..last-1 predict the served tokens."""
    rows = [np.concatenate([f["prompt"], np.asarray(f["out"][:-1], np.int64)]) for f in picked]
    S = max(len(r) for r in rows)
    toks = np.zeros((len(rows), S), np.int64)
    spans = []
    for i, (r, f) in enumerate(zip(rows, picked)):
        toks[i, :len(r)] = r
        spans.append((i, len(f["prompt"]) - 1, len(r)))
    return toks, spans


def reference_logits(c, seed, picked, keeps, device, precision="fp32"):
    """The reference's logits (n served tokens, vocab) at every position
    that predicted a served token, in the order of ``picked``. The layers'
    weights are made again from the seed, one layer at a time."""
    toks, spans = sequences(picked)
    tokens = torch.from_numpy(toks).to(device)
    L, F = c["num_hidden_layers"], c["intermediate_size"]
    keep = torch.stack([torch.ones(L, F) if keeps[f["client"]] is None else keeps[f["client"]]
                        for f in picked]).to(device) > 0                  # (N, L, F)
    dt = weights.DTYPES[c["weight_dtype"]]
    with torch.no_grad(), decoder.exact_fp32():
        embed = weights.matrix(c, seed, "tok/embed", 0, device, dt)
        x = embed[tokens].float()
        del embed
        for r in range(L):
            x = decoder.block(weights.layer(c, seed, r, device, dt), x, c, keep[:, r],
                              precision)
        x = decoder.norm(weights.norm(c, device), x, c)
        xs = torch.cat([x[i, a:b] for i, a, b in spans])
        del x
        head = weights.matrix(c, seed, "tok/lm_head", 0, device, dt)
        out = torch.cat([decoder.mm(xs, part.float(), precision)
                         for part in head.split(32768, dim=1)], dim=1)
    return out


def served_tokens(picked, device):
    return torch.from_numpy(np.concatenate([np.asarray(f["out"], np.int64)
                                            for f in picked])).to(device)


def token_gap(ref_logits, tokens):
    """The widest gap by which a token's reference logit lies below the
    reference's best at its position."""
    best = ref_logits.max(-1).values
    return float((best - ref_logits.gather(1, tokens[:, None])[:, 0]).max())


def served_gap(ref_logits, picked):
    return token_gap(ref_logits, served_tokens(picked, ref_logits.device))
