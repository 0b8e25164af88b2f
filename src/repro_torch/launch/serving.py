"""Personalized sub-model serving (port of ``repro/launch/serving.py``).

Every request carries a 0/1 keep-mask over FFN hidden units. Masks are
deduplicated into a fixed-capacity ``core.maskbank.MaskBank`` (row 0 is
the full model) and each batch slot holds an int row index into it, so a
batch mixes dropout rates without changing any shape.

Continuous batching at chunk granularity: between chunks the host retires
finished slots and admits queued requests (batch-1 right-padded prefill +
cache splice into the slot); a chunk is a Python loop of ``chunk`` greedy
decode steps over the whole slot batch with one host sync at its end. On
the card every decode layer with a dense FFN runs the masked-FFN kernel
(per-slot masks), every full (unwindowed) GQA attention decode layer the
GQA flash-decode kernel, and every RWKV-6 layer of a prefill the chunked
WKV kernel; MLA, local attention and RG-LRU are plain torch, as they are
plain jnp in the reference. Right padding is exact for attention: a padded
position's K/V slot lies past the row's attended prefix until decode
overwrites it. A recurrent mixer would fold padding into its state, so a
recurrent engine (RWKV-6, RG-LRU) takes prompts of exactly
``max_prompt_len`` tokens.

Masking the FFN hidden activation equals serving the extracted sub-model
(act(0) = 0 for every supported activation): ``apply_masks_to_params`` is
that reference.

Spans (``repro_torch.tracing``, when recording is on): per request
``serve.request`` (submit until its tokens are in the results) and
``serve.queued`` (submit until its admission starts), each with ``rid``;
``serve.admit`` (``rid``) around an admission, holding ``serve.bank_row``,
``serve.prefill`` and ``serve.insert``; ``serve.decode_chunk`` around a
chunk, holding ``serve.chunk_issue`` (the copies to the device until every
launch of ``_decode_program`` is enqueued) and ``serve.chunk_sync`` (the
host reads at its end); ``serve.retire`` around the bookkeeping after it.
``stats["prefill_s"]`` and ``stats["decode_s"]`` sum the durations of
``serve.prefill`` and ``serve.decode_chunk``, clocked whether recording is
on or off.
"""
from __future__ import annotations

from collections import deque
from dataclasses import dataclass, field
from typing import Dict, Optional

import numpy as np
import torch

from repro_torch import tracing
from repro_torch.configs.base import ModelConfig
from repro_torch.core import transformer_hooks as hooks
from repro_torch.core.dropout import keep_count
from repro_torch.core.maskbank import FULL_MODEL, MaskBank
from repro_torch.core.tree import tree_leaves, tree_map
from repro_torch.kernels import ops
from repro_torch.models import model as model_lib
from repro_torch.models import transformer


SERVE_KERNELS = ("masked_ffn_batch", "decode_gqa", "rwkv_chunk_scan")   # ops.LAUNCHES keys


# ---------------------------------------------------------------------------
# mask construction helpers

def rate_masks(cfg: ModelConfig, r: float, policy: str = "ordered",
               seed: int = 0):
    """Per-segment FFN keep-mask pytree for sub-model size r (1.0 = full),
    host float32 tensors. 'ordered' keeps the leading k units per layer;
    'random' draws k units per (layer, repeat) from
    ``np.random.RandomState(seed)``, bit for bit as the reference does."""
    base = hooks.full_masks(cfg)
    if r >= 1.0:
        return base
    rng = np.random.RandomState(seed)
    out = []
    for seg in base:
        unit = {}
        for lname, entry in seg.items():
            m = {}
            for key, ones in entry.items():
                shape = tuple(ones.shape)
                f = shape[-1]
                k = keep_count(f, r)
                mask = np.zeros(shape, np.float32)
                if policy == "random":
                    flat = mask.reshape(-1, f)
                    for row in range(flat.shape[0]):
                        flat[row, rng.choice(f, size=k, replace=False)] = 1.0
                else:
                    mask[..., :k] = 1.0
                m[key] = torch.from_numpy(mask)
            unit[lname] = m
        out.append(unit)
    return out


def masks_from_keep_map(cfg: ModelConfig, keep_map: Dict[str, np.ndarray]):
    """FL bridge: {'seg<si>/l<i>/ffn': kept indices} (or the flat
    {'l<i>': ...} of single-segment models) -> the serving mask pytree."""
    base = hooks.full_masks(cfg)
    out = []
    for si, seg in enumerate(base):
        unit = {}
        for lname, entry in seg.items():
            m = {}
            for key, ones in entry.items():
                kept = keep_map.get(f"seg{si}/{lname}/{key}",
                                    keep_map.get(lname))
                if kept is None:
                    m[key] = ones
                else:
                    mask = np.zeros(tuple(ones.shape), np.float32)
                    mask[..., np.asarray(kept, np.int64)] = 1.0
                    m[key] = torch.from_numpy(mask)
            unit[lname] = m
        out.append(unit)
    return out


def mask_fingerprint(masks) -> object:
    if masks is None:
        return FULL_MODEL
    return tuple(np.asarray(torch.as_tensor(leaf).cpu()).tobytes()
                 for leaf in tree_leaves(masks))


def apply_masks_to_params(params, masks, cfg: ModelConfig):
    """Reference sub-model: the FFN masks baked into the weights (dropped
    units' in-columns, biases and out-rows zeroed). ``forward(masked
    params)`` equals the engine's activation-masked decode token for token:
    the parity oracle for tests, not a serving path."""
    new = tree_map(lambda x: x, params)          # fresh dicts, shared tensors
    for si, seg in enumerate(transformer.build_segments(cfg)):
        seg_p = new["stack"][f"seg{si}"]
        for i, (mixer, ffn) in enumerate(seg.unit):
            entry = masks[si].get(f"l{i}", {})
            if "ffn" not in entry or ffn not in ("dense", "cmix"):
                continue
            fp = seg_p[f"l{i}"]["ffn" if ffn == "dense" else "cmix"]
            m = torch.as_tensor(entry["ffn"]).to(fp["w_out"].device)   # (R, f)
            for w in ("w_in", "w_gate"):
                if w in fp:
                    fp[w] = fp[w] * m[:, None, :].to(fp[w].dtype)
            for b in ("b_in", "b_gate"):
                if b in fp:
                    fp[b] = fp[b] * m.to(fp[b].dtype)
            fp["w_out"] = fp["w_out"] * m[:, :, None].to(fp["w_out"].dtype)
    return new


# ---------------------------------------------------------------------------
# requests

@dataclass
class ServeRequest:
    """One generation request: prompt tokens + its personal sub-model.
    masks=None serves the full model (mask-bank row 0)."""
    tokens: np.ndarray                 # (L,) int prompt
    gen_len: int = 16
    masks: Optional[object] = None     # rate_masks()-shaped pytree or None
    rid: int = field(default=-1)       # assigned by ServeEngine.submit

    def fingerprint(self):
        return mask_fingerprint(self.masks)


# ---------------------------------------------------------------------------
# engine

class ServeEngine:
    """Continuous-batching greedy decoder over personalized sub-models.
    ``mla_absorb`` decodes MLA layers in latent space, as the reference's.

    ``device`` defaults to "cuda" and raises when no card is present; the
    CPU is used only when the caller passes device="cpu"."""

    def __init__(self, cfg: ModelConfig, params, *, batch_size: int = 4,
                 max_prompt_len: int = 16, max_gen_len: int = 16,
                 chunk: int = 8, bank_size: int = 8, mla_absorb: bool = False,
                 device="cuda"):
        if cfg.is_encdec:
            raise NotImplementedError(
                "ServeEngine covers decoder-only stacks; encoder-decoder "
                "serving still goes through launch.serve.serve()")
        if cfg.n_experts:
            raise ValueError(
                f"ServeEngine does not serve the MoE model {cfg.name}: its "
                "per-slot (B, 1, f) FFN masks are not the (E, f) expert-unit "
                "mask moe.apply_moe takes, and the reference's engine fails "
                "on them; serve MoE models through launch.serve.serve()")
        self.device = torch.device(device)
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError("ServeEngine(device='cuda') needs a CUDA "
                               "device; pass device='cpu' to run on the CPU")
        self.cfg = cfg
        self.params = params
        self.mla_absorb = mla_absorb
        self.recurrent = any(mixer in ("rglru", "rwkv")
                             for seg in transformer.build_segments(cfg)
                             for mixer, _ in seg.unit)
        self.B = batch_size
        self.max_prompt_len = max_prompt_len
        self.max_gen_len = max_gen_len
        self.chunk = min(chunk, max_gen_len) if max_gen_len > 1 else 1
        # cache headroom: decode runs in whole chunks, so a slot can write up
        # to chunk-ceil(gen_len-1) positions past its prompt; sizing for the
        # worst case keeps slot == position (the ring never wraps)
        n_chunks = -(-(max_gen_len - 1) // self.chunk) if max_gen_len > 1 else 0
        self.cache_len = max_prompt_len + max(n_chunks, 1) * self.chunk
        self.bank = MaskBank(hooks.full_masks(cfg), capacity=bank_size,
                             device=self.device)

        self.caches = model_lib.init_caches(cfg, self.B, self.cache_len,
                                            self.device)
        self.tok = np.zeros((self.B, 1), np.int64)
        self.pos = np.zeros((self.B,), np.int64)
        self.row = np.zeros((self.B,), np.int64)
        self.queue: deque = deque()
        self.live: Dict[int, dict] = {}
        self._next_rid = 0
        self._spans: Dict[int, tuple] = {}     # rid -> (request, queued) tokens
        self.stats = {"prefills": 0, "chunks": 0, "decode_steps": 0,
                      "decode_tokens": 0, "decode_s": 0.0, "prefill_s": 0.0}

    # ------------------------------------------------------------- steps
    def _prefill(self, tokens, length: int, row: int):
        masks = tree_map(lambda b: b[row][:, None, None], self.bank.stacked())
        logits, caches, _ = model_lib.forward_seq(
            self.params, self.cfg, {"tokens": tokens}, masks=masks,
            want_cache=True, cache_len=self.cache_len)
        return int(torch.argmax(logits[0, length - 1])), caches

    def _insert(self, new, slot: int):
        """Splice a batch-1 prefill cache into ``slot``: every leaf has the
        batch axis second, (R, 1, ...) — K/V (R, 1, C, KV, hd), and the
        RWKV state S (R, 1, H, N, N) and token shifts (R, 1, d), MLA's
        c_kv and k_rope (R, 1, C, ·), RG-LRU's h (R, 1, w) and conv history
        (R, 1, K-1, w)."""
        tree_map(lambda c, n: c[:, slot].copy_(n[:, 0]), self.caches, new)

    def _decode_chunk(self):
        """``chunk`` greedy steps over every slot: the slots' rows, tokens
        and positions go to the device, ``_decode_program`` runs there, and
        its tokens and positions come back in one host sync at the end."""
        with tracing.span("serve.chunk_issue"):
            toks, pos = self._decode_program(
                *(torch.from_numpy(a).to(self.device) for a in (self.row, self.tok, self.pos)))
        self.stats["decode_steps"] += self.chunk
        with tracing.span("serve.chunk_sync"):
            return toks.cpu().numpy(), pos.cpu().numpy()

    def _decode_program(self, idx, tok, pos):
        """The chunk's device program (the reference's jitted chunk): from
        the slots' bank rows ``idx``, last tokens and positions, ``chunk``
        greedy steps; returns (tokens (B, chunk), next positions (B,)) on
        the device, with no host sync."""
        # bank leaf (K, R, f) -> per-slot (R, B, 1, f): layer r sees (B, 1, f)
        masks = tree_map(
            lambda b: b[idx].transpose(0, 1)[:, :, None].contiguous(),
            self.bank.stacked())
        toks = []
        for _ in range(self.chunk):
            logits, _ = model_lib.decode_step(self.params, self.cfg,
                                              self.caches, tok, pos,
                                              masks=masks,
                                              mla_absorb=self.mla_absorb)
            tok = torch.argmax(logits[:, -1], -1)[:, None]
            toks.append(tok)
            pos = pos + 1
        return torch.cat(toks, 1), pos

    # ------------------------------------------------------------------ API
    def submit(self, req: ServeRequest) -> int:
        L = len(req.tokens)
        if L > self.max_prompt_len or L < 1:
            raise ValueError(f"prompt length {L} outside "
                             f"[1, {self.max_prompt_len}]")
        if self.recurrent and L != self.max_prompt_len:
            raise ValueError(
                "recurrent mixers (rwkv/rg-lru) fold right-padding into "
                f"their state: prompts must be exactly {self.max_prompt_len}"
                " tokens for this architecture")
        if not 1 <= req.gen_len <= self.max_gen_len:
            raise ValueError(f"gen_len {req.gen_len} outside "
                             f"[1, {self.max_gen_len}]")
        req.rid = self._next_rid
        self._next_rid += 1
        if tracing.enabled():
            self._spans[req.rid] = (tracing.begin("serve.request", rid=req.rid),
                                    tracing.begin("serve.queued", rid=req.rid))
        self.queue.append(req)
        return req.rid

    def _finish(self, results, rid: int, out: np.ndarray):
        results[rid] = out
        tracing.end(self._spans.pop(rid, (None,))[0])

    def _admit(self, slot: int, req: ServeRequest):
        tracing.end(self._spans.get(req.rid, (None, None))[1])
        with tracing.span("serve.admit", rid=req.rid):
            with tracing.span("serve.bank_row"):
                in_use = [s["row"] for s in self.live.values()]
                row = self.bank.row_for(req.fingerprint(), lambda: req.masks,
                                        in_use=in_use)
            L = len(req.tokens)
            toks = np.zeros((1, self.max_prompt_len), np.int64)
            toks[0, :L] = np.asarray(req.tokens, np.int64)
            with tracing.timed("serve.prefill") as t:
                first, cache1 = self._prefill(torch.from_numpy(toks).to(self.device),
                                              L, row)
            self.stats["prefill_s"] += t.seconds
            self.stats["prefills"] += 1
            state = {"req": req, "row": row, "out": [first],
                     "remaining": req.gen_len - 1}
            if state["remaining"] > 0:
                with tracing.span("serve.insert"):
                    self._insert(cache1, slot)
                self.tok[slot, 0] = first
                self.pos[slot] = L
                self.row[slot] = row
                self.live[slot] = state
                return None
            return np.asarray(state["out"], np.int32)     # gen_len == 1

    def run(self) -> Dict[int, np.ndarray]:
        """Drain the queue; returns {rid: generated tokens (gen_len,)}."""
        results: Dict[int, np.ndarray] = {}
        while self.queue or self.live:
            free = [s for s in range(self.B) if s not in self.live]
            while self.queue and free:
                req = self.queue.popleft()
                done = self._admit(free[0], req)
                if done is not None:
                    self._finish(results, req.rid, done)
                else:
                    free.pop(0)
            if not self.live:
                continue
            with tracing.timed("serve.decode_chunk") as t:
                toks, pos = self._decode_chunk()
            self.stats["decode_s"] += t.seconds
            with tracing.span("serve.retire"):
                self._retire(results, toks, pos)
        return results

    def _retire(self, results, toks, pos):
        """After a chunk: each live slot takes its tokens, finished requests
        go into ``results``, and free slots are parked."""
        self.stats["chunks"] += 1
        self.tok[:, 0] = toks[:, -1]
        self.pos[:] = pos
        for slot in list(self.live):
            st = self.live[slot]
            take = min(self.chunk, st["remaining"])
            st["out"].extend(toks[slot, :take].tolist())
            st["remaining"] -= take
            self.stats["decode_tokens"] += take
            if st["remaining"] == 0:
                self._finish(results, st["req"].rid, np.asarray(st["out"], np.int32))
                del self.live[slot]
        # park retired/empty slots at position 0 so their (discarded)
        # decode activity never ring-wraps the cache
        for s in range(self.B):
            if s not in self.live:
                self.pos[s] = 0
                self.tok[s, 0] = 0
                self.row[s] = 0

    def summary(self) -> dict:
        """Counters of the run, and the serving kernels' launch counts
        (process-wide counters: reset them with ops.reset_launch_counts())."""
        d = dict(self.stats)
        d["tok_per_s"] = d["decode_tokens"] / max(d["decode_s"], 1e-9)
        counts = ops.launch_counts()
        d["kernel_launches"] = {k: counts[k] for k in SERVE_KERNELS}
        return d
