"""Plain AdamW, as the configuration file states it: m and v in float32,
bias corrections from the step count, the update lr * m_hat / (sqrt(v_hat)
+ eps) plus weight decay times the weight."""
from __future__ import annotations

import torch


class AdamW:
    def __init__(self, params: dict, opt: dict):
        self.params = params            # {path: float32 tensor}, updated in place
        self.o = opt
        self.t = 0
        self.m = {k: torch.zeros_like(p) for k, p in params.items()}
        self.v = {k: torch.zeros_like(p) for k, p in params.items()}

    @torch.no_grad()
    def step(self, grads: dict):
        o = self.o
        self.t += 1
        bc1, bc2 = 1 - o["b1"] ** self.t, 1 - o["b2"] ** self.t
        for k, p in self.params.items():
            g = grads[k]
            self.m[k].mul_(o["b1"]).add_(g, alpha=1 - o["b1"])
            self.v[k].mul_(o["b2"]).addcmul_(g, g, value=1 - o["b2"])
            upd = (self.m[k] / bc1) / ((self.v[k] / bc2).sqrt() + o["eps"])
            if o["weight_decay"]:
                upd = upd + o["weight_decay"] * p
            p.sub_(o["learning_rate"] * upd)
