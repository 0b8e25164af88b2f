"""Sub-model neuron-selection policies: Random / Ordered / Invariant.

Port of ``repro/core/dropout.py`` (numpy, as the reference): the same seed
and the same observed stats give the same keep-maps bit for bit. Every
policy maps (group, rate r) -> kept-neuron index array, r in (0, 1] being
the *kept* fraction. Policies are resolved by name through a registry
(``get_policy`` / ``register_policy``).

Invariant selection (paper §4/§5): drop the neurons most agreed-invariant by
the non-straggler majority — ranked by (majority vote count, then lowest
historical update magnitude) — never dropping more than the target count.
An EMA of stats across calibration steps implements the paper's
"consistently fall below the threshold over multiple epochs" preference.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Dict, Optional, Sequence, Type

import numpy as np

from repro_torch.core import invariant as inv


def keep_count(size: int, r: float, minimum: int = 1) -> int:
    return max(minimum, int(round(size * r)))


def random_keep(rng: np.random.RandomState, size: int, r: float) -> np.ndarray:
    k = keep_count(size, r)
    return np.sort(rng.choice(size, size=k, replace=False))


def ordered_keep(size: int, r: float) -> np.ndarray:
    """FjORD Ordered Dropout: keep the left-most k neurons."""
    return np.arange(keep_count(size, r))


def invariant_keep(votes: np.ndarray, stats: np.ndarray, r: float
                   ) -> np.ndarray:
    """votes: (#clients flagging invariant) per neuron; stats: mean update."""
    size = votes.shape[0]
    n_drop = size - keep_count(size, r)
    # drop order: most votes first, then smallest mean update
    dropped = np.lexsort((stats, -votes))[:n_drop]
    return np.sort(np.setdiff1d(np.arange(size), dropped))


# ---------------------------------------------------------------------------
# policy registry

_REGISTRY: Dict[str, Type["BasePolicy"]] = {}


def register_policy(name: str):
    """Class decorator: make a BasePolicy subclass resolvable by name."""
    def deco(cls):
        cls.method = name
        _REGISTRY[name] = cls
        return cls
    return deco


def available_policies() -> tuple:
    return tuple(sorted(_REGISTRY))


def get_policy(name: str, unit_specs: Sequence[dict], seed: int = 0,
               **kw) -> "BasePolicy":
    """Instantiate a registered policy; extra kwargs are filtered to the
    policy's own fields (e.g. ema_decay only applies to 'invariant')."""
    try:
        cls = _REGISTRY[name]
    except KeyError:
        raise ValueError(f"unknown dropout policy {name!r}; "
                         f"available: {available_policies()}") from None
    names = {f.name for f in dataclasses.fields(cls)}
    return cls(unit_specs=unit_specs, seed=seed,
               **{k: v for k, v in kw.items() if k in names})


@dataclass
class BasePolicy:
    """Stateful selector over unit-spec'd neuron groups."""
    unit_specs: Sequence[dict]
    seed: int = 0
    _rng: np.random.RandomState = field(init=False, repr=False)

    def __post_init__(self):
        self._rng = np.random.RandomState(self.seed)

    def observe(self, per_client_stats, th: float):
        """Feed this calibration step's non-straggler stats (no-op unless the
        policy is history-driven)."""

    def keep(self, name: str, size: int, r: float) -> np.ndarray:
        raise NotImplementedError

    def keep_map(self, r: float) -> Dict[str, np.ndarray]:
        """Kept indices per group for sub-model size r."""
        return {g["name"]: (np.arange(g["size"]) if r >= 1.0
                            else self.keep(g["name"], g["size"], r))
                for g in self.unit_specs}


@register_policy("random")
@dataclass
class RandomPolicy(BasePolicy):
    def keep(self, name, size, r):
        return random_keep(self._rng, size, r)


@register_policy("ordered")
@dataclass
class OrderedPolicy(BasePolicy):
    def keep(self, name, size, r):
        return ordered_keep(size, r)


@register_policy("invariant")
@dataclass
class InvariantPolicy(BasePolicy):
    ema_decay: float = 0.5
    _ema_stats: Optional[Dict[str, np.ndarray]] = field(default=None,
                                                        repr=False)
    _votes: Optional[Dict[str, np.ndarray]] = field(default=None, repr=False)

    def observe(self, per_client_stats, th: float):
        votes = inv.invariant_counts(per_client_stats, th)
        means = inv.mean_stats(per_client_stats)
        if self._ema_stats is None:
            self._ema_stats, self._votes = means, {
                k: v.astype(np.float64) for k, v in votes.items()}
        else:
            a = self.ema_decay
            self._ema_stats = {k: a * self._ema_stats[k] + (1 - a) * means[k]
                               for k in means}
            self._votes = {k: a * self._votes[k] + (1 - a) * votes[k]
                           for k in votes}

    def keep(self, name, size, r):
        if self._votes is None:       # no stats yet: fall back to ordered
            return ordered_keep(size, r)
        return invariant_keep(self._votes[name], self._ema_stats[name], r)


def DropoutPolicy(method: str, unit_specs: Sequence[dict], seed: int = 0,
                  **kw) -> BasePolicy:
    """Constructor-shaped alias for get_policy()."""
    return get_policy(method, unit_specs, seed=seed, **kw)
