"""Deterministic host-side sampling for decode streams (counterpart of
``mxnet_tpu/serving/decode/sampling.py``, the same code).

Temperature / top-k / top-p act on the logits the engine already fetched
for the step, entirely in float64 numpy on the host — never inside the
captured graphs — so turning sampling on cannot change a single captured
signature, and the greedy path (temperature 0) stays bit-identical to the
pre-sampling engine.  Given the same logits rows, both packages draw the
same tokens.

Determinism contract (what makes chaos runs and the sequential oracle
replayable):

* every sampled stream owns a private ``np.random.RandomState(seed)``;
  one uniform draw per emitted token, nothing else touches it;
* an explicit ``seed`` makes the stream a pure function of
  (params, prompt, sampling options): the same submission replays the
  same tokens on a fresh engine, a restarted engine, or the sequential
  ``generate_reference`` oracle;
* ``seed=None`` derives one from the framework stream
  (``random.derived_numpy_rng()``, whose keys are the JAX package's) —
  reproducible under ``mx.random.seed(n)``, the same seed as the JAX
  package derives, and recorded on the stream so the draw sequence is
  still replayable after the fact;
* tie-breaks are pinned: candidate order comes from a *stable* descending
  sort, the inverse-CDF walk uses ``searchsorted`` on a float64 cumsum —
  no platform-dependent argmax/argsort ambiguity;
* handoff snapshots carry ``(seed, draws)``; the importer rebuilds the
  RandomState and burns ``draws`` uniforms, so a migrated stream
  continues the exact draw sequence it would have used uninterrupted.
"""
from __future__ import annotations

import numpy as np

__all__ = ["SamplingParams", "StreamSampler", "resolve_seed"]


class SamplingParams:
    """Validated per-stream sampling options.

    ``temperature == 0`` means greedy (argmax); ``top_k == 0`` and
    ``top_p == 1`` disable their filters.  Raises ``ValueError`` on
    out-of-range values — the engine maps that to INVALID_INPUT.
    """

    __slots__ = ("temperature", "top_k", "top_p", "seed")

    def __init__(self, temperature=0.0, top_k=0, top_p=1.0, seed=None):
        temperature = float(temperature)
        top_k = int(top_k)
        top_p = float(top_p)
        if not temperature >= 0.0:
            raise ValueError("temperature must be >= 0, got %r"
                             % (temperature,))
        if top_k < 0:
            raise ValueError("top_k must be >= 0, got %r" % (top_k,))
        if not 0.0 < top_p <= 1.0:
            raise ValueError("top_p must be in (0, 1], got %r" % (top_p,))
        if seed is not None:
            seed = int(seed)
            if not 0 <= seed < 2 ** 31:
                raise ValueError("seed must be in [0, 2**31), got %r"
                                 % (seed,))
        self.temperature = temperature
        self.top_k = top_k
        self.top_p = top_p
        self.seed = seed

    @property
    def greedy(self):
        return self.temperature == 0.0

    def as_dict(self):
        return {"temperature": self.temperature, "top_k": self.top_k,
                "top_p": self.top_p, "seed": self.seed}


def resolve_seed(params):
    """The stream's effective seed: the explicit one, or a fresh derivation
    from the framework RNG (reproducible under ``mx.random.seed``)."""
    if params.seed is not None:
        return int(params.seed)
    from ... import random as _random
    return int(_random.derived_numpy_rng().randint(0, 2 ** 31 - 1))


class StreamSampler:
    """Per-stream deterministic sampler: one uniform draw per token."""

    __slots__ = ("params", "seed", "draws", "_rng")

    def __init__(self, params, seed=None):
        self.params = params
        self.seed = int(seed if seed is not None else resolve_seed(params))
        self.draws = 0
        self._rng = np.random.RandomState(self.seed)

    @classmethod
    def restore(cls, params, seed, draws):
        """Rebuild a sampler mid-stream (handoff import): burn ``draws``
        uniforms so the next draw continues the original sequence."""
        s = cls(params, seed=seed)
        draws = int(draws)
        if draws > 0:
            s._rng.random_sample(draws)
            s.draws = draws
        return s

    def state(self):
        return {"seed": self.seed, "draws": self.draws}

    def sample(self, logits):
        """One token from a float32 logits row; float64 math throughout so
        the distribution (and therefore the replay) is platform-stable."""
        p = self.params
        if p.temperature == 0.0:
            return int(np.argmax(logits))
        x = np.asarray(logits, np.float64) / p.temperature
        x -= x.max()
        probs = np.exp(x)
        probs /= probs.sum()
        order = np.argsort(-probs, kind="stable")
        if p.top_k > 0:
            order = order[:p.top_k]
        if p.top_p < 1.0:
            cum = np.cumsum(probs[order])
            keep = int(np.searchsorted(cum, p.top_p, side="left")) + 1
            order = order[:keep]
        kept = probs[order]
        kept /= kept.sum()
        u = self._rng.random_sample()
        self.draws += 1
        idx = int(np.searchsorted(np.cumsum(kept), u, side="right"))
        return int(order[min(idx, len(order) - 1)])
