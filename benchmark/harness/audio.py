"""Seeded synthetic speech-band audio: a tone with a slow amplitude swell
plus noise, its frequency, level and noise drawn per row or stream."""

from __future__ import annotations

import numpy as np

SAMPLE_RATE = 16000


def _params(rng: np.random.Generator):
    return dict(freq=rng.uniform(110.0, 900.0), amp=rng.uniform(0.08, 0.3), noise=rng.uniform(0.01, 0.06),
                swell=rng.uniform(0.2, 2.0), phase=rng.uniform(0.0, 2 * np.pi))


def _signal(p: dict, start: int, n: int, rng: np.random.Generator) -> np.ndarray:
    t = (start + np.arange(n)) / SAMPLE_RATE
    env = 0.6 + 0.4 * np.sin(2 * np.pi * p["swell"] * t + p["phase"])
    x = p["amp"] * env * np.sin(2 * np.pi * p["freq"] * t) + p["noise"] * rng.standard_normal(n)
    return x.astype(np.float32)


def rows(seed: int, n_rows: int, samples: int, padded: int) -> np.ndarray:
    """``n_rows`` distinct clips of ``samples`` samples, zero-padded to
    ``padded`` (the frames of a whole window): [n_rows, padded] f32."""
    rng = np.random.default_rng([int(seed), 1])
    out = np.zeros((n_rows, padded), np.float32)
    for i in range(n_rows):
        out[i, :samples] = _signal(_params(rng), 0, samples, rng)
    return out


class Stream:
    """One endless stream's audio, block after block."""

    def __init__(self, seed: int, index: int):
        self.rng = np.random.default_rng([int(seed), 2, index])
        self.p = _params(self.rng)
        self.pos = 0

    def block(self, n: int) -> np.ndarray:
        x = _signal(self.p, self.pos, n, self.rng)
        self.pos += n
        return x
