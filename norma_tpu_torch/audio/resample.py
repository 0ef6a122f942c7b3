"""Streaming windowed-sinc resampler.

Re-creation of the reference's on-callback resampling
(``src/lib.rs:189-216``: dasp ``from_hz_to_hz`` with a
128-tap ``Sinc`` interpolator over a fixed ring buffer).  This is host-side
DSP — it must run on the capture thread, not the TPU — so the hot path is
the C++ implementation in ``audio/native``; this vectorized numpy version is
the portable fallback and the test oracle.
"""

from __future__ import annotations

import numpy as np

TAPS = 128  # same depth as the reference's sinc ring buffer


class StreamingResampler:
    """Convert a mono PCM stream from ``src_hz`` to ``dst_hz`` incrementally.

    Windowed-sinc interpolation: output at fractional input position t uses
    the ``taps`` samples centered on t, weighted by a Blackman-windowed sinc.
    The interpolator starts with a zero-filled history (the reference seeds
    its ring with EQUILIBRIUM frames, lib.rs:168), so the first ~taps/2
    output samples carry a startup transient.

    Quality improvement over the reference: when downsampling, the sinc
    cutoff sits at the TARGET Nyquist (dasp's Sinc interpolator keeps the
    source-rate cutoff, so a 13 kHz tone in a 48k->16k conversion folds to
    3 kHz at full amplitude; here it is attenuated by the filter stopband).
    """

    def __init__(self, src_hz: float, dst_hz: float, taps: int = TAPS) -> None:
        assert taps % 2 == 0
        self.src_hz = float(src_hz)
        self.dst_hz = float(dst_hz)
        self.step = self.src_hz / self.dst_hz
        self.taps = taps
        self._half = taps // 2
        self._hist = np.zeros(taps, np.float64)
        # Next output position, in input-sample units relative to _hist[0].
        self._t = float(taps - 1)
        self._win = np.blackman(taps + 2)[1:-1]
        self._rel0 = np.arange(taps, dtype=np.float64) - (self._half - 1)
        # Anti-alias cutoff (normalized to the source rate); slightly under
        # the target Nyquist to leave a transition band for the window.
        self._fc = min(1.0, self.dst_hz / self.src_hz) * 0.95

    def process(self, block: np.ndarray) -> np.ndarray:
        x = np.concatenate([self._hist, np.asarray(block, np.float64)])
        n_in = len(x)
        half = self._half
        t = self._t

        limit = n_in - half  # need x[n0 + half] to exist
        n_out = int(np.floor((limit - 1e-9 - t) / self.step)) + 1 if t < limit else 0
        if n_out <= 0:
            self._hist = x
            self._t = t
            return np.zeros(0, np.float64)

        ts = t + self.step * np.arange(n_out)
        n0s = np.floor(ts).astype(np.int64)
        fracs = ts - n0s

        # windows[k] = x[n0-half+1 : n0+half+1]
        starts = n0s - half + 1
        idx = starts[:, None] + np.arange(self.taps)[None, :]
        windows = x[idx]

        rel = self._rel0[None, :] - fracs[:, None]
        kern = np.sinc(self._fc * rel) * self._win[None, :]
        kern /= kern.sum(axis=1, keepdims=True)
        out = (windows * kern).sum(axis=1)

        # Advance: drop input we will never need again.
        t_next = t + self.step * n_out
        cut = max(0, int(np.floor(t_next)) - half)
        self._hist = x[cut:]
        self._t = t_next - cut
        return out
