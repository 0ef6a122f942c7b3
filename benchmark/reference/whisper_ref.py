"""Plain float32 Whisper: the benchmark's reference for ``correct``.

Plain ``torch`` operations only; it imports nothing of the program.  It
takes the bf16 weights the benchmark made (``harness/weights.py``, a
nested dict in the port's layout: linear weights [in, out] stacked over
layers, convolutions [W, Cin, Cout]) and the same audio rows, quantizes
the weights again itself, and computes in float32 with TF32 off.

What it reproduces of the served configuration (the serving stack of the
configuration files):

  - log-mel: periodic Hann window, rFFT(400) without center padding, the
    Slaney mel filterbank, log10 clamped at 1e-10 and at the window's
    max - 8, then (x + 4) / 4;
  - encoder: conv stem with exact GELU, sinusoidal positions, 32 pre-LN
    layers whose six projections are w8a8: int8 weights per output
    channel (scale amax / 127, codes rounded half to even) times int8
    activations per row (scale amax / 127), the product scaled back in
    f32; exact softmax attention; final LayerNorm;
  - cross-K/V of every decoder layer from int8 weights, then quantized
    per channel over the 1500 positions (scale amax / 127) for the token
    loop; the prefill's three positions read them unquantized, as the
    program's prefill does;
  - decoder: int8 weights per output channel with float activations
    (w8a16), the tied head int8 per vocabulary row, causal
    self-attention over float K/V, teacher-forced over the served tokens
    in one pass (position p's logits predict token p + 1).

Departures from the published model, all the configuration's: the
int8 quantization above (the published weights are float), and the
greedy timestamp grammar (``reference/grammar.py``) that the served path
applies on top of the logits.

``bits=4`` gives the control: the same forward with every int8 weight on
a blockwise int4 grid (blocks of 64 along the contraction, scale amax / 7)
and the cross-K/V on an int4 grid per channel (scale amax / 7).
"""

from __future__ import annotations

import math
from typing import Dict, Optional

import numpy as np
import torch
import torch.nn.functional as F

SAMPLE_RATE = 16000
N_FFT = 400
HOP = 160
LN_EPS = 1e-5
PREFIX = 3  # [sot, language, task]


# -- frontend ---------------------------------------------------------------


def _hz_to_mel(f):
    f = np.asarray(f, np.float64)
    f_sp, min_hz = 200.0 / 3, 1000.0
    logstep = np.log(6.4) / 27.0
    return np.where(f >= min_hz, min_hz / f_sp + np.log(np.maximum(f, min_hz) / min_hz) / logstep, f / f_sp)


def _mel_to_hz(m):
    m = np.asarray(m, np.float64)
    f_sp, min_hz = 200.0 / 3, 1000.0
    logstep = np.log(6.4) / 27.0
    return np.where(m >= min_hz / f_sp, min_hz * np.exp(logstep * (m - min_hz / f_sp)), m * f_sp)


def mel_filterbank(n_mels: int) -> np.ndarray:
    """Slaney-scale, Slaney-normalized mel filters [n_mels, 201] (librosa's
    ``filters.mel(sr=16000, n_fft=400)``, which Whisper ships)."""
    freqs = np.linspace(0, SAMPLE_RATE / 2, N_FFT // 2 + 1)
    hz = _mel_to_hz(np.linspace(_hz_to_mel(0.0), _hz_to_mel(SAMPLE_RATE / 2), n_mels + 2))
    ramps = hz[:, None] - freqs[None, :]
    fdiff = np.diff(hz)
    w = np.maximum(0.0, np.minimum(-ramps[:-2] / fdiff[:-1, None], ramps[2:] / fdiff[1:, None]))
    return w * (2.0 / (hz[2:n_mels + 2] - hz[:n_mels]))[:, None]


def log_mel(audio: torch.Tensor, n_mels: int, n_frames: int = 3000) -> torch.Tensor:
    """audio [B, >= (n_frames - 1) * 160 + 400] -> [B, n_mels, n_frames] f32."""
    dev = audio.device
    i = torch.arange(N_FFT, dtype=torch.float64, device=dev)
    window = 0.5 * (1.0 - torch.cos(2.0 * math.pi * i / N_FFT))
    frames = audio.double().unfold(1, N_FFT, HOP)[:, :n_frames] * window
    spec = torch.fft.rfft(frames, dim=-1)
    power = spec.real.square() + spec.imag.square()
    filters = torch.from_numpy(mel_filterbank(n_mels)).to(dev)
    mel = torch.matmul(filters, power.transpose(1, 2))
    log_spec = torch.log10(torch.clamp(mel, min=1e-10))
    log_spec = torch.maximum(log_spec, log_spec.amax(dim=(1, 2), keepdim=True) - 8.0)
    return ((log_spec + 4.0) / 4.0).float()


def sinusoids(length: int, channels: int) -> torch.Tensor:
    inc = np.log(10000.0) / (channels // 2 - 1)
    t = np.arange(length)[:, None] * np.exp(-inc * np.arange(channels // 2))[None, :]
    return torch.from_numpy(np.concatenate([np.sin(t), np.cos(t)], axis=1).astype(np.float32))


# -- quantization arithmetic ------------------------------------------------


def _round_codes(x: torch.Tensor, scale: torch.Tensor, limit: float) -> torch.Tensor:
    return torch.clamp(torch.round(x / scale), -limit, limit)


def quant_weight(w: torch.Tensor, bits: int) -> torch.Tensor:
    """A weight [..., in, out] on its served grid, as f32 values: int8 per
    output channel over ``in`` (scale amax / 127, 1 for a zero channel), or
    for ``bits=4`` blockwise over 64 rows of ``in`` (scale amax / 7)."""
    wf = w.float()
    if bits == 8:
        amax = wf.abs().amax(dim=-2, keepdim=True)
        s = torch.where(amax > 0, amax / 127.0, torch.ones_like(amax))
        return _round_codes(wf, s, 127.0) * s
    *lead, k, n = wf.shape
    wb = wf.reshape(*lead, k // 64, 64, n)
    amax = wb.abs().amax(dim=-2, keepdim=True)
    s = torch.where(amax > 0, amax / 7.0, torch.ones_like(amax))
    return (_round_codes(wb, s, 7.0) * s).reshape(*lead, k, n)


def quant_rows(x: torch.Tensor) -> torch.Tensor:
    """Dynamic int8 activations per row (the last axis), as f32 values:
    scale max(amax, 1e-8) / 127 (1 for a zero row)."""
    amax = x.abs().amax(dim=-1, keepdim=True)
    s = torch.where(amax > 0, torch.clamp(amax, min=1e-8) / 127.0, torch.ones_like(amax))
    return torch.round(x / s) * s


def quant_xkv(x: torch.Tensor, bits: int) -> torch.Tensor:
    """Cross-K/V [B, Ta, D] per channel over Ta: scale max(amax, 1e-8) /
    127 (int8) or / 7 (int4), as f32 values."""
    limit = 127.0 if bits == 8 else 7.0
    s = torch.clamp(x.abs().amax(dim=-2, keepdim=True), min=1e-8) / limit
    return _round_codes(x, s, limit) * s


# -- model ------------------------------------------------------------------


def _ln(x, g, b):
    return F.layer_norm(x, (x.shape[-1],), g, b, LN_EPS)


def _attend(q, k, v, heads: int, mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """q [Tq, D], k/v [Tk, D] -> [Tq, D]: softmax(q k^T / sqrt(dh)) v per head."""
    tq, d = q.shape
    dh = d // heads
    qh = q.reshape(tq, heads, dh).transpose(0, 1)
    kh = k.reshape(-1, heads, dh).transpose(0, 1)
    vh = v.reshape(-1, heads, dh).transpose(0, 1)
    s = torch.matmul(qh, kh.transpose(1, 2)) / math.sqrt(dh)
    if mask is not None:
        s = s + mask
    return torch.matmul(torch.softmax(s, dim=-1), vh).transpose(0, 1).reshape(tq, d)


class Reference:
    """The reference model on ``device``, its weights on the served grid
    (``bits`` 8) or the control's (``bits`` 4), f32."""

    def __init__(self, weights: Dict, heads: int, bits: int = 8):
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        self.heads, self.bits = heads, bits
        f = lambda t: t.float()
        q = lambda t: quant_weight(t, bits)
        enc, dec = weights["encoder"], weights["decoder"]
        el, dl = enc["layers"], dec["layers"]
        self.enc = {k: f(enc[k]) for k in ("conv1_w", "conv1_b", "conv2_w", "conv2_b", "ln_g", "ln_b")}
        self.enc["pos"] = sinusoids(enc["pos"].shape[0], enc["pos"].shape[1]).to(enc["pos"].device)
        self.el = {k: (q(v) if k.endswith("_w") else f(v)) for k, v in el.items()}
        self.dl = {k: (q(v) if k.endswith("_w") else f(v)) for k, v in dl.items()}
        self.dec = {k: f(dec[k]) for k in ("tok_emb", "pos_emb", "ln_g", "ln_b")}
        self.head = quant_weight(dec["tok_emb"].t(), bits)  # [D, V], per vocabulary row

    def _w8a8(self, x, w, b=None):
        y = torch.matmul(quant_rows(x), w)
        return y if b is None else y + b

    @torch.no_grad()
    def encode(self, audio_row: torch.Tensor) -> torch.Tensor:
        """One padded audio row [S] -> encoder output [1500, D]."""
        e, L = self.enc, self.el
        n_mels = e["conv1_w"].shape[1]
        mel = log_mel(audio_row[None].float(), n_mels)
        x = F.gelu(F.conv1d(mel, e["conv1_w"].permute(2, 1, 0), e["conv1_b"], padding=1))
        x = F.gelu(F.conv1d(x, e["conv2_w"].permute(2, 1, 0), e["conv2_b"], stride=2, padding=1))
        x = x[0].transpose(0, 1)
        x = x + e["pos"][: x.shape[0]]
        for i in range(L["q_w"].shape[0]):
            h = _ln(x, L["attn_ln_g"][i], L["attn_ln_b"][i])
            qa = quant_rows(h)  # one activation grid for Q, K and V
            q = torch.matmul(qa, L["q_w"][i]) + L["q_b"][i]
            k = torch.matmul(qa, L["k_w"][i])
            v = torch.matmul(qa, L["v_w"][i]) + L["v_b"][i]
            x = x + self._w8a8(_attend(q, k, v, self.heads), L["o_w"][i], L["o_b"][i])
            h = _ln(x, L["mlp_ln_g"][i], L["mlp_ln_b"][i])
            h = F.gelu(self._w8a8(h, L["fc1_w"][i], L["fc1_b"][i]))
            x = x + self._w8a8(h, L["fc2_w"][i], L["fc2_b"][i])
        return _ln(x, e["ln_g"], e["ln_b"])

    @torch.no_grad()
    def logits(self, xa: torch.Tensor, tokens) -> torch.Tensor:
        """Teacher-forced decoder over ``tokens`` (the served row, prefix
        included) on encoder output ``xa`` [Ta, D]: [n, V] f32, row p
        predicting token p + 1."""
        L, d = self.dl, self.dec
        dev = xa.device
        toks = torch.as_tensor(np.asarray(tokens, np.int64), device=dev)
        n = toks.shape[0]
        x = d["tok_emb"][toks] + d["pos_emb"][:n]
        causal = torch.triu(torch.full((n, n), float("-inf"), device=dev), diagonal=1)
        prefill = (torch.arange(n, device=dev) < PREFIX)[:, None]
        for i in range(L["q_w"].shape[0]):
            h = _ln(x, L["attn_ln_g"][i], L["attn_ln_b"][i])
            q = torch.matmul(h, L["q_w"][i]) + L["q_b"][i]
            k = torch.matmul(h, L["k_w"][i])
            v = torch.matmul(h, L["v_w"][i]) + L["v_b"][i]
            x = x + torch.matmul(_attend(q, k, v, self.heads, causal), L["o_w"][i]) + L["o_b"][i]
            h = _ln(x, L["xattn_ln_g"][i], L["xattn_ln_b"][i])
            xq = torch.matmul(h, L["xq_w"][i]) + L["xq_b"][i]
            xk = torch.matmul(xa, L["xk_w"][i])
            xv = torch.matmul(xa, L["xv_w"][i]) + L["xv_b"][i]
            # The prefill reads the cross-K/V as computed, the token loop
            # its per-channel codes.
            a_pre = _attend(xq, xk, xv, self.heads)
            a_loop = _attend(xq, quant_xkv(xk, self.bits), quant_xkv(xv, self.bits), self.heads)
            a = torch.where(prefill, a_pre, a_loop)
            x = x + torch.matmul(a, L["xo_w"][i]) + L["xo_b"][i]
            h = _ln(x, L["mlp_ln_g"][i], L["mlp_ln_b"][i])
            x = x + torch.matmul(F.gelu(torch.matmul(h, L["fc1_w"][i]) + L["fc1_b"][i]), L["fc2_w"][i]) + L["fc2_b"][i]
        x = _ln(x, d["ln_g"], d["ln_b"])
        return torch.matmul(x, self.head)
