"""Random Whisper weights drawn on the device from the run's seed.

The same seed on the same device gives the same weights, so the
reference can draw them again once the program's state is freed.  The
tree is the port's layout (``norma_tpu_torch/model/load.py``): linear
weights [in, out] and their biases stacked over layers [L, ...], keys
sorted; convolutions [W, Cin, Cout]; the encoder's positions the
sinusoids, in float32.  Laws: linear weights N(0, 1/in), token and
position embeddings N(0, 0.02^2), convolutions N(0, 0.05^2), biases and
LayerNorm shifts N(0, 0.02^2), LayerNorm gains 1 + N(0, 0.02^2).  Every
leaf is one draw, in the type it is served in.
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch


def sinusoids(length: int, channels: int) -> torch.Tensor:
    inc = np.log(10000.0) / (channels // 2 - 1)
    t = np.arange(length)[:, None] * np.exp(-inc * np.arange(channels // 2))[None, :]
    return torch.from_numpy(np.concatenate([np.sin(t), np.cos(t)], axis=1).astype(np.float32))


def make_weights(cfg: Dict, seed: int, device, dtype=torch.bfloat16) -> Dict:
    """The nested weight dict of the model ``cfg`` (HF key names) from
    ``seed`` on ``device``."""
    g = torch.Generator(device=device).manual_seed(int(seed))
    d, mels, v = cfg["d_model"], cfg["num_mel_bins"], cfg["vocab_size"]

    def normal(*shape, std):
        return (torch.randn(shape, generator=g, device=device, dtype=dtype) * std).to(dtype)

    def gain(*shape):
        return (1.0 + torch.randn(shape, generator=g, device=device, dtype=torch.float32) * 0.02).to(dtype)

    def layers(n: int, ffn: int, cross: bool) -> Dict[str, torch.Tensor]:
        t = {}
        for px in ("", "x") if cross else ("",):
            for w in ("q", "k", "v", "o"):
                t[f"{px}{w}_w"] = normal(n, d, d, std=d ** -0.5)
            for b in ("q", "v", "o"):
                t[f"{px}{b}_b"] = normal(n, d, std=0.02)
        for ln in ("attn", "mlp") + (("xattn",) if cross else ()):
            t[f"{ln}_ln_g"], t[f"{ln}_ln_b"] = gain(n, d), normal(n, d, std=0.02)
        t.update(fc1_w=normal(n, d, ffn, std=d ** -0.5), fc1_b=normal(n, ffn, std=0.02),
                 fc2_w=normal(n, ffn, d, std=ffn ** -0.5), fc2_b=normal(n, d, std=0.02))
        return {k: t[k] for k in sorted(t)}

    encoder = {
        "conv1_w": normal(3, mels, d, std=0.05), "conv1_b": normal(d, std=0.02),
        "conv2_w": normal(3, d, d, std=0.05), "conv2_b": normal(d, std=0.02),
        "pos": sinusoids(cfg["max_source_positions"], d).to(device),
        "layers": layers(cfg["encoder_layers"], cfg["encoder_ffn_dim"], False),
        "ln_g": gain(d), "ln_b": normal(d, std=0.02),
    }
    decoder = {
        "tok_emb": normal(v, d, std=0.02), "pos_emb": normal(cfg["max_target_positions"], d, std=0.02),
        "layers": layers(cfg["decoder_layers"], cfg["decoder_ffn_dim"], True),
        "ln_g": gain(d), "ln_b": normal(d, std=0.02),
    }
    return {"encoder": encoder, "decoder": decoder}
