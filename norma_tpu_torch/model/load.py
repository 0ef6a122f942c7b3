"""Parameters: the module tree, random init and safetensors loading
(``norma_tpu/model/load.py``).

Parameters live in :class:`Params`, an ``nn.Module`` tree whose buffers
carry the JAX pytree's key names (``encoder.layers.qkv_w``,
``decoder.tok_emb``, ...) with per-layer weights STACKED along a leading
[L] axis, in the JAX package's layouts (linear weights [in, out], conv
weights [W, Cin, Cout]).  So the JAX package's params convert one to one
(:func:`params_from_numpy`), and the model functions index them like the
pytree (``params["decoder"]["layers"]["qkv_w"]``).
"""

from __future__ import annotations

import json
import mmap
import struct
from typing import Any, Dict, Iterator, Optional, Tuple

import numpy as np
import torch
from torch import nn

from .config import WhisperConfig

NumpyTree = Dict[str, Any]


def sinusoids(length: int, channels: int, max_timescale: float = 10_000) -> np.ndarray:
    """Fixed sinusoidal encoder position embedding (whisper convention)."""
    if channels % 2:
        raise ValueError(f"channels must be even, got {channels}")
    log_timescale_increment = np.log(max_timescale) / (channels // 2 - 1)
    inv_timescales = np.exp(-log_timescale_increment * np.arange(channels // 2))
    scaled_time = np.arange(length)[:, None] * inv_timescales[None, :]
    return np.concatenate([np.sin(scaled_time), np.cos(scaled_time)], axis=1).astype(
        np.float32
    )


class Params(nn.Module):
    """A nested parameter tree: dict keys become child modules (subtrees)
    or buffers (tensors).  Supports ``tree[key]``, ``key in tree`` and
    :meth:`items`, so model code reads it like the JAX pytree."""

    def __init__(self, tree: Dict[str, Any]):
        super().__init__()
        for k, v in tree.items():
            if isinstance(v, dict):
                self.add_module(k, Params(v))
            elif isinstance(v, Params):  # a subtree shared with another tree
                self.add_module(k, v)
            else:
                self.register_buffer(k, v)

    def __getitem__(self, key: str):
        if key in self._buffers:
            return self._buffers[key]
        return self._modules[key]

    def __contains__(self, key: str) -> bool:
        return key in self._buffers or key in self._modules

    def items(self) -> Iterator[Tuple[str, Any]]:
        yield from self._buffers.items()
        yield from self._modules.items()

    def layer(self, i: int) -> Dict[str, torch.Tensor]:
        """Per-layer view of a stacked layer tree: ``{name: w[i]}``."""
        return {k: v[i] for k, v in self._buffers.items()}

    @property
    def device(self) -> torch.device:
        return self["decoder"]["tok_emb"].device


def _scale_dtype(path: Tuple[str, ...]) -> Optional[torch.dtype]:
    """The dtype of a quantization scale, whatever the model dtype: bf16
    for the int4 head's (``tok_emb_q4.s``, the JAX package's bf16 grid),
    f32 for ``name_s`` layer leaves and the int8 head's ``s``; None for a
    leaf that is not a scale."""
    name = path[-1]
    if name == "s" and len(path) > 1 and path[-2] == "tok_emb_q4":
        return torch.bfloat16
    if name.endswith("_s") or name == "s":
        return torch.float32
    return None


def _tensor(v: np.ndarray) -> torch.Tensor:
    """numpy -> tensor; ml_dtypes' bfloat16 arrays (what ``np.asarray`` of a
    JAX bf16 array gives) keep their bits."""
    if v.dtype.name == "bfloat16":
        return torch.from_numpy(np.require(v, requirements=["C"]).view(np.int16).copy()).view(torch.bfloat16)
    return torch.from_numpy(np.require(v, requirements=["C", "W"]))  # copies only if needed


def params_from_numpy(
    tree: NumpyTree,
    device: "torch.device | str" = "cpu",
    dtype: Optional[torch.dtype] = torch.float32,
) -> Params:
    """Nested numpy arrays (e.g. the JAX package's params after
    ``jax.tree.map(np.asarray, params)``) -> :class:`Params` on ``device``.
    Floating weights are cast to ``dtype`` (None keeps each leaf's dtype);
    quantization scales keep their own dtype whatever ``dtype`` is
    (:func:`_scale_dtype`: bf16 for the int4 head, f32 otherwise), and
    integer leaves (int8 codes) keep theirs."""

    def conv(path, v):
        if isinstance(v, dict):
            return {k: conv(path + (k,), x) for k, x in v.items()}
        t = _tensor(v)
        if t.is_floating_point():
            sd = _scale_dtype(path)
            if sd is not None:
                t = t.to(sd)
            elif dtype is not None:
                t = t.to(dtype)
        return t.to(device)

    return Params(conv(("",), tree))


def _stack(layer_dicts) -> NumpyTree:
    return {k: np.stack([d[k] for d in layer_dicts]) for k in layer_dicts[0]}


def init_params_numpy(cfg: WhisperConfig, seed: int = 0) -> NumpyTree:
    """Random-init f32 numpy params with the exact checkpoint structure.

    Draws from ``np.random.default_rng(seed)`` in the same order as the JAX
    package's ``init_params`` (``norma_tpu/model/load.py:196-264``), so the
    same seed gives bit-identical f32 weights."""
    rng = np.random.default_rng(seed)
    D, V = cfg.d_model, cfg.vocab_size
    F = 4 * D

    def w(*shape, scale=None):
        scale = scale if scale is not None else (1.0 / np.sqrt(shape[0]))
        return (rng.standard_normal(shape, dtype=np.float32) * scale).astype(
            np.float32
        )

    def zeros(*shape):
        return np.zeros(shape, np.float32)

    def ones(*shape):
        return np.ones(shape, np.float32)

    def attn_p(px=""):
        return {
            f"{px}q_w": w(D, D),
            f"{px}q_b": zeros(D),
            f"{px}k_w": w(D, D),
            f"{px}v_w": w(D, D),
            f"{px}v_b": zeros(D),
            f"{px}o_w": w(D, D),
            f"{px}o_b": zeros(D),
        }

    def enc_layer():
        return {
            **attn_p(),
            "attn_ln_g": ones(D),
            "attn_ln_b": zeros(D),
            "fc1_w": w(D, F),
            "fc1_b": zeros(F),
            "fc2_w": w(F, D),
            "fc2_b": zeros(D),
            "mlp_ln_g": ones(D),
            "mlp_ln_b": zeros(D),
        }

    def dec_layer():
        return {
            **enc_layer(),
            **attn_p("x"),
            "xattn_ln_g": ones(D),
            "xattn_ln_b": zeros(D),
        }

    return {
        "encoder": {
            "conv1_w": w(3, cfg.num_mel_bins, D, scale=0.05),
            "conv1_b": zeros(D),
            "conv2_w": w(3, D, D, scale=0.05),
            "conv2_b": zeros(D),
            "pos": sinusoids(cfg.max_source_positions, D),
            "layers": _stack([enc_layer() for _ in range(cfg.encoder_layers)]),
            "ln_g": ones(D),
            "ln_b": zeros(D),
        },
        "decoder": {
            "tok_emb": w(V, D, scale=0.02),
            "pos_emb": w(cfg.max_target_positions, D, scale=0.02),
            "layers": _stack([dec_layer() for _ in range(cfg.decoder_layers)]),
            "ln_g": ones(D),
            "ln_b": zeros(D),
        },
    }


def init_params(
    cfg: WhisperConfig,
    seed: int = 0,
    dtype: torch.dtype = torch.float32,
    device: "torch.device | str" = "cpu",
) -> Params:
    """Random-init params (tests/bench); see :func:`init_params_numpy`."""
    return params_from_numpy(init_params_numpy(cfg, seed), device, dtype)


def fuse_qkv(params: Params) -> Params:
    """Fuse each layer stack's self-attention Q/K/V into one tensor.

    ``q_w``/``k_w``/``v_w`` [L, D, D] -> ``qkv_w`` [L, D, 3, D] and
    ``q_b``/``v_b`` -> ``qkv_b`` [L, 3, D] with zeros in the K slot
    (whisper's k_proj has no bias), so the decode step streams one weight
    and issues one matmul (``model/whisper.py::qkv_proj``).  Idempotent;
    returns a new tree sharing the untouched tensors.
    """

    def fuse(layers: Params) -> Dict[str, Any]:
        d = dict(layers.items())
        if "q_w" in d:
            d["qkv_w"] = torch.stack([d.pop("q_w"), d.pop("k_w"), d.pop("v_w")], dim=2)
            v_b = d.pop("v_b")
            d["qkv_b"] = torch.stack([d.pop("q_b"), torch.zeros_like(v_b), v_b], dim=1)
        return d

    tree = {}
    for part in ("encoder", "decoder"):
        sec = dict(params[part].items())
        sec["layers"] = fuse(params[part]["layers"])
        tree[part] = sec
    return Params(tree)


# -- safetensors ---------------------------------------------------------

_ST_DTYPES = {
    "F64": np.float64,
    "F32": np.float32,
    "F16": np.float16,
    "I64": np.int64,
    "I32": np.int32,
    "I16": np.int16,
    "I8": np.int8,
    "U8": np.uint8,
    "BOOL": np.bool_,
}


def read_safetensors(path: str) -> Dict[str, np.ndarray]:
    """Read a .safetensors file into a dict of numpy arrays (mmap views;
    BF16 tensors are widened to f32)."""
    with open(path, "rb") as f:
        mm = mmap.mmap(f.fileno(), 0, access=mmap.ACCESS_READ)
    if len(mm) < 8:
        raise ValueError(f"{path}: too short to be a safetensors file")
    (header_len,) = struct.unpack("<Q", mm[:8])
    if header_len > len(mm) - 8:
        raise ValueError(
            f"{path}: not a safetensors file (header length "
            f"{header_len} exceeds file size {len(mm)})"
        )
    try:
        header = json.loads(mm[8 : 8 + header_len].decode("utf-8"))
    except (UnicodeDecodeError, json.JSONDecodeError) as e:
        raise ValueError(f"{path}: not a safetensors file ({e})") from e
    base = 8 + header_len
    out = {}
    for name, info in header.items():
        if name == "__metadata__":
            continue
        start, end = info["data_offsets"]
        shape = info["shape"]
        if info["dtype"] == "BF16":
            raw16 = np.frombuffer(mm, np.uint16, (end - start) // 2, offset=base + start)
            arr = (raw16.astype(np.uint32) << 16).view(np.float32).reshape(shape)
        else:
            dt = np.dtype(_ST_DTYPES[info["dtype"]])
            arr = np.frombuffer(
                mm, dt, (end - start) // dt.itemsize, offset=base + start
            ).reshape(shape)
        out[name] = arr
    return out


def params_numpy_from_hf_tensors(
    t: Dict[str, np.ndarray], cfg: WhisperConfig
) -> NumpyTree:
    """Map HF whisper weight names ('model.encoder.layers.0....') onto the
    stacked numpy tree (linear weights transposed to [in, out], conv
    weights to [W, Cin, Cout])."""

    def g(name):
        if name in t:
            return np.asarray(t[name], np.float32)
        alt = name[len("model.") :] if name.startswith("model.") else "model." + name
        return np.asarray(t[alt], np.float32)

    def lin(name):
        return np.ascontiguousarray(g(name).T)

    def attn(prefix, px=""):
        return {
            f"{px}q_w": lin(f"{prefix}.q_proj.weight"),
            f"{px}q_b": g(f"{prefix}.q_proj.bias"),
            f"{px}k_w": lin(f"{prefix}.k_proj.weight"),
            f"{px}v_w": lin(f"{prefix}.v_proj.weight"),
            f"{px}v_b": g(f"{prefix}.v_proj.bias"),
            f"{px}o_w": lin(f"{prefix}.out_proj.weight"),
            f"{px}o_b": g(f"{prefix}.out_proj.bias"),
        }

    def ln(name, gk, bk):
        return {gk: g(f"{name}.weight"), bk: g(f"{name}.bias")}

    def mlp_ln(p):
        return {
            "fc1_w": lin(f"{p}.fc1.weight"),
            "fc1_b": g(f"{p}.fc1.bias"),
            "fc2_w": lin(f"{p}.fc2.weight"),
            "fc2_b": g(f"{p}.fc2.bias"),
            **ln(f"{p}.final_layer_norm", "mlp_ln_g", "mlp_ln_b"),
        }

    enc_layers = []
    for i in range(cfg.encoder_layers):
        p = f"model.encoder.layers.{i}"
        enc_layers.append({
            **attn(f"{p}.self_attn"),
            **ln(f"{p}.self_attn_layer_norm", "attn_ln_g", "attn_ln_b"),
            **mlp_ln(p),
        })
    dec_layers = []
    for i in range(cfg.decoder_layers):
        p = f"model.decoder.layers.{i}"
        dec_layers.append({
            **attn(f"{p}.self_attn"),
            **ln(f"{p}.self_attn_layer_norm", "attn_ln_g", "attn_ln_b"),
            **attn(f"{p}.encoder_attn", "x"),
            **ln(f"{p}.encoder_attn_layer_norm", "xattn_ln_g", "xattn_ln_b"),
            **mlp_ln(p),
        })

    try:
        enc_pos = g("model.encoder.embed_positions.weight")
    except KeyError:
        enc_pos = sinusoids(cfg.max_source_positions, cfg.d_model)

    def conv(name):  # HF [out, in, width] -> [width, in, out]
        return (
            np.ascontiguousarray(g(f"{name}.weight").transpose(2, 1, 0)),
            g(f"{name}.bias"),
        )

    c1w, c1b = conv("model.encoder.conv1")
    c2w, c2b = conv("model.encoder.conv2")
    return {
        "encoder": {
            "conv1_w": c1w,
            "conv1_b": c1b,
            "conv2_w": c2w,
            "conv2_b": c2b,
            "pos": enc_pos,
            "layers": _stack(enc_layers),
            **ln("model.encoder.layer_norm", "ln_g", "ln_b"),
        },
        "decoder": {
            "tok_emb": g("model.decoder.embed_tokens.weight"),
            "pos_emb": g("model.decoder.embed_positions.weight"),
            "layers": _stack(dec_layers),
            **ln("model.decoder.layer_norm", "ln_g", "ln_b"),
        },
    }


def params_from_hf_tensors(
    t: Dict[str, np.ndarray],
    cfg: WhisperConfig,
    dtype: torch.dtype = torch.float32,
    device: "torch.device | str" = "cpu",
) -> Params:
    return params_from_numpy(params_numpy_from_hf_tensors(t, cfg), device, dtype)


def load_safetensors(
    path: str,
    cfg: WhisperConfig,
    dtype: torch.dtype = torch.float32,
    device: "torch.device | str" = "cpu",
) -> Params:
    return params_from_hf_tensors(read_safetensors(path), cfg, dtype, device)
