"""Offline checkpoint quantizer: HF safetensors (or GGUF q8_0) -> a
pre-quantized params file (the port of ``tools/quantize_checkpoint.py``).

Quantize once here; every later load reads the stored codes directly: no
full-precision pass, no per-start re-quantization.  The output directory is
a drop-in ``local_dir`` for the Definitions (config.json and
tokenizer.json are copied beside it); the loader knows the format from the
file's safetensors metadata (``norma_tpu_format: params-v1``) and applies
no name mapping, QKV fusion or quantize_* flag to it (they are baked in).
The file is byte-equal to the JAX package's tool's for the same input and
flags.

A host-side transform: it runs on the CPU and never looks for a card.

Run: python -m norma_tpu_torch.tools.quantize_checkpoint IN_DIR OUT_DIR \\
         [--dtype bf16|f32] [--decoder] [--encoder] [--logits int8|int4]

--decoder  int8 decoder-layer weights + int8 logits head (w8a16 compute)
--encoder  int8 encoder-layer weights (w8a8 through the int8 GEMM)
--logits   quantize only the logits head; with --decoder, int4 keeps the
           int4 head beside the int8 layers (int8 is the default there)
No quant flag at all still helps: the output is fused-QKV bf16/f32 with
structural loading.
"""

from __future__ import annotations

import argparse
import glob
import os
import shutil


def find_sidecar(in_dir: str, stem: str) -> str:
    """``<stem>.json`` in ``in_dir``, else the first ``<stem>*.json``
    (quantized HF repos suffix their sidecars, ``config-<ext>.json``);
    ``tokenizer*.json`` never matches ``tokenizer_config.json``."""
    plain = os.path.join(in_dir, f"{stem}.json")
    if os.path.exists(plain):
        return plain
    hits = [
        h for h in sorted(glob.glob(os.path.join(in_dir, f"{stem}*.json")))
        if os.path.basename(h) != f"{stem}_config.json"
    ]
    if not hits:
        raise SystemExit(f"{in_dir}: no {stem}*.json found")
    return hits[0]


def quantize(params, decoder: bool, encoder: bool, logits):
    """(params with the asked tiers, the tiers' names), by the runtime
    loader's composition rule."""
    from ..model.quant import quantize_decoder, quantize_encoder, quantize_logits_head, quantize_logits_head_int4

    tiers = []
    if decoder:
        params = quantize_decoder(params, logits="int4" if logits == "int4" else "int8")
        tiers.append("decoder-w8")
        if logits == "int4":
            tiers.append("logits-int4")
    elif logits == "int4":
        params = quantize_logits_head_int4(params)
        tiers.append("logits-int4")
    elif logits == "int8":
        params = quantize_logits_head(params)
        tiers.append("logits-w8")
    if encoder:
        params = quantize_encoder(params)
        tiers.append("encoder-w8a8")
    return params, tiers


def main(argv=None) -> str:
    """Convert; returns the written file's path."""
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("in_dir", help="dir with config.json/tokenizer.json/model.safetensors (or a *.gguf)")
    ap.add_argument("out_dir")
    ap.add_argument("--dtype", choices=("bf16", "f32"), default="bf16")
    ap.add_argument("--decoder", action="store_true", help="int8 decoder weights + head")
    ap.add_argument("--encoder", action="store_true", help="w8a8 int8 encoder weights")
    ap.add_argument("--logits", choices=("int8", "int4"), default=None)
    args = ap.parse_args(argv)

    import torch

    from ..model import WhisperConfig, fuse_qkv
    from ..model.load import load_safetensors
    from ..model.serialize import save_params

    cfg_path = find_sidecar(args.in_dir, "config")
    tok_path = find_sidecar(args.in_dir, "tokenizer")
    cfg = WhisperConfig.from_json(cfg_path)
    dtype = torch.bfloat16 if args.dtype == "bf16" else torch.float32
    st_path = os.path.join(args.in_dir, "model.safetensors")
    if os.path.exists(st_path):
        params = load_safetensors(st_path, cfg, dtype, "cpu")
    else:
        # A GGUF q8_0 file (the reference's quantized distribution) converts too.
        ggufs = sorted(glob.glob(os.path.join(args.in_dir, "*.gguf")))
        if not ggufs:
            raise SystemExit(f"{args.in_dir}: no model.safetensors or *.gguf found")
        from ..model.gguf import load_gguf_q8

        params = load_gguf_q8(ggufs[0], cfg, dtype, "cpu")
    params, tiers = quantize(fuse_qkv(params), args.decoder, args.encoder, args.logits)

    os.makedirs(args.out_dir, exist_ok=True)
    # The sidecars under their plain names: a standard checkpoint directory.
    shutil.copy(cfg_path, os.path.join(args.out_dir, "config.json"))
    shutil.copy(tok_path, os.path.join(args.out_dir, "tokenizer.json"))
    out_path = os.path.join(args.out_dir, "model.safetensors")
    quant = "+".join(tiers) or "none"
    save_params(out_path, params, metadata={"quant": quant, "dtype": args.dtype})
    print(f"wrote {out_path} ({os.path.getsize(out_path) / 1e6:.1f} MB, quant={quant}, {args.dtype})")
    return out_path


if __name__ == "__main__":
    main()
