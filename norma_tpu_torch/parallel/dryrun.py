"""The multi-device dry run (``__graft_entry__.py``'s
``dryrun_multichip``): every decode path of the engine on a dp mesh and on
a dp x tp mesh, at a tiny width, in one call.

    dryrun_multichip(4)                    # on the cards
    dryrun_multichip(4, ["cpu"] * 4)       # 4 virtual CPU devices

Without ``devices`` the mesh takes ``n_devices`` positions over the cards
in turn: with fewer cards than positions, a card is named more than once
(virtual devices).  The tp mesh is the JAX dry run's: tp=4 where 4 divides
``n_devices``, else 2 (1 for an odd count), dp the rest, with its
draft/verify part on a tp-sharded draft.
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np
import torch

LANGS = [902, 903, 904]


def _devices(n_devices: int, devices: Optional[Sequence]) -> list:
    if devices is not None:
        return list(devices)[:n_devices]
    n = torch.cuda.device_count()
    if n == 0:
        raise RuntimeError("dryrun_multichip: no CUDA device; pass devices=['cpu'] * n for the CPU")
    return [torch.device("cuda", i % n) for i in range(n_devices)]


@torch.no_grad()
def dryrun_multichip(n_devices: int, devices: Optional[Sequence] = None) -> str:
    """Run the engine's paths on a dp mesh of ``n_devices`` positions over
    ``devices`` (default: the cards, virtual where there are fewer), then on
    the dp x tp mesh (:func:`dryrun_tp`); print and return one
    ``dryrun_multichip OK: ...`` line.  Raises on a wrong shape, a
    replica that lost its kernel config, or a failed path."""
    from ..decode import DecodeEngine, SpeculativeEngine
    from ..decode.masks import SpecialTokens
    from ..frontend.mel import log_mel_spectrogram
    from ..model import WhisperConfig, fuse_qkv, init_params
    from ..model.quant import quantize_encoder
    from .sharding import make_mesh, shard_batch, shard_params

    mesh = make_mesh(dp=n_devices, tp=1, devices=_devices(n_devices, devices))
    dev = mesh.devices[0, 0]
    dp = n_devices
    # Two heads of 64: the width the kernels take (the flash encoder's head
    # dimension is 64), at d_model 128.
    cfg = WhisperConfig(
        num_mel_bins=80, vocab_size=1024, d_model=128, encoder_layers=2, encoder_attention_heads=2,
        decoder_layers=2, decoder_attention_heads=2, max_source_positions=32, max_target_positions=48,
        suppress_tokens=(0, 5),
    )
    st = SpecialTokens(sot=901, eot=900, task=905, no_speech=907, no_timestamps=940, zero_sec=941, one_sec=991)
    host_params = fuse_qkv(init_params(cfg, seed=0, device=dev))
    params = shard_params(host_params, mesh)
    engines = []

    def engine(p, c=cfg, **kw):
        e = DecodeEngine(p, c, st, language_token_ids=LANGS, **kw)
        engines.append(e)
        return e

    try:
        eng = engine(params)
        B = 2 * dp
        n_frames = 2 * cfg.max_source_positions
        audio_np = np.random.default_rng(0).standard_normal((B, (n_frames - 1) * 160 + 400)).astype(np.float32)
        audio = shard_batch(audio_np, mesh)

        mel = log_mel_spectrogram(torch.from_numpy(audio_np).to(dev), n_mels=cfg.num_mel_bins, n_frames=n_frames)
        feats = eng.encode(mel)
        probs = eng.detect_language(shard_batch(feats, mesh))
        assert probs.shape == (B, 3), probs.shape

        # The compositional decode: prefill + the token loop, rows over the replicas.
        results = eng.run_loop(eng.prefill(shard_batch(feats, mesh), LANGS[0]), 0.0, seed=0)
        assert len(results) == B and all(r.tokens[0] == st.sot for r in results)

        # The serving window, one stream detecting its language.
        langs = np.full(B, LANGS[0], np.int32)
        langs[0] = -1
        fused, info = eng.transcribe_window(audio, langs, seed=0)
        assert len(fused) == B and int(info["langs"][0]) in LANGS
        n_toks = [0 if r is None else len(r.tokens) for r in fused]
        # B=1 does not divide over dp: whole on the first replica (the
        # speculative ladder arm at one row).
        spec1, _ = eng.transcribe_window(audio_np[:1], [LANGS[0]], seed=0)
        assert len(spec1) == 1

        # The quantized tiers on the same mesh.
        same = np.full(B, LANGS[0], np.int32)
        for kw in (dict(quantize_cross_kv=True), dict(quantize_self_kv=True)):
            assert len(engine(params, **kw).transcribe_window(audio, same, seed=0)[0]) == B
        for impl in ("chunked", "a8"):
            e = engine(params, cfg.with_(cross_kv_impl=impl), quantize_cross_kv=True)
            assert len(e.transcribe_window(audio, same, seed=0)[0]) == B
        e8 = engine(shard_params(quantize_encoder(host_params), mesh))
        assert len(e8.transcribe_window(audio, same, seed=0)[0]) == B

        # The dp carry keeps the kernel impls: every replica runs them (the
        # CUDA kernels on the card, their plain versions on the CPU).
        kcfg = cfg.with_(encoder_attn_impl="jax_flash", cross_kv_impl="kernel", self_kv_impl="kernel")
        ek = engine(params, kcfg, quantize_cross_kv=True)
        for r in ek.replicas:
            c = r.engine.cfg
            assert (c.cross_kv_impl, c.self_kv_impl, c.encoder_attn_impl) == ("kernel", "kernel", "jax_flash")
        dp_out, _ = ek.transcribe_window(audio, same, seed=0)
        assert len(dp_out) == B

        # Speculative decoding on dp-sharded target and draft params.
        dcfg = cfg.with_(decoder_layers=1, encoder_layers=1)
        draft = shard_params(fuse_qkv(init_params(dcfg, seed=9, device=dev)), mesh)
        es = SpeculativeEngine(params, cfg, draft, dcfg, st, language_token_ids=LANGS, spec_k=3)
        engines.append(es)
        s_out, s_info = es.transcribe_window(audio, langs, seed=0)
        assert len(s_out) == B and int(s_info["langs"][0]) in LANGS
        s_toks = [0 if r is None else len(r.tokens) for r in s_out]
    finally:
        for e in engines:
            e.close()

    tp_line = dryrun_tp(n_devices, _devices(n_devices, devices))
    line = (
        f"dryrun_multichip OK: mesh dp={dp} tp=1 over {[str(d) for d in mesh.devices.flat]}, B={B}, "
        f"dp kernel carry {[0 if r is None else len(r.tokens) for r in dp_out]} tokens, "
        f"compositional {[len(r.tokens) for r in results]} tokens, fused ladder {n_toks} tokens, "
        f"detected lang {int(info['langs'][0])}, B=1 on the first replica "
        f"{0 if spec1[0] is None else len(spec1[0].tokens)} tokens, draft/verify {s_toks} tokens; {tp_line}"
    )
    print(line)
    return line


@torch.no_grad()
def dryrun_tp(n_devices: int, devices: Sequence) -> str:
    """The tp parts of the JAX dry run on a dp x tp mesh over ``devices``
    (tp=4 where 4 divides ``n_devices``, else 2): encode, detection, the
    compositional decode, the serving window with one stream detecting and
    at B=1, the int8 cross-K/V (each cross impl) and self-KV tiers, the w8a8
    encoder and the kernel config, each at 64-wide heads, one a rank at
    tp=4; then speculative decoding with a tp-sharded one-layer draft
    (``spec_k=3``, one stream detecting).  Returns its part of the dry
    run's line."""
    from ..decode import DecodeEngine, SpeculativeEngine
    from ..decode.masks import SpecialTokens
    from ..frontend.mel import log_mel_spectrogram
    from ..model import WhisperConfig, fuse_qkv, init_params
    from ..model.quant import quantize_encoder
    from .sharding import make_mesh, shard_batch, shard_params

    tp = 4 if n_devices % 4 == 0 else (2 if n_devices % 2 == 0 else 1)
    dp = n_devices // tp
    mesh = make_mesh(dp=dp, tp=tp, devices=devices)
    dev = mesh.devices[0, 0]
    cfg = WhisperConfig(
        num_mel_bins=80, vocab_size=1024, d_model=256, encoder_layers=2, encoder_attention_heads=4,
        decoder_layers=2, decoder_attention_heads=4, max_source_positions=32, max_target_positions=48,
        suppress_tokens=(0, 5),
    )
    st = SpecialTokens(sot=901, eot=900, task=905, no_speech=907, no_timestamps=940, zero_sec=941, one_sec=991)
    host_params = fuse_qkv(init_params(cfg, seed=0, device=dev))
    params = shard_params(host_params, mesh)
    B = max(2 * dp, 2)
    n_frames = 2 * cfg.max_source_positions
    audio_np = np.random.default_rng(0).standard_normal((B, (n_frames - 1) * 160 + 400)).astype(np.float32)
    audio = shard_batch(audio_np, mesh)
    same = np.full(B, LANGS[0], np.int32)
    engines = []

    def engine(p, c=cfg, **kw):
        e = DecodeEngine(p, c, st, language_token_ids=LANGS, **kw)
        engines.append(e)
        return e

    try:
        eng = engine(params)
        mel = log_mel_spectrogram(torch.from_numpy(audio_np).to(dev), n_mels=cfg.num_mel_bins, n_frames=n_frames)
        feats = eng.encode(mel)
        assert tuple(feats.shape) == (B, cfg.max_source_positions, cfg.d_model), feats.shape
        probs = eng.detect_language(shard_batch(feats, mesh))
        assert probs.shape == (B, 3), probs.shape
        results = eng.run_loop(eng.prefill(shard_batch(feats, mesh), LANGS[0]), 0.0, seed=0)
        assert len(results) == B and all(r.tokens[0] == st.sot for r in results)
        langs = same.copy()
        langs[0] = -1
        fused, info = eng.transcribe_window(audio, langs, seed=0)
        assert len(fused) == B and int(info["langs"][0]) in LANGS
        spec1, _ = eng.transcribe_window(audio_np[:1], [LANGS[0]], seed=0)
        assert len(spec1) == 1
        tiers = [dict(quantize_cross_kv=True), dict(quantize_self_kv=True)]
        for kw in tiers:
            assert len(engine(params, **kw).transcribe_window(audio, same, seed=0)[0]) == B
        for impl in ("chunked", "a8"):
            e = engine(params, cfg.with_(cross_kv_impl=impl), quantize_cross_kv=True)
            assert len(e.transcribe_window(audio, same, seed=0)[0]) == B
        e8 = engine(shard_params(quantize_encoder(host_params), mesh))
        assert len(e8.transcribe_window(audio, same, seed=0)[0]) == B
        kcfg = cfg.with_(encoder_attn_impl="jax_flash", cross_kv_impl="kernel", self_kv_impl="kernel")
        k_out, _ = engine(params, kcfg, quantize_cross_kv=True).transcribe_window(audio, same, seed=0)
        assert len(k_out) == B
        # Speculative decoding on the same mesh: a shallow tp-sharded draft
        # proposes, the target verifies in one chunked forward.
        dcfg = cfg.with_(decoder_layers=1, encoder_layers=1)
        draft = shard_params(fuse_qkv(init_params(dcfg, seed=9, device=dev)), mesh)
        es = SpeculativeEngine(params, cfg, draft, dcfg, st, language_token_ids=LANGS, spec_k=3)
        engines.append(es)
        s_out, s_info = es.transcribe_window(audio, langs, seed=0)
        assert len(s_out) == B and int(s_info["langs"][0]) in LANGS
        s_toks = [0 if r is None else len(r.tokens) for r in s_out]
        s_rounds = es.last_spec_rounds
    finally:
        for e in engines:
            e.close()
    return (
        f"tp mesh dp={dp} tp={tp} over {[str(d) for d in mesh.devices.flat]}: fused ladder "
        f"{[0 if r is None else len(r.tokens) for r in fused]} tokens, detected lang {int(info['langs'][0])}, "
        f"compositional {[len(r.tokens) for r in results]} tokens, B=1 "
        f"{0 if spec1[0] is None else len(spec1[0].tokens)} tokens, kernel config "
        f"{[0 if r is None else len(r.tokens) for r in k_out]} tokens, "
        f"draft/verify {s_toks} tokens over {s_rounds} rounds"
    )

