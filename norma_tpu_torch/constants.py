"""Whisper decoding constants (copy of ``norma_tpu/constants.py``)."""

# Audio / mel frontend ------------------------------------------------------
SAMPLE_RATE = 16_000
N_FFT = 400
HOP_LENGTH = 160
CHUNK_LENGTH = 30  # seconds
N_SAMPLES = CHUNK_LENGTH * SAMPLE_RATE  # 480_000 samples per 30s window
N_FRAMES = N_SAMPLES // HOP_LENGTH  # 3000 mel frames per 30s window
N_FREQS = N_FFT // 2 + 1  # 201 rFFT bins

# Samples of audio covered by one timestamp tick (<|0.02|> increments).
# reference: model.rs:127 drains ``s_timestamp * 320`` samples.
SAMPLES_PER_TIMESTAMP_TICK = 320

# Decoding ------------------------------------------------------------------
# Temperature fallback ladder (reference: decode_with_fallback, model.rs:175).
TEMPERATURES = (0.0, 0.2, 0.4, 0.6, 0.8, 1.0)
NO_SPEECH_THRESHOLD = 0.6
LOGPROB_THRESHOLD = -1.0
COMPRESSION_RATIO_THRESHOLD = 2.4

# Special token strings (resolved through the tokenizer at load time,
# reference: monolingual.rs:242-250).
SOT_TOKEN = "<|startoftranscript|>"
EOT_TOKEN = "<|endoftext|>"
TRANSCRIBE_TOKEN = "<|transcribe|>"
TRANSLATE_TOKEN = "<|translate|>"
NO_TIMESTAMPS_TOKEN = "<|notimestamps|>"
# Older checkpoints call the token <|nocaptions|>, newer <|nospeech|>; the
# loader tries each in order (reference: monolingual.rs:244-247).
NO_SPEECH_TOKENS = ("<|nocaptions|>", "<|nospeech|>")

# The first sampled token of a window is forced into the timestamp range
# [<|0.00|> ..= <|1.00|>] (reference: monolingual.rs:285-296).
ZERO_SEC_TOKEN = "<|0.00|>"
ONE_SEC_TOKEN = "<|1.00|>"
