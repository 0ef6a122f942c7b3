#!/usr/bin/env bash
# First-networked-machine runbook for the PyTorch port (the port of
# tools/first_network_run.sh): on a machine with egress and a card, ONE
# command produces the evidence an offline machine cannot -- goldens from
# real checkpoints, LibriSpeech WER for bf16 AND the quantized serving
# tiers.
#
# Usage:
#   norma_tpu_torch/tools/first_network_run.sh [LIBRISPEECH_DIR] [OUT_DIR]
#   norma_tpu_torch/tools/first_network_run.sh --dry-run
#
# LIBRISPEECH_DIR: a LibriSpeech test-clean directory ALREADY converted to
# 16 kHz mono WAV (see the ffmpeg loop below).  If omitted, the WER steps
# are skipped and only checkpoint download + goldens + quantization run.
#
# Every step logs to OUT_DIR and a failed step aborts (set -e): partial
# evidence is worse than a clear failure line.
set -euo pipefail

cd "$(dirname "$0")/../.."

# --dry-run: run the OFFLINE PREFIX only (no egress): every API
# construction and tool flag the networked steps use, so that drift in
# either shows here (tests/test_torch_first_network_dryrun.py runs it).
if [ "${1:-}" = "--dry-run" ]; then
    echo "=== first_network_run (PyTorch port) DRY RUN (offline prefix)"
    python - <<'PY'
# Step 1's API surface: the constructions the download step performs,
# minus the network call.
from norma_tpu_torch.models import SelectedDevice
from norma_tpu_torch.models.whisper.monolingual import Definition, ModelType

for mt in (ModelType.TINY_EN, ModelType.DISTIL_LARGE_EN_V3):
    d = Definition(mt, SelectedDevice.cpu())
    assert hasattr(d, "blocking_try_to_model")
# Step 3's cache-resolution import.
import huggingface_hub  # noqa: F401
from huggingface_hub import hf_hub_download  # noqa: F401
print("# API surface OK")
PY
    # Steps 2-4: every flag the script passes must exist.  A tool whose
    # --help fails is reported as that failure, with the end of its output.
    check_flags() {
        local tool="$1"; shift
        local help rc=0
        help="$(python -m "$tool" --help 2>&1)" || rc=$?
        if [ "$rc" -ne 0 ]; then
            echo "FAILED: python -m $tool --help exited $rc; the end of its output:"
            echo "$help" | tail -n 15
            exit 1
        fi
        for flag in "$@"; do
            echo "$help" | grep -q -- "$flag" || {
                echo "DRIFT: $tool lost flag $flag"; exit 1; }
        done
        echo "# $tool flags OK: $*"
    }
    check_flags norma_tpu_torch.tools.make_golden --repo --lang
    check_flags norma_tpu_torch.tools.quantize_checkpoint --decoder --encoder
    check_flags norma_tpu_torch.tools.eval_wer --local-dir --librispeech
    echo "=== DRY RUN OK: networked steps validated offline"
    exit 0
fi

LS_DIR="${1:-}"
OUT="${2:-${TMPDIR:-/tmp}/norma_torch_first_network_$(date +%Y%m%d_%H%M%S)}"
mkdir -p "$OUT"

echo "=== first_network_run (PyTorch port) -> $OUT"

# -- 0. Preflight: the hub client ---------------------------------------
python - <<'PY'
import sys
try:
    import huggingface_hub  # noqa: F401
except Exception as e:
    sys.exit(f"huggingface_hub unavailable: {e!r}")
PY

# -- 1. Download the two flagship checkpoints (pinned revisions ride the
#       Definitions; these calls run models/whisper/loader.py's
#       _hub_download end to end).
python - "$OUT" <<'PY'
from norma_tpu_torch.models import SelectedDevice
from norma_tpu_torch.models.whisper.monolingual import Definition, ModelType

for mt in (ModelType.TINY_EN, ModelType.DISTIL_LARGE_EN_V3):
    print(f"# downloading + building {mt} ...", flush=True)
    m = Definition(mt, SelectedDevice.cuda()).blocking_try_to_model()
    print(f"# {mt}: model built OK (sr={m.SAMPLE_RATE})", flush=True)
PY

# -- 2. Real-checkpoint goldens (commit these to tests/golden/). -------
python -m norma_tpu_torch.tools.make_golden --repo openai/whisper-tiny.en --lang en \
    "$OUT/golden_tiny_en.json" | tee "$OUT/make_golden_tiny.log"
python -m norma_tpu_torch.tools.make_golden --repo distil-whisper/distil-large-v3 --lang en \
    "$OUT/golden_distil_large_v3.json" | tee "$OUT/make_golden_distil.log"

# -- 3. Quantized serving checkpoint (int8 decoder + w8a8 encoder). ----
CKPT_BF16="$OUT/ckpt_distil_bf16"
CKPT_Q8="$OUT/ckpt_distil_q8"
python - "$CKPT_BF16" <<'PY'
# The HF cache paths of the just-downloaded checkpoint, copied into a
# plain local dir for the quantizer.
import os, shutil, sys

from huggingface_hub import hf_hub_download

out = sys.argv[1]
os.makedirs(out, exist_ok=True)
for f in ("config.json", "tokenizer.json", "model.safetensors"):
    shutil.copy(hf_hub_download("distil-whisper/distil-large-v3", f), out)
PY
python -m norma_tpu_torch.tools.quantize_checkpoint "$CKPT_BF16" "$CKPT_Q8" \
    --decoder --encoder | tee "$OUT/quantize.log"

# -- 4. WER: bf16 vs quantized serving tiers on LibriSpeech test-clean.
if [ -n "$LS_DIR" ]; then
    # Convert once if only .flac present:
    #   find "$LS_DIR" -name '*.flac' -exec sh -c \
    #     'ffmpeg -n -i "$1" -ar 16000 -ac 1 "${1%.flac}.wav"' _ {} \;
    python -m norma_tpu_torch.tools.eval_wer --local-dir "$CKPT_BF16" \
        --librispeech "$LS_DIR" "$OUT/wer_bf16.json" | tee "$OUT/wer_bf16.log"
    python -m norma_tpu_torch.tools.eval_wer --local-dir "$CKPT_Q8" \
        --librispeech "$LS_DIR" "$OUT/wer_q8.json" | tee "$OUT/wer_q8.log"
    python - "$OUT" <<'PY'
import json, sys

out = sys.argv[1]
b = json.load(open(f"{out}/wer_bf16.json"))
q = json.load(open(f"{out}/wer_q8.json"))
print(f"WER bf16 {b['wer']:.4f}  quantized {q['wer']:.4f}  delta {q['wer'] - b['wer']:+.4f}")
print("Compare with the reference table (distil-large-v3 short-form 9.7%) and record it in PERF.md.")
PY
else
    echo "# LIBRISPEECH_DIR not given: WER steps skipped"
fi

echo "=== first_network_run complete; artifacts in $OUT"
