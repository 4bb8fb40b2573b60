#!/bin/bash
# The language grasp field at full width on one card, with its stage-1
# backbone fitted first in the same run:
#   1. nerf_convergence to $EPOCHS epochs (default 128, what fits with
#      step 2 in a job of one hour on an H100 at ~830 ms a step; the
#      record's 320 take ~75 min alone; the bars are the JAX record less
#      1.5 dB at 128 / 256 / 320, held where reached);
#   2. language_convergence, seed 0, on that model for 32 epochs under
#      --bar (the round bar and trained-below-untrained strong top-1);
#   3. only if seed 0 fails that rule and $LIMIT seconds (default 3420)
#      leave room for one more: seed 1 the same way.
#
#   [EPOCHS=320] scripts/language_fit.sh [out_dir]
#
# Everything is written under build/conv; the logs, stage 1's
# metrics.jsonl and each language run's valid/ round pickles and
# training_progress.json are copied into out_dir (default
# build/language_fit). The models stay in build/conv (~0.4 GB each).
set -u
cd "$(dirname "$0")/.."
E=${EPOCHS:-128}; LIMIT=${LIMIT:-3420}; PY=${PYTHON:-python3}
O=${1:-build/language_fit}; mkdir -p "$O"
B=build/conv/storage/models/nerf/convergence2
nvidia-smi --query-gpu=name,power.limit --format=csv,noheader
at=$(for e in 128 256 320; do [ "$e" -le "$E" ] && echo -n "$e,"; done)
SECONDS=0
$PY -m tcnerf_torch.tools.convergence --fit nerf_convergence \
  data_dir=build/conv nerf_training.n_epochs=$E --bar-db 1.5 \
  --at "${at%,}" > "$O/nerf.log" 2> "$O/nerf.err"
echo "stage 1 rc $? at $SECONDS s"; cat "$O/nerf.log"
cp "$B/metrics.jsonl" "$O/nerf_metrics.jsonl"
lang() {  # <seed> <seconds allowed>
  local run=build/conv/lang$1
  timeout -k 10 "$2" $PY -m tcnerf_torch.tools.convergence \
    --fit language_convergence data_dir=build/conv "seed=$1" \
    grasp_training.backbone_path=$B grasp_training.model_path=$run \
    grasp_training.n_epochs=32 --bar > "$O/lang$1.log" 2> "$O/lang$1.err"
  local r=$?
  mkdir -p "$O/lang$1"
  cp -r "$run/valid" "$run/training_progress.json" "$O/lang$1/" 2>/dev/null
  return $r
}
t0=$SECONDS
lang 0 $((LIMIT - SECONDS)); r=$?
took=$((SECONDS - t0))
echo "language seed 0 rc $r in $took s"; cat "$O/lang0.log"
failed=0; grep -q "FAIL" "$O/lang0.log" && failed=1
if [ $failed = 1 ] && [ $((SECONDS + took + 60)) -lt "$LIMIT" ]; then
  lang 1 $((LIMIT - SECONDS)); echo "language seed 1 rc $?"
  cat "$O/lang1.log"
elif [ $failed = 1 ]; then
  echo "language seed 1 not run: $SECONDS s used, seed 0 took $took s"
fi
grep -h "Traceback\|Error" "$O"/*.err | tail -n 5
echo "wall $SECONDS s"
