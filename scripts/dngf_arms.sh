#!/bin/bash
# Three arms of dngf_convergence_cpu on one shared backbone, scored by one
# yardstick:
#   J  the JAX package's own trainer (python -m tcnerf.train.train_delta_ngf),
#      on the CPU;
#   P  the port through tcnerf_torch.tools.convergence --fit, on the CPU;
#   C  the port through the same --fit, on the card.
#
#   scripts/dngf_arms.sh backbone        # on the card: the shared backbone
#   scripts/dngf_arms.sh data            # the delta-NGF datasets, once
#   scripts/dngf_arms.sh J|P|C <seed>    # one fit at seed=<seed>
#   scripts/dngf_arms.sh score <arm> <seed> [alternate]  # controlled_strong
#   scripts/dngf_arms.sh jaxtool <arm> <seed> [sync]     # the JAX strong tool
#   scripts/dngf_arms.sh summary <arm> <seed>  # rounds, best, wall, scores
#
# Everything lives under $ARMS_DIR (default build/dngf_arms): backbone/
# (nerf_convergence_cpu fitted to 576 epochs, the record's peak, through
# the port on the card), data/ (the data_dir of every arm), <arm><seed>/
# (a fit's model_path) and <arm><seed>.log / .err / .strong[_alternate].log
# (the scoring on the CPU: trained `best` and the untrained readout under
# the trainer's synchronized ascent, or with `alternate` under the JAX
# tool's t-then-r phases, through scripts/strong_alternate.py). Every arm takes seed=<seed> and nothing else
# beyond the paths; EPOCHS=<n> sets grasp_training.n_epochs for every arm
# alike. A fit's log ends in "wall <s> s rc <rc>". Threads are the
# caller's (OMP_NUM_THREADS, XLA_FLAGS, taskset). `jaxtool` runs
# tools/strong_goal_validation.py as it is (t and r phases in turn), or
# with `sync` the synchronized ascent that the trainer and
# controlled_strong use, on the arms' data_dir (scripts/jax_run.py).
set -u
cd "$(dirname "$0")/.."
D=${ARMS_DIR:-build/dngf_arms}
NAME=dngf_convergence_cpu
EP=()
[ -n "${EPOCHS:-}" ] && EP=("grasp_training.n_epochs=$EPOCHS")
mkdir -p "$D"
PY=${PYTHON:-python3}
case "$1" in
backbone)
  rm -rf "$D/nerf" "$D/backbone"; mkdir -p "$D/backbone"
  $PY -m tcnerf_torch.tools.convergence --fit nerf_convergence_cpu \
    data_dir="$D/nerf" nerf_training.n_epochs=576 --bar-db 1.5 \
    > "$D/backbone.log" 2> "$D/backbone.err"; r=$?
  src=$D/nerf/storage/models/nerf/convergence_cpu
  cp "$src"/model_final_* "$src"/metrics.jsonl "$D/backbone/"
  exit $r ;;
data)
  $PY -c "
from tcnerf_torch.train import config, grasp_common
grasp_common.prepare_datasets(config.load_config(
    ['device=cpu', 'data_dir=$D/data'], '$NAME'), 'grad')" ;;
J|P|C)
  arm=$1; s=$2; run=$D/$arm$s
  rm -rf "$run"
  paths=("seed=$s" "data_dir=$D/data"
         "grasp_training.backbone_path=$D/backbone"
         "grasp_training.model_path=$run" "${EP[@]}")
  SECONDS=0
  if [ "$arm" = J ]; then
    mkdir -p "$run"
    JAX_PLATFORMS=cpu $PY scripts/jax_run.py "$run" \
      -m tcnerf.train.train_delta_ngf --config-name=$NAME "${paths[@]}"
  else
    dev=(); [ "$arm" = P ] && dev=("device=cpu")
    $PY -m tcnerf_torch.tools.convergence --fit $NAME "${dev[@]}" \
      "${paths[@]}" --bar
  fi > "$D/$arm$s.log" 2> "$D/$arm$s.err"
  r=$?; echo "wall $SECONDS s rc $r" >> "$D/$arm$s.log"; exit $r ;;
score)
  arm=$2; s=$3; cmd=(-m tcnerf_torch.tools.convergence --strong); tag=strong
  [ "${4:-}" = alternate ] && cmd=(scripts/strong_alternate.py --strong) && \
    tag=strong_alternate
  $PY "${cmd[@]}" "$D/$arm$s" \
    --backbone "$D/backbone" --config $NAME device=cpu "seed=$s" \
    "data_dir=$D/data" --bar > "$D/$arm$s.$tag.log" \
    2> "$D/$arm$s.$tag.err" ;;
jaxtool)
  arm=$2; s=$3; extra=()
  [ "${4:-}" = sync ] && \
    extra=("validation.grasp_opt_config.optimization_config.sync=true")
  JAX_PLATFORMS=cpu $PY scripts/jax_run.py "$D" --data-dir "$D/data" \
    "${extra[@]/#/--override=}" tools/strong_goal_validation.py $NAME \
    "$D/$arm$s" "$D/backbone" ;;
summary)
  arm=$2; s=$3; run=$D/$arm$s
  $PY -m tcnerf_torch.tools.convergence "$run" --config $NAME
  echo "best mean error (m, rad): $(cat "$run/training_progress.json")"
  sed -n '/^fit /p; /^strong ascent/,$p' "$D/$arm$s.log"
  for tag in strong strong_alternate; do
    [ -f "$D/$arm$s.$tag.log" ] && echo "$tag:" && cat "$D/$arm$s.$tag.log"
  done ;;
*)
  sed -n 2,30p "$0"; exit 2 ;;
esac
