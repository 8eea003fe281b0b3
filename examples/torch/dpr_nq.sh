#!/bin/bash
# DPR-style dense retriever training on NQ with the PyTorch port, on NVIDIA
# cards; the hyperparameters of examples/dense-retriever/dpr_nq.sh (the
# reference's): 16 questions a rank (global batch 128 at DP=8), one hard
# negative each, 40 epochs, lr 2e-5 with 1% linear warmup; after training
# the evidence is embedded by row range over the ranks and the recall on
# the dev and test questions reported.
#
# One process a rank: DP x TP of them (TP=1 by default; TP=2 splits each
# replica's towers over two cards, 16 questions a replica); DP=1 for one
# card. Hosts: run the script once on each of NNODES hosts (default 1),
# with NODE_RANK 0 .. NNODES-1 and host 0's MASTER_ADDR and MASTER_PORT;
# each starts its NPROC_PER_NODE (default DP*TP / NNODES) ranks, world
# rank NODE_RANK * NPROC_PER_NODE + local, on the host's cards 0 ..
# NPROC_PER_NODE-1, with torchrun's variables exported (as emdr2_nq.sh).
# The data and CHECKPOINT_PATH must be on a filesystem every host sees.
# COORDINATOR, if set, takes the place of MASTER_ADDR:MASTER_PORT.
# Arguments after the script's own are passed to every rank and win over
# its flags.

set -euo pipefail

DATA_DIR=${DATA_DIR:-data}
DP=${DP:-8}
TP=${TP:-1}
NNODES=${NNODES:-1}
NODE_RANK=${NODE_RANK:-0}
NPROC_PER_NODE=${NPROC_PER_NODE:-$((DP * TP / NNODES))}
MASTER_ADDR=${MASTER_ADDR:-localhost}
MASTER_PORT=${MASTER_PORT:-29500}
COORDINATOR=${COORDINATOR:-$MASTER_ADDR:$MASTER_PORT}
WORLD=$((DP * TP))
if ((NNODES * NPROC_PER_NODE != WORLD)); then
  echo "NNODES $NNODES x NPROC_PER_NODE $NPROC_PER_NODE is not DP $DP x" \
       "TP $TP = $WORLD ranks" >&2
  exit 1
fi

pids=()
for ((lr = 0; lr < NPROC_PER_NODE; lr++)); do
  rank=$((NODE_RANK * NPROC_PER_NODE + lr))
  RANK=$rank WORLD_SIZE=$WORLD LOCAL_RANK=$lr \
  LOCAL_WORLD_SIZE=$NPROC_PER_NODE GROUP_RANK=$NODE_RANK \
  MASTER_ADDR=$MASTER_ADDR MASTER_PORT=$MASTER_PORT \
  python -m emdr2_tpu_torch.tasks.run \
      --task RETRIEVER \
      --device cuda \
      --vocab-file "${VOCAB_FILE:-$DATA_DIR/bert-large-uncased-vocab.txt}" \
      --train-data "${TRAIN_DATA:-$DATA_DIR/nq-dpr-train.json}" \
      --valid-data "${VALID_DATA:-$DATA_DIR/nq-dpr-dev.json}" \
      --dp "$DP" \
      --tp "$TP" \
      --num-processes "$WORLD" \
      --process-id "$rank" \
      --coordinator-address "$COORDINATOR" \
      --batch-size 16 \
      --epochs 40 \
      --train-hard-neg 1 \
      --seq-length-ret 256 --seq-length-query 64 \
      --lr 2e-5 --lr-decay-style linear --warmup 0.01 \
      --weight-decay 0.1 --clip-grad 1.0 \
      --retriever-score-scaling \
      --fid-flash-attention \
      --save "${CHECKPOINT_PATH:-checkpoints/dpr-nq}" \
      --load "${CHECKPOINT_PATH:-checkpoints/dpr-nq}" \
      --save-interval 500 \
      --val-av-rank-other-neg 30 --val-av-rank-hard-neg 30 \
      --report-topk-accuracies 1 5 20 100 \
      --evidence-data-path "${EVIDENCE:-$DATA_DIR/wikipedia-evidence}" \
      --embedding-path "${EMBEDDINGS_OUT:-$DATA_DIR/dpr-evidence-embeddings}" \
      --qa-file-dev "${QA_FILE_DEV:-$DATA_DIR/nq-dev.csv}" \
      --qa-file-test "${QA_FILE_TEST:-$DATA_DIR/nq-test.csv}" \
      --log-interval 20 "$@" &
  pids+=($!)
done

# a rank that fails takes the others down: they would wait in a collective
rc=0
for pid in "${pids[@]}"; do
  if ! wait "$pid"; then
    rc=1
    kill "${pids[@]}" 2>/dev/null || true
  fi
done
exit $rc
