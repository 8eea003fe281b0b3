#!/bin/bash
# EMDR2 end-to-end training on Natural Questions with the PyTorch port, on
# NVIDIA cards: the flagship recipe. The hyperparameters are those of
# examples/openqa/emdr2_nq.sh (the reference's): BERT-base retriever and
# T5-base reader, top-50 retrieval, 8 questions a rank (global batch 64 at
# DP=8), 10 epochs, lr 2e-5 with 1% linear warmup, the index re-embedded
# and swapped every 500 steps.
#
# One process a rank: DP x TP trainers (world rank dp_idx * TP + tp_idx;
# TP=1 by default, TP=2 splits each replica's heads, MLP and vocabulary
# over two cards, the batch a replica staying BATCH_PER_RANK), their
# embedders on EMBED_DEVICES further cards (DP=8 EMBED_DEVICES=8 is the
# reference's layout of 8 trainers beside 8 indexers; EMBED_DEVICES=0
# embeds on each trainer's own card). One card: DP=1 EMBED_DEVICES=0.
#
# Hosts: run the script once on each of NNODES hosts (default 1), with
# NODE_RANK 0 .. NNODES-1, MASTER_ADDR and MASTER_PORT host 0's
# rendezvous. Each host starts its NPROC_PER_NODE (default DP*TP / NNODES)
# ranks, world rank NODE_RANK * NPROC_PER_NODE + local, with torchrun's
# variables exported (RANK, WORLD_SIZE, LOCAL_RANK, LOCAL_WORLD_SIZE,
# GROUP_RANK, MASTER_ADDR, MASTER_PORT): local rank l trains on the host's
# card l, and the host's EMBED_DEVICES / NNODES embedder cards follow its
# trainers' (a multiple or a divisor of NPROC_PER_NODE). The reference's
# layout on two hosts of 8 cards: NNODES=2 DP=8 EMBED_DEVICES=8, 4 + 4 a
# host. Every host must see DATA_DIR and CHECKPOINT_PATH on a shared
# filesystem (the ranks check before they start). COORDINATOR, if set,
# takes the place of MASTER_ADDR:MASTER_PORT (a host:port or a file://
# store). Arguments after the script's own are passed to every rank and
# win over its flags.

set -euo pipefail

DATA_DIR=${DATA_DIR:-data}
VOCAB_FILE=${VOCAB_FILE:-$DATA_DIR/bert-large-uncased-vocab.txt}
EVIDENCE=${EVIDENCE:-$DATA_DIR/wikipedia-evidence}        # tools.build_evidence output prefix
EMBEDDINGS=${EMBEDDINGS:-$DATA_DIR/mss-emdr2-evidence-embeddings}  # or reference .pkl
TRAIN_DATA=${TRAIN_DATA:-$DATA_DIR/nq-train.csv}
VALID_DATA=${VALID_DATA:-$DATA_DIR/nq-dev.csv}
CHECKPOINT_PATH=${CHECKPOINT_PATH:-checkpoints/emdr2-nq}
DP=${DP:-8}
TP=${TP:-1}
EMBED_DEVICES=${EMBED_DEVICES:-8}
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
      --task OPENQA \
      --device cuda \
      --vocab-file "$VOCAB_FILE" \
      --train-data "$TRAIN_DATA" \
      --valid-data "$VALID_DATA" \
      --evidence-data-path "$EVIDENCE" \
      --embedding-path "$EMBEDDINGS" \
      --save "$CHECKPOINT_PATH" \
      --load "$CHECKPOINT_PATH" \
      --dp "$DP" \
      --tp "$TP" \
      --num-processes "$WORLD" \
      --process-id "$rank" \
      --coordinator-address "$COORDINATOR" \
      --batch-size "${BATCH_PER_RANK:-8}" \
      --epochs 10 \
      --topk-retrievals 50 \
      --seq-length 512 \
      --seq-length-ret 256 \
      --seq-length-dec 32 \
      --lr 2e-5 \
      --lr-decay-style linear \
      --warmup 0.01 \
      --weight-decay 0.1 \
      --clip-grad 1.0 \
      --retriever-score-scaling \
      --update-retriever \
      --allow-trivial-doc \
      --async-indexer \
      --embed-devices "$EMBED_DEVICES" \
      --fid-flash-attention \
      --remat \
      --no-remat-towers \
      `# the reader's stacks recompute in the backward, the towers keep` \
      `# their activations: B=8 fits an 80 GB card (PERF.md)` \
      --index-reload-interval 500 \
      --index-quantize int8 \
      `# int8 rows + per-128-row scales, half the bytes of bf16, with an` \
      `# exact re-rank of the candidates` \
      --prefetch-depth 1 \
      `# stage A's search queued after each step on this thread, the host` \
      `# postprocess of the next batch on a worker beside the step` \
      --log-interval 20 \
      --save-interval 500 \
      --eval-interval 500 \
      --max-decode-len 32 \
      --beam-size 1 "$@" &
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
