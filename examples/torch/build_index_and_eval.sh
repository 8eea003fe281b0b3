#!/bin/bash
# Offline index build and recall evaluation with the PyTorch port (the
# steps of examples/helper-scripts/build_index_and_eval.sh): pre-tokenize
# the evidence once, embed it with a trained retriever on one card, and
# report recall@k on the dev and test questions. Arguments after the
# script's own (model widths, --device) go to the embedding and the
# evaluation and win over their flags.
#
# Hosts: the tools are one process each, on one card, so the build runs on
# host 0 alone; run the script on every host with NNODES and NODE_RANK set
# (as the training recipes take them) and the others return at once.
# NPROC_PER_NODE, MASTER_ADDR and MASTER_PORT do not apply: no rendezvous.

set -euo pipefail

NNODES=${NNODES:-1}
NODE_RANK=${NODE_RANK:-0}
if ((NODE_RANK != 0)); then
  echo "build_index_and_eval: host $NODE_RANK of $NNODES: the offline" \
       "build runs on host 0"
  exit 0
fi

DATA_DIR=${DATA_DIR:-data}
VOCAB_FILE=${VOCAB_FILE:-$DATA_DIR/bert-large-uncased-vocab.txt}
EVIDENCE=${EVIDENCE:-$DATA_DIR/wikipedia-evidence}
EMBEDDINGS=${EMBEDDINGS:-$DATA_DIR/evidence-embeddings}
CKPT=${CKPT:-checkpoints/emdr2-nq}
QA_FILES=${QA_FILES:-"$DATA_DIR/nq-dev.csv $DATA_DIR/nq-test.csv"}
TOPK=${TOPK:-100}
REPORT_AT=${REPORT_AT:-"1 5 20 100"}

# 1. pre-tokenize the evidence TSV (once)
if [ ! -f "${EVIDENCE}_text.idx" ]; then
  python -m emdr2_tpu_torch.tools.build_evidence \
      --input "${EVIDENCE_TSV:-$DATA_DIR/psgs_w100.tsv}" \
      --output-prefix "$EVIDENCE" --vocab-file "$VOCAB_FILE" \
      --workers "${WORKERS:-16}"
fi

# 2. embed the corpus with the trained retriever
python -m emdr2_tpu_torch.tools.create_doc_index \
    --evidence-data-path "$EVIDENCE" --vocab-file "$VOCAB_FILE" \
    --embedding-path "$EMBEDDINGS" --load "$CKPT" --batch-size 256 \
    --fid-flash-attention --device cuda "$@"

# 3. recall@k on dev and test
# shellcheck disable=SC2086  # QA_FILES and REPORT_AT are lists
python -m emdr2_tpu_torch.tools.evaluate_retrieval \
    --qa-data $QA_FILES \
    --evidence-data-path "$EVIDENCE" --embedding-path "$EMBEDDINGS" \
    --vocab-file "$VOCAB_FILE" --load "$CKPT" \
    --topk "$TOPK" --report-topk-accuracies $REPORT_AT \
    --fid-flash-attention --device cuda "$@"
