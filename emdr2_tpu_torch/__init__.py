"""emdr2_tpu_torch: the PyTorch + CUDA port of emdr2_tpu for NVIDIA Hopper.

It mirrors the JAX package's module paths and class names and imports
neither jax nor emdr2_tpu. It carries the question-answering serving path
(``serving.QAPipeline``: greedy, beam search, int8 cross K/V), the OpenQA
training step (``tasks.E2EQATask.train_step``) and evaluation
(``E2EQATask.evaluate_em`` / ``validation_loss``), the evidence-index build
and its refresh during training (``retrieval.builder``,
``training.async_refresh``), DPR training of the retriever
(``tasks.dense_retriever``) and its recall@k (``retrieval.evaluate``), the
OPENQA and RETRIEVER command line (``tasks.run``) and the checkpoint tools
(``tools``), on one device or over data-parallel ranks, one process a card
(``parallel``), the card unless the caller asks for the CPU, with
hand-written CUDA kernels for
flash self-attention forward and backward, FiD flash cross-attention
forward and backward, the general flash forward
(``ops/fid_attention.py``), the int8 decode attention
(``ops/decode_attention.py``) and the MIPS candidate scan (``ops/mips.py``).
"""

from emdr2_tpu_torch.config import (  # noqa: F401
    EMDR2Config,
    IndexConfig,
    ReaderConfig,
    RetrieverConfig,
    TransformerConfig,
    tiny_config,
)
