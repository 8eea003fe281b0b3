"""emdr2_tpu_torch: the PyTorch + CUDA port of emdr2_tpu for NVIDIA Hopper.

It mirrors the JAX package's module paths and class names and imports
neither jax nor emdr2_tpu. It carries the question-answering serving path
(``serving.QAPipeline``) and the OpenQA training step
(``tasks.E2EQATask.train_step``) on one device, with hand-written CUDA
kernels for flash self-attention forward and backward, FiD flash
cross-attention forward and backward (``ops/fid_attention.py``) and the MIPS
candidate scan (``ops/mips.py``).
"""

from emdr2_tpu_torch.config import (  # noqa: F401
    EMDR2Config,
    IndexConfig,
    ReaderConfig,
    RetrieverConfig,
    TransformerConfig,
    tiny_config,
)
