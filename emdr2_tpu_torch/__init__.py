"""emdr2_tpu_torch: the PyTorch + CUDA port of emdr2_tpu for NVIDIA Hopper.

It mirrors the JAX package's module paths and class names and imports
neither jax nor emdr2_tpu. So far it carries the question-answering serving
path (``serving.QAPipeline``) with two hand-written CUDA kernels:
flash self-attention (``ops/fid_attention.py``) and the MIPS candidate scan
(``ops/mips.py``).
"""

from emdr2_tpu_torch.config import (  # noqa: F401
    EMDR2Config,
    IndexConfig,
    ReaderConfig,
    RetrieverConfig,
    TransformerConfig,
    tiny_config,
)
