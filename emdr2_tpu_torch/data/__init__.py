from emdr2_tpu_torch.data import masks  # noqa: F401
from emdr2_tpu_torch.data.indexed_dataset import (  # noqa: F401
    MMapIndexedDataset,
    MMapIndexedDatasetBuilder,
    make_dataset,
)
from emdr2_tpu_torch.data.tokenizer import (  # noqa: F401
    BertWordPieceTokenizer,
    build_tokenizers,
    toy_vocab,
)
