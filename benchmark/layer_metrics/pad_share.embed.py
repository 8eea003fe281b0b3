"""The embedder's rows ([CLS] title [SEP] text [SEP], Lc tokens): the
share of their slots that hold padding, as ``native.batch_context_format``
counted them."""
from benchmark.layer_metrics._counters import pad_share


def read(record):
    return pad_share("emdr2_tpu_torch.native", "batch_context_format")
