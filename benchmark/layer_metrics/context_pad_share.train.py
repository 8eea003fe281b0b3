"""Stage B's context rows (the towers' [CLS] title [SEP] text [SEP], Lc
tokens): the share of their slots that hold padding, as
``postprocess_retrieved`` counted them."""
from benchmark.layer_metrics._counters import pad_share


def read(record):
    return pad_share("emdr2_tpu_torch.data.postprocess",
                     "postprocess_retrieved", "context")
