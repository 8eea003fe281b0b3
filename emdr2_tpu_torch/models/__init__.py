from emdr2_tpu_torch.models.bert import (  # noqa: F401
    BertEncoder,
    BertPretrainModel,
    DualEncoder,
)
from emdr2_tpu_torch.models.emdr2 import EMDR2Batch, EMDR2Model  # noqa: F401
from emdr2_tpu_torch.models.t5 import T5Model  # noqa: F401
