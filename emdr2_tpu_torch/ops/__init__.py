from emdr2_tpu_torch.ops.fid_attention import (  # noqa: F401
    flash_self_attention,
    flash_self_attention_reference,
)
from emdr2_tpu_torch.ops.mips import (  # noqa: F401
    candidate_scan,
    candidate_scan_reference,
    exact_topk,
    mips_topk,
)
