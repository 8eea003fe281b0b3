from emdr2_tpu_torch.retrieval.datastore import EmbeddingStore  # noqa: F401
from emdr2_tpu_torch.retrieval.index import ShardedEvidenceIndex  # noqa: F401
