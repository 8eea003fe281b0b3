from emdr2_tpu_torch.retrieval.index import ShardedEvidenceIndex  # noqa: F401
