from emdr2_tpu_torch.tasks.e2eqa import E2EQATask  # noqa: F401
