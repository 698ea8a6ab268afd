"""Conv training around the steps of `repro_torch.models`: checkpoints,
the step guard, the trainer and its compiled step (port of
`repro/train/`)."""
