"""Checkpoints of train states (:mod:`repro_torch.checkpoint.manager`)."""
