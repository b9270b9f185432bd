"""The training data pipeline (:mod:`repro_torch.data.pipeline`)."""
