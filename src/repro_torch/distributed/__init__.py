"""Fault tolerance for the trainer
(:mod:`repro_torch.distributed.fault_tolerance`)."""
