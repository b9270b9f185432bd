"""Training of the port: the optimizers (:mod:`repro_torch.train.optimizer`)
and the train step and ``Trainer`` (:mod:`repro_torch.train.loop`)."""
