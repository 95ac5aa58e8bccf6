"""Multi-device rendering over ``torch.distributed`` (:mod:`.mesh`) and
its entry points (:mod:`.entry`)."""
