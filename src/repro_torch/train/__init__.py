"""Training on one device: the optimizer, the train step and
checkpoints."""
