"""MCCM core of the port: the batch evaluator and its front door."""
