"""The training path (train step, loss) and the serving steps of the
reference's ``repro/train``."""
