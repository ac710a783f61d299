"""Checkpoints of the training state in the reference's on-disk layout."""
