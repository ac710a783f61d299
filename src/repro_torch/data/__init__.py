"""The training input: a deterministic synthetic token stream."""
