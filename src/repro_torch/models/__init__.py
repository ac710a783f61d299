"""Model configuration, blocks and weights (the dense-MLP GQA family)."""
