"""Data pipelines: the synthetic token stream for LM training and the
target-vertex stream for GNN serving."""
