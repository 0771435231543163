"""Training pieces: the AdamW optimizer the GNN trainer uses."""
