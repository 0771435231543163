"""Training pieces: AdamW, the LM loss and train step, and the
fault-tolerant LM training loop."""
