"""Checkpoint persistence (``ckpt.checkpoint``)."""
