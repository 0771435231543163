"""The LM substrate's models in PyTorch: the dense decoder-only family and
the MoE family (MoE FFNs, MLA attention), prefill and decode."""
