"""The LM substrate's models in PyTorch: the dense decoder-only family
(prefill and decode) so far."""
