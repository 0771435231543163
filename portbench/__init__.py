"""The benchmark of the PyTorch and CUDA port (``repro_torch``): served
GNN embeddings on one H100. ``python3 portbench/run.py --help``."""
