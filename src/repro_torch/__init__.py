"""PyTorch/CUDA port of the decoupled mini-batch GNN serving system.

A second package beside the JAX reference ``repro``: the same host
pipeline (PPR selection, subgraph build, pack), the same ACK program IR,
and hand-written CUDA kernels for Hopper (``csrc/``) in place of the
reference's Pallas kernels. It imports ``torch`` and numpy, never ``jax``
and nothing of ``repro``.
"""

__version__ = "0.1.0"
