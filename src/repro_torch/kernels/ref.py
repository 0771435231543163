"""The plain PyTorch versions of every kernel, under the names of the
reference's ``repro.kernels.ref`` oracles. Each lives beside its kernel
wrapper; this module collects them."""
from repro_torch.kernels.fused_gnn import fused_gnn_layer_ref
from repro_torch.kernels.gat_attention import gat_attention_ref
from repro_torch.kernels.scatter_gather import scatter_gather_aggregate_ref

__all__ = ["fused_gnn_layer_ref", "scatter_gather_aggregate_ref",
           "gat_attention_ref"]
