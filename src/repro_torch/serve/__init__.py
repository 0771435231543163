"""GNN serving: the multi-model streaming runtime over DecoupledEngines."""
from repro_torch.core.config import ServingConfig
from repro_torch.core.report_schema import SCHEMA, SCHEMA_VERSION
from repro_torch.serve.gnn_server import GNNServer, Request, ServerStats

__all__ = ["GNNServer", "Request", "ServerStats", "ServingConfig",
           "SCHEMA", "SCHEMA_VERSION"]
