"""GNN layers, lowerings and model assembly."""
