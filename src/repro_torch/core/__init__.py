"""Serving core: PPR selection, subgraph build, ACK program IR, host pipeline and the engine."""
