"""Multi-host serving (the wire codec, the RPC transport and the graph
host) and the device placement helpers of the package's multi-device
parts."""
