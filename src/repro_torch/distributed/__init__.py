"""Device placement helpers shared by the package's multi-device parts."""
