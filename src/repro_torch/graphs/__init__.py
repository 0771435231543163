"""Host graph store and synthetic datasets (numpy)."""
