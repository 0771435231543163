"""Model configurations: a copy of the reference's ``repro.configs``."""
