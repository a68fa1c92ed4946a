"""Layers of the port (channels-last), one module per JAX counterpart."""
