"""Command-line tools of the port (the root tools/ stays JAX)."""
