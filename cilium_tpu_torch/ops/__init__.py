"""Device lookups and the dense verdict engine (torch + CUDA)."""
