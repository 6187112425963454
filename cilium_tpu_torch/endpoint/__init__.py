"""Device-resident per-endpoint policy tables (torch)."""
