"""Verdict step and fused config-1 pipeline (torch)."""
