"""The policy engine (host): rule schema (api), JSON rule text,
repository, L4/L3 resolution, tracing and the per-endpoint map state."""
