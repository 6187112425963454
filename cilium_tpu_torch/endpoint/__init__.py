"""Endpoints (state machine, policy regeneration), the endpoint manager
with its build queue, and the device-resident policy tables (torch)."""
