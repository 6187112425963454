"""Hubble flow observability: the device-resident flow table (torch)."""
