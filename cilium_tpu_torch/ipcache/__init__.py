"""The IP/CIDR -> identity cache, the CIDR identities of policy prefixes,
and the listener that recompiles the datapath LPM on churn (host)."""
