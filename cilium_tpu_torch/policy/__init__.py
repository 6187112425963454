"""The policymap ABI the port starts from."""
