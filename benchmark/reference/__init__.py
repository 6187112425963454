"""The plain reference of the benchmark's comparison.

Plain PyTorch and NumPy.  It imports nothing of the program under test
and takes nothing the program made: it compiles the deployment's rules,
prefixes, services and L7 programs itself from the generated state.

- ``lpm``: longest-prefix match over sorted per-length key arrays
  (ipcache, prefilter, tunnel map).
- ``policy``: the policy verdict as a sorted-key lookup of the three-stage
  fallback chain (exact, L3-only, L4-wildcard), with per-entry counters.
- ``lb``: service lookup, backend selection and reverse NAT.
- ``l7``: the L7 fast verdict decided with Python's ``re`` on the decoded
  payload strings.
- ``conntrack`` and ``flows``: the connection tracker and the Hubble
  flow table as maps from a key to its entry, stepped by the rules
  their docstrings state; the hash decides only which keys fit
  (``hashing``), and the tables are compared key by key (``keys``).
- ``node``: the v4 step composed from the above, with the engine's
  flow-claim striping and the conntrack garbage collection.
"""
