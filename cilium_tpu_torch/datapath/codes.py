"""Verdict codes and reserved identities, copied from the reference
(``cilium_tpu/datapath/verdict.py``, ``datapath/pipeline.py``)."""

VERDICT_DROP = -1       # DROP_POLICY analog
VERDICT_DROP_FRAG = -2  # DROP_FRAG_NOSUPPORT analog
VERDICT_DROP_L7 = -3    # DROP_POLICY_L7 analog (on-device L7 stage)
VERDICT_DROP_THREAT = -4  # DROP_THREAT analog (inline threat stage)
VERDICT_ALLOW = 0       # TC_ACT_OK; >0 == proxy redirect port

# Identity assigned when the ipcache has no entry for the address
# (reference: world).
WORLD_IDENTITY = 2
