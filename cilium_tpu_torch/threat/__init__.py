"""Inline per-packet threat scoring, ported from ``cilium_tpu/threat``.

- ``model.py``: the small quantized scorer (int32 fixed-point two-layer
  net) and the policy-controlled threshold/mode config (numpy copy).
- ``stage.py``: the scoring stage both family steps run behind the
  ``with_threat`` flag, and the token-bucket / window state (torch).
- ``oracle.py``: the numpy twin of the stage (numpy copy).
- ``trainer.py``: host-side fitting from flow records (numpy copy).
"""
