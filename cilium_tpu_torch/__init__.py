"""PyTorch/CUDA port of cilium-tpu's policy verdict path.

A second package beside ``cilium_tpu`` (the JAX reference, unchanged).
It imports ``torch`` and numpy only, never ``jax`` and nothing of
``cilium_tpu``.  The same numpy-compiled tables and packet batches go
through both packages and their outputs match bit for bit.

Layout mirrors the reference: ``compiler/`` (host numpy table builders),
``ops/`` (device lookups and the dense verdict engine), ``datapath/``
(the verdict steps and the engine), ``policy/`` (rules, repository and
map-state resolution), ``labels`` / ``identity`` / ``ipcache/`` /
``endpoint/`` / ``proxy`` (the host control plane that turns rules into
map states).  ``csrc/`` holds the hand-written CUDA kernels, built at first use
by ``kernels.py``.

Entry points take ``device=``; the default is ``"cuda"`` and a missing
card raises (``device.resolve_device``).  Everything runs eagerly.
"""

__version__ = "0.1.0"
