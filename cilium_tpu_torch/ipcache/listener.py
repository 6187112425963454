"""Datapath listener: ipcache changes -> recompiled device LPM tensor.

A whole copy of ``cilium_tpu/ipcache/listener.py``, over the
port's ``compiler/lpm.compile_lpm``.

Reference: pkg/datapath/ipcache/listener.go — the BPF-map listener that
realizes control-plane ipcache changes in the datapath. Here a change
recompiles the LPM tensor (debounced through a Trigger so bursts fold
into one compile+swap) and hands the new arrays to a swap callback —
typically updating DatapathTables' lpm_* fields for the next batch.
"""

from __future__ import annotations

import threading
from typing import Callable, Optional

from ..compiler.lpm import CompiledLPM, compile_lpm
from ..utils.trigger import Trigger
from .ipcache import IPCache, IPIdentityPair


class DatapathLPMListener:
    """Folds ipcache churn into debounced LPM recompiles.

    ``swap_fn(compiled_lpm)`` is called with each new generation; the
    caller installs it into its datapath tables (device transfer happens
    there, off the upsert hot path).
    """

    def __init__(self, cache: IPCache,
                 swap_fn: Callable[[CompiledLPM], None],
                 min_interval: float = 0.01):
        self.cache = cache
        self.swap_fn = swap_fn
        self.generation = 0
        self._lock = threading.Lock()
        self._trigger = Trigger(self._recompile, min_interval=min_interval,
                                name="ipcache-lpm")
        cache.add_listener(self._on_change, replay=False)
        # initial sync for whatever the cache already holds
        self._trigger.trigger("initial-sync")

    def _on_change(self, mod: str, pair: IPIdentityPair,
                   old_id: Optional[int]) -> None:
        self._trigger.trigger(f"{mod}:{pair.prefix}")

    def _recompile(self, reasons) -> None:
        prefixes = self.cache.to_lpm_prefixes()
        compiled = compile_lpm(prefixes)
        with self._lock:
            self.generation += 1
        self.swap_fn(compiled)

    def flush(self, timeout: float = 5.0) -> bool:
        """Test barrier: force a recompile now and wait for it."""
        done = threading.Event()
        orig = self.swap_fn

        def once(compiled):
            orig(compiled)
            done.set()
        self.swap_fn = once
        try:
            self._trigger.trigger("flush")
            return done.wait(timeout)
        finally:
            self.swap_fn = orig

    def shutdown(self) -> None:
        self._trigger.shutdown()
