"""Map-pressure gauges for every device table.

Reference: pkg/metrics BPFMapPressure (cilium_bpf_map_pressure) — the
fill fraction of every fixed-capacity BPF map, the "which table is
about to overflow" early warning.  Here the fixed-capacity tables are
the device-resident ones: conntrack (v4/v6), the stacked policy rows,
and the Hubble flow-aggregation table.  Host-compiled lookup tables
(ipcache, LB, tunnel, prefilter) rebuild at any size, so they report
entry counts without a pressure fraction.

``compute_pressure`` consumes the engine's existing geometry/occupancy
report (``Datapath.map_inventory``), updates the gauges, and returns
the structured report with warnings above the configured threshold —
surfaced in ``daemon.status()``, ``cilium-tpu status --verbose``,
bugtool, and debuginfo.

A whole copy of ``cilium_tpu/observability/pressure.py``.
"""

from __future__ import annotations

from typing import Dict, List

from ..utils.metrics import registry

MAP_PRESSURE = registry.gauge(
    "map_pressure",
    "Fill fraction (0..1) of fixed-capacity device tables by map")
MAP_ENTRIES = registry.gauge(
    "map_entries",
    "Live entries per device table by map")
# Sharded-dataplane twins (parallel/sharded.py): per-shard occupancy so
# a single shard's CT/flow/policy table filling up is visible as that
# shard's pressure, not averaged away across the mesh — the warn
# threshold applies shard-locally.
MAP_SHARD_PRESSURE = registry.gauge(
    "map_shard_pressure",
    "Fill fraction (0..1) of fixed-capacity device tables by map and "
    "dataplane shard")
MAP_SHARD_ENTRIES = registry.gauge(
    "map_shard_entries",
    "Live entries per device table by map and dataplane shard")

DEFAULT_WARN_THRESHOLD = 0.9

# flight-recorder edge detection: (shard, map) keys currently above
# the warn threshold — a warning records ONE event when it appears,
# not one per status()/metrics scrape, and re-arms when it clears
_warned_keys: set = set()


def _bounded(occupied: int, capacity: int) -> float:
    if capacity <= 0:
        return 0.0
    return round(occupied / capacity, 6)


def compute_pressure(inventory: Dict[str, Dict],
                     warn_threshold: float = DEFAULT_WARN_THRESHOLD,
                     shard: "int | None" = None) -> Dict:
    """Pressure report from a ``map_inventory()`` dict.  Updates the
    gauges as a side effect (the /metrics view and this report can
    never disagree).

    With ``shard`` set, the report covers ONE dataplane shard: gauges
    go to the shard-labelled series and warnings name the shard — the
    warn threshold is applied shard-locally, because a full table on
    shard k is shard k's emergency even when the mesh-wide average
    looks healthy."""
    maps: Dict[str, Dict] = {}
    warnings: List[str] = []
    if shard is None:
        pressure_g, entries_g, labels, prefix = \
            MAP_PRESSURE, MAP_ENTRIES, {}, ""
    else:
        pressure_g, entries_g = MAP_SHARD_PRESSURE, MAP_SHARD_ENTRIES
        labels, prefix = {"shard": str(shard)}, f"shard {shard}: "

    def add(name: str, occupied: int, capacity: int) -> None:
        p = _bounded(occupied, capacity)
        maps[name] = {"occupied": occupied, "capacity": capacity,
                      "pressure": p}
        pressure_g.set(p, labels={"map": name, **labels})
        entries_g.set(float(occupied), labels={"map": name, **labels})
        key = (shard, name)
        if capacity > 0 and p >= warn_threshold:
            warnings.append(
                f"{prefix}{name}: {occupied}/{capacity} "
                f"({p * 100:.1f}% >= {warn_threshold * 100:.0f}%)")
            if key not in _warned_keys:
                _warned_keys.add(key)
                from .events import EVENT_MAP_PRESSURE, recorder
                recorder.record(EVENT_MAP_PRESSURE,
                                detail=warnings[-1], shard=shard,
                                map=name, occupied=occupied,
                                capacity=capacity)
        else:
            _warned_keys.discard(key)

    for name in ("ct", "ct6"):
        entry = inventory.get(name)
        if entry:
            add(name, int(entry.get("occupied", 0)),
                int(entry.get("slots", 0)))
    pol = inventory.get("policy")
    if pol:
        if "endpoints" in pol and "slots" in pol:
            # stacked [endpoints x slots] rows; row occupancy is
            # endpoint count vs row capacity (the grow trigger), slot
            # fill within a row is bounded by the manager's max_load
            occupied = int(pol.get("attached", pol.get("entries", 0)))
            add("policy-rows", occupied, int(pol["endpoints"]))
    flows = inventory.get("hubble-flows")
    if flows:
        add("hubble-flows", int(flows.get("occupied", 0)),
            int(flows.get("slots", 0)))
    # unbounded (host-rebuilt) tables: entries only, no pressure
    for name in ("ipcache", "ipcache6", "tunnel"):
        entry = inventory.get(name)
        if entry is not None:
            n = int(entry.get("entries", 0))
            maps[name] = {"occupied": n, "capacity": None,
                          "pressure": None}
            entries_g.set(float(n), labels={"map": name, **labels})
    for name, key in (("lb", "services"), ("lb6", "services")):
        entry = inventory.get(name)
        if entry is not None:
            n = int(entry.get(key, 0))
            maps[name] = {"occupied": n, "capacity": None,
                          "pressure": None}
            entries_g.set(float(n), labels={"map": name, **labels})
    out = {"maps": maps, "warnings": warnings,
           "warn-threshold": warn_threshold}
    if shard is not None:
        out["shard"] = shard
    return out
