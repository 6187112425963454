"""Checkpoint/state migration across incompatible versions.

Reference: bpf/cilium-map-migrate.c — a standalone tool invoked by
init.sh around agent upgrades that rewrites pinned BPF maps whose
struct layout changed between versions, so state survives the upgrade
instead of being dropped.

TPU translation of the problem: device tables here are DERIVED state
(recompiled from the policy repo / checkpoints at startup), so nothing
device-resident needs migrating — what persists across agent versions
are the host-side endpoint checkpoints (``ep_*.json``,
endpoint.py:write_checkpoint, the pinned-map analog).  This module
versions that schema and carries old checkpoints forward:

  * version 0 — the earliest layout: ``realized`` entries were packed
    key strings ``"identity:dport:proto:dir"`` -> proxy_port;
  * version 1 — entries became explicit dicts, but the snapshot had no
    ``version`` field (version is implied by its absence);
  * version 2 — current: explicit ``version`` + ``family`` (address
    family, for v6 endpoints).

``migrate_snapshot`` upgrades any supported version to current (the
chain runs one step at a time, like the C tool's per-map rewrite);
``migrate_state_dir`` is the standalone-tool entry (cilium
migrate-state) that upgrades a state directory in place with .bak
safety copies.  A snapshot from a NEWER version fails loudly — a
downgrade must not silently mis-parse state.

A whole copy of ``cilium_tpu/migrate.py``.
"""

from __future__ import annotations

import json
import os
from typing import Callable, Dict, List, Tuple

CHECKPOINT_VERSION = 2


class MigrationError(RuntimeError):
    pass


def _detect_version(snapshot: Dict) -> int:
    if "version" in snapshot:
        return int(snapshot["version"])
    realized = snapshot.get("realized")
    if isinstance(realized, dict):
        return 0  # packed-string map layout
    return 1      # dict-entry layout, pre-versioning


def _migrate_v0_to_v1(snap: Dict) -> Dict:
    """Packed ``"identity:dport:proto:dir" -> proxy_port`` map to the
    explicit entry-dict list."""
    out = dict(snap)
    entries = []
    for key, proxy_port in (snap.get("realized") or {}).items():
        parts = str(key).split(":")
        if len(parts) != 4:
            raise MigrationError(f"v0 realized key malformed: {key!r}")
        entries.append({
            "identity": int(parts[0]), "dest_port": int(parts[1]),
            "nexthdr": int(parts[2]), "direction": int(parts[3]),
            "proxy_port": int(proxy_port)})
    out["realized"] = entries
    return out


def _migrate_v1_to_v2(snap: Dict) -> Dict:
    out = dict(snap)
    out["version"] = 2
    out.setdefault("family", 4)
    return out


MIGRATIONS: Dict[int, Callable[[Dict], Dict]] = {
    0: _migrate_v0_to_v1,
    1: _migrate_v1_to_v2,
}


def migrate_snapshot(snapshot: Dict) -> Dict:
    """Upgrade a checkpoint to CHECKPOINT_VERSION (no-op when
    current).  Raises MigrationError for unknown/newer versions AND
    for corrupt snapshots — malformed data must surface as a
    migration failure the callers' skip-one-file handling catches,
    not as a stray TypeError that aborts the whole restore."""
    try:
        version = _detect_version(snapshot)
        if version > CHECKPOINT_VERSION:
            raise MigrationError(
                f"checkpoint version {version} is newer than this "
                f"agent's {CHECKPOINT_VERSION}; refusing to guess at "
                f"its layout")
        while version < CHECKPOINT_VERSION:
            step = MIGRATIONS.get(version)
            if step is None:
                raise MigrationError(
                    f"no migration from version {version}")
            snapshot = step(snapshot)
            version = _detect_version(snapshot) \
                if "version" not in snapshot \
                else int(snapshot["version"])
        return snapshot
    except MigrationError:
        raise
    except (TypeError, AttributeError, ValueError, KeyError) as e:
        raise MigrationError(f"corrupt checkpoint: {e!r}") from e


def migrate_state_dir(state_dir: str,
                      keep_backup: bool = True
                      ) -> Tuple[int, int, List[str]]:
    """Upgrade every ``ep_*.json`` in place (the cilium-map-migrate
    invocation from init.sh).  Returns (migrated, already_current,
    skipped_names).  Files that fail to parse/migrate are left
    untouched and REPORTED in skipped — a bad file must not block the
    rest, but an operator running the tool after a downgrade must see
    that nothing was migrated rather than a quiet success."""
    migrated = current = 0
    skipped: List[str] = []
    if not os.path.isdir(state_dir):
        return 0, 0, []
    for fname in sorted(os.listdir(state_dir)):
        if not (fname.startswith("ep_") and fname.endswith(".json")):
            continue
        path = os.path.join(state_dir, fname)
        try:
            with open(path) as f:
                raw = f.read()
            snap = json.loads(raw)
            if _detect_version(snap) == CHECKPOINT_VERSION:
                current += 1
                continue
            upgraded = migrate_snapshot(snap)
            # write-then-swap ordering: the live checkpoint is only
            # ever replaced atomically AFTER the new content is fully
            # on disk, and the backup is a copy — a failure at any
            # point leaves the original in place
            if keep_backup:
                bak = path + ".bak"
                with open(bak + ".tmp", "w") as f:
                    f.write(raw)
                os.replace(bak + ".tmp", bak)
            tmp = path + ".tmp"
            with open(tmp, "w") as f:
                json.dump(upgraded, f, indent=1, sort_keys=True)
            os.replace(tmp, path)
        except (OSError, ValueError, MigrationError):
            skipped.append(fname)
            continue
        migrated += 1
    return migrated, current, skipped
