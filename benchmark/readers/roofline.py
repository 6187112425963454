"""A stage's share of its roofline, in percent: the least time the card
could take for the stage's work (bytes from the batch's shapes over the
card's peak memory bandwidth, in ``benchmark/peaks.json``) over the
device time the stage took.

``spec["bytes"]``: ``per_row`` bytes of [B] vectors read or written once
and ``per_lane_element`` bytes of each [B, W] lane element read once.
None where the stage did not run, or the card has no peak in the table.
"""

import json
from pathlib import Path

PEAKS = Path(__file__).resolve().parent.parent / "peaks.json"


def read(trace, spec, run):
    ms = trace.stage_ms(spec["stage"])
    peak = json.loads(PEAKS.read_text()).get(run["kind"], {}) \
        .get("hbm_bytes_per_s")
    if ms is None or not peak:
        return None
    width = run["lane_width"] or 0
    work = run["batch"] * (spec["bytes"]["per_row"] +
                           width * spec["bytes"]["per_lane_element"])
    return 100.0 * (work / peak) / (ms / 1e3)
