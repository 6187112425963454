"""Host-side threat-model training from Hubble flow records.

Host copy of ``cilium_tpu/threat/trainer.py`` (numpy only): aggregated
flow records (``FlowTable.snapshot()`` rows) -> per-flow feature rows in
the SAME feature space the fused stage scores (model.FEATURES order)
-> a logistic scorer fit with plain numpy gradient descent -> quantized
int32 weights that hot-swap into the engine's live model tensors
(``Datapath.apply_threat_weights``) without a rebuild.

Labels: by default a flow is anomalous when its aggregated event code
is a drop (the dataplane already said no — the model learns to
predict policy/prefilter denials from traffic shape, the classic
DDoS-detector bootstrap) ; callers with better ground truth pass
``labels`` explicitly.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence

import numpy as np

from .model import (NUM_FEATURES, SCORE_MAX, ThreatConfig, ThreatModel,
                    linear_model)
from .oracle import log_bucket_np


def features_from_flow(flow: Dict, now: Optional[int] = None
                       ) -> np.ndarray:
    """One aggregated flow record (FlowTable.snapshot() /
    FlowRecord-shaped dict) -> the [NUM_FEATURES] int feature row.

    Flow records carry the per-flow half of the feature space
    (packets, bytes, recency, dport, proto); the per-packet-only
    lanes (SYN state, CT establishment, window aggregates) train at
    their neutral midpoint so their weights stay driven by the
    hand-seeded prior until per-packet ground truth exists."""
    pkts = int(flow.get("packets", 0))
    byts = int(flow.get("bytes", 0))
    dport = int(flow.get("dport", 0))
    proto = int(flow.get("proto", 0))
    last = int(flow.get("last-seen", 0))
    now = int(now) if now is not None else last
    f = np.zeros(NUM_FEATURES, np.int32)
    f[0] = 15 * int(log_bucket_np(np.array([pkts]))[0])
    f[1] = 15 * int(log_bucket_np(np.array([byts]))[0])
    f[2] = min(max(now - last, 0), SCORE_MAX)
    f[3] = 0                              # syn-no-established
    f[4] = SCORE_MAX if pkts > 1 else 0   # multi-packet ~ established
    f[5] = 0                              # window lanes: per-packet only
    f[6] = 0
    f[7] = min(dport >> 8, SCORE_MAX)
    f[8] = SCORE_MAX if proto == 17 else 0
    f[9] = 15 * int(log_bucket_np(
        np.array([byts // max(pkts, 1)]))[0])
    f[10] = SCORE_MAX if flow.get("src-identity") == 2 or \
        flow.get("dst-identity") == 2 else 0
    f[11] = 0
    return f


def label_from_flow(flow: Dict) -> int:
    """Default label: the flow aggregated under a drop event code."""
    return 1 if int(flow.get("event", 0)) < 0 else 0


class ThreatTrainer:
    """Logistic scorer fit in plain numpy (optax-lite: full-batch
    gradient descent with momentum), emitting a quantized linear
    ThreatModel whose integer forward pass spans the 0..255 score
    range."""

    def __init__(self, lr: float = 0.5, epochs: int = 300,
                 momentum: float = 0.9, l2: float = 1e-3):
        self.lr = lr
        self.epochs = epochs
        self.momentum = momentum
        self.l2 = l2
        self.last_report: Dict = {}

    def fit(self, flows: Sequence[Dict],
            labels: Optional[Sequence[int]] = None,
            now: Optional[int] = None,
            config: Optional[ThreatConfig] = None) -> ThreatModel:
        """Fit over aggregated flow records; returns the quantized
        model (generation carried from ``config``)."""
        flows = list(flows)
        if not flows:
            raise ValueError("no flows to train on")
        x = np.stack([features_from_flow(f, now) for f in flows]) \
            .astype(np.float64) / SCORE_MAX
        y = np.array([label_from_flow(f) for f in flows], np.float64) \
            if labels is None else np.array(labels, np.float64)
        # class-balanced weighting: anomalous flows are usually the
        # small-packet minority — letting high-volume allowed flows
        # dominate the loss would train the scorer to say "normal"
        pos = max(float((y > 0.5).sum()), 1.0)
        neg = max(float((y <= 0.5).sum()), 1.0)
        sample_w = np.where(y > 0.5, 0.5 / pos, 0.5 / neg)
        w = np.zeros(NUM_FEATURES)
        bias = 0.0
        vw = np.zeros_like(w)
        vb = 0.0
        for _ in range(self.epochs):
            z = x @ w + bias
            pred = 1.0 / (1.0 + np.exp(-np.clip(z, -30, 30)))
            err = (pred - y) * sample_w
            gw = x.T @ err + self.l2 * w
            gb = float(err.sum())
            vw = self.momentum * vw - self.lr * gw
            vb = self.momentum * vb - self.lr * gb
            w += vw
            bias += vb
        z = x @ w + bias
        pred = 1.0 / (1.0 + np.exp(-np.clip(z, -30, 30)))
        acc = float(((pred > 0.5) == (y > 0.5)).mean())
        # Quantize: the stage computes ((f_int @ w_q) >> 8) + b_q with
        # f_int = f * 255, so w_q = w * 256 / 255 * GAIN maps the
        # logit onto the integer lane; GAIN spreads z in [-4, 4] over
        # the 0..255 score range around midpoint 128.
        gain = 32.0
        w_q = w * 256.0 / SCORE_MAX * gain
        b_q = bias * gain + 128.0
        model = linear_model(w_q, bias=b_q,
                             config=config or ThreatConfig())
        self.last_report = {
            "flows": len(flows),
            "positives": int((y > 0.5).sum()),
            "train-accuracy": round(acc, 4),
            "weights-l2": round(float(np.sqrt((w ** 2).sum())), 4),
            "generation": model.config.generation,
        }
        return model
