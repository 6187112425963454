"""The threat scorer: a small quantized model + its verdict config.

Host copy of ``cilium_tpu/threat/model.py`` (numpy only).

Everything here is integer fixed-point by design:

- the fused pipeline stage (``stage.py``) and the numpy oracle
  (``oracle.py``) must agree BIT-exactly across backends, which rules
  out float accumulation order games — all scoring math is int32 with
  Q8.8 weights and an explicit ``>> 8`` requantize between layers.

Score range is 0..SCORE_MAX (255).  Features are 0..255 int32 lanes
(``stage.py`` FEATURES order); weights are int32 clamped to +/-32767
(Q8.8: value 256 == 1.0).  The forward pass:

    h = clip(((f @ w1) >> 8) + b1, 0, 255)      # [B, H]
    s = clip(((h @ w2) >> 8) + b2, 0, 255)      # [B]

A linear model is the H=1 special case with w2=[256] (identity pass-
through), which is what the trainer emits by default.

The model lives on the device as five int32 table tensors — w1, b1, w2,
b2 and the [8] config vector — so a weight push of the same geometry or
a threshold/mode flip is an in-place copy into the live tensors (engine
``apply_threat_weights`` / ``set_threat_config``), never a rebuild.
"""

from __future__ import annotations

from dataclasses import dataclass, field, replace
from typing import Dict, Optional, Tuple

import numpy as np

SCORE_MAX = 255
WEIGHT_Q = 8                  # Q8.8 fixed point: 256 == 1.0
WEIGHT_MAX = 32767            # weights clamp to int16 range ("quantized")

# Feature lanes of the fused stage, in order.  Each is an int32 in
# [0, 255]; log-bucketed lanes use 15 * floor-log2-ish buckets (see
# stage.log_bucket) so their exactness survives any backend.
FEATURES = (
    "flow-packets-log",    # Hubble flow-table probe: per-flow packets
    "flow-bytes-log",      # per-flow bytes
    "flow-recency",        # seconds since the flow's last-seen (255 =
    #                        no flow entry / flows disabled)
    "syn-no-established",  # TCP SYN on a not-established flow
    "established",         # CT fast-path hit
    "newflow-rate-log",    # per-identity new flows in the claim window
    "port-spread-log",     # per-identity dport span in the window
    #                        (port-entropy-style scan signal)
    "dport-high",          # dport >> 8 (ephemeral/port-walk signal)
    "is-udp",
    "pkt-len-log",
    "is-world",            # peer identity resolved to WORLD
    "is-fragment",
)
NUM_FEATURES = len(FEATURES)

# tm_cfg vector layout ([8] int32): the policy-controlled verdict
# knobs, read by the stage as device VALUES, so a shadow<->enforce flip
# or a threshold change is a tensor write, never a rebuild.
CFG_ENFORCE = 0        # 0 = shadow (score-only), 1 = enforce
CFG_DROP = 1           # score >= this -> drop arm (0 disables)
CFG_REDIRECT = 2       # score >= this -> redirect arm (0 disables)
CFG_RATELIMIT = 3      # score >= this -> rate-limit arm (0 disables)
CFG_REDIRECT_PORT = 4  # the proxy port the redirect arm answers
CFG_RATE_Q8 = 5        # token-bucket refill (tokens/sec, Q8.8)
CFG_BURST = 6          # token-bucket capacity (whole tokens)
CFG_GENERATION = 7     # model generation (bumped per weight push)

CFG_LEN = 8


@dataclass(frozen=True)
class ThreatConfig:
    """Policy-controlled thresholds + mode.  Default: shadow (score-
    only) with every enforcement arm disabled — a pushed model can
    never deny traffic the policy allows until an operator opts in."""

    mode: str = "shadow"          # "shadow" | "enforce"
    drop_score: int = 0
    redirect_score: int = 0
    ratelimit_score: int = 0
    redirect_port: int = 0
    rate_per_s: float = 256.0
    burst: int = 1024
    generation: int = 1

    def encode(self) -> np.ndarray:
        cfg = np.zeros(CFG_LEN, np.int32)
        cfg[CFG_ENFORCE] = 1 if self.mode == "enforce" else 0
        cfg[CFG_DROP] = int(self.drop_score)
        cfg[CFG_REDIRECT] = int(self.redirect_score)
        cfg[CFG_RATELIMIT] = int(self.ratelimit_score)
        cfg[CFG_REDIRECT_PORT] = int(self.redirect_port)
        cfg[CFG_RATE_Q8] = min(1 << 16,
                               max(0, int(round(self.rate_per_s * 256))))
        cfg[CFG_BURST] = min(1 << 20, max(1, int(self.burst)))
        cfg[CFG_GENERATION] = int(self.generation)
        return cfg

    @classmethod
    def decode(cls, cfg) -> "ThreatConfig":
        c = [int(x) for x in cfg]
        return cls(mode="enforce" if c[CFG_ENFORCE] else "shadow",
                   drop_score=c[CFG_DROP], redirect_score=c[CFG_REDIRECT],
                   ratelimit_score=c[CFG_RATELIMIT],
                   redirect_port=c[CFG_REDIRECT_PORT],
                   rate_per_s=c[CFG_RATE_Q8] / 256.0,
                   burst=c[CFG_BURST], generation=c[CFG_GENERATION])

    def describe(self) -> Dict:
        return {"mode": self.mode, "drop-score": self.drop_score,
                "redirect-score": self.redirect_score,
                "ratelimit-score": self.ratelimit_score,
                "redirect-port": self.redirect_port,
                "rate-per-s": self.rate_per_s, "burst": self.burst,
                "generation": self.generation}


def _quant(w, lo=-WEIGHT_MAX, hi=WEIGHT_MAX) -> np.ndarray:
    return np.clip(np.rint(np.array(w, np.float64)), lo, hi) \
        .astype(np.int32)


@dataclass
class ThreatModel:
    """One quantized scorer generation + its verdict config.

    ``w1`` [F, H], ``b1`` [H], ``w2`` [H], ``b2`` scalar — all int32
    Q8.8.  ``tables()`` emits the five device tables; a same-geometry
    replacement hot-swaps by copies into the live tensors."""

    w1: np.ndarray
    b1: np.ndarray
    w2: np.ndarray
    b2: int = 0
    config: ThreatConfig = field(default_factory=ThreatConfig)

    def __post_init__(self):
        self.w1 = _quant(self.w1).reshape(NUM_FEATURES, -1)
        self.b1 = _quant(self.b1, -(1 << 20), 1 << 20).reshape(-1)
        self.w2 = _quant(self.w2).reshape(-1)
        self.b2 = int(np.clip(self.b2, -(1 << 20), 1 << 20))
        if self.w1.shape[1] != self.b1.shape[0] or \
                self.b1.shape[0] != self.w2.shape[0]:
            raise ValueError("inconsistent threat-model geometry: "
                             f"w1 {self.w1.shape} b1 {self.b1.shape} "
                             f"w2 {self.w2.shape}")

    @property
    def hidden(self) -> int:
        return int(self.w1.shape[1])

    @property
    def geometry(self) -> Tuple[int, int]:
        return (NUM_FEATURES, self.hidden)

    def tables(self) -> Dict[str, np.ndarray]:
        """The five int32 device tables of the model."""
        return {"tm_w1": self.w1, "tm_b1": self.b1, "tm_w2": self.w2,
                "tm_b2": np.array([self.b2], np.int32),
                "tm_cfg": self.config.encode()}

    def score(self, features: np.ndarray) -> np.ndarray:
        """The exact integer forward pass over [B, F] feature rows —
        the host twin of the fused stage's scorer (oracle.py builds
        its parity expectation from this)."""
        f = np.array(features, np.int32).reshape(-1, NUM_FEATURES)
        z1 = ((f.astype(np.int64) @ self.w1.astype(np.int64)) >> WEIGHT_Q
              ).astype(np.int32) + self.b1
        h = np.clip(z1, 0, SCORE_MAX)
        z2 = ((h.astype(np.int64) @ self.w2.astype(np.int64)) >> WEIGHT_Q
              ).astype(np.int32) + np.int32(self.b2)
        return np.clip(z2, 0, SCORE_MAX).astype(np.int32)

    def with_config(self, config: ThreatConfig) -> "ThreatModel":
        return replace(self, config=config)

    def nbytes(self) -> int:
        return int(self.w1.nbytes + self.b1.nbytes + self.w2.nbytes
                   + 4 + CFG_LEN * 4)

    def describe(self) -> Dict:
        return {"features": NUM_FEATURES, "hidden": self.hidden,
                "resident-bytes": self.nbytes(),
                "config": self.config.describe()}


def linear_model(weights, bias: float = 0.0,
                 config: Optional[ThreatConfig] = None) -> ThreatModel:
    """A linear scorer as the H=1 special case: layer 2 is the Q8.8
    identity (w2 = [256], b2 = 0), so score == layer-1 output."""
    w = np.array(weights, np.float64).reshape(NUM_FEATURES, 1)
    return ThreatModel(w1=w, b1=np.array([bias]), w2=np.array([256]),
                       b2=0, config=config or ThreatConfig())


def default_model(config: Optional[ThreatConfig] = None) -> ThreatModel:
    """The hand-tuned bootstrap scorer shipped before any training:
    weights anomaly-shaped signals (SYN floods, new-flow storms, port
    scans, WORLD-sourced traffic) so shadow mode is useful on day one.
    A trained model replaces it through the same hot-swap path."""
    w = np.zeros(NUM_FEATURES, np.float64)
    by = {name: i for i, name in enumerate(FEATURES)}
    w[by["syn-no-established"]] = 140    # Q8.8: ~0.55 per 255-lane
    w[by["newflow-rate-log"]] = 120
    w[by["port-spread-log"]] = 110
    w[by["is-world"]] = 40
    w[by["flow-recency"]] = 20
    w[by["established"]] = -120          # long-lived flows score low
    w[by["flow-packets-log"]] = -30
    return linear_model(w, bias=0.0, config=config)
