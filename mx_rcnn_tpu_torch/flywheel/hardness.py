"""The hardness of a served image (counterpart of
``mx_rcnn_tpu/flywheel/hardness.py``, with its own copy of ``SCORE_BANDS``
and ``score_stats`` from ``mx_rcnn_tpu/flywheel/capture.py``).

One scalar folded from three signals of the detections: the normalised
entropy of the score mass, the falloff of survivors between the loose and
the strict :data:`SCORE_BANDS`, and a weak best guess (1 − the top score).
The cascade's gate escalates an image to the big model when its hardness
clears the threshold; the JAX package's miner ranks captured images by the
same scalar.

- :func:`hardness` / :func:`hardness_from_records`: the host form, from
  detection records (float64 numpy).
- :func:`build_device_hardness`: the same fold in plain torch over the
  ``(B, cap, 6)`` detections and ``(B, cap)`` validity that
  ``Predictor.predict_serve_e2e`` leaves on the device → ``(B,)`` float32,
  so the gate reads back B floats instead of the detections.
"""

from __future__ import annotations

import numpy as np
import torch

# score thresholds of the survivor-falloff signal: how many detections
# survive at adjacent operating points
SCORE_BANDS = (0.3, 0.5, 0.7)

# signal weights: entropy and disagreement dominate, low max breaks ties
W_ENTROPY = 1.0
W_DISAGREE = 1.0
W_LOW_MAX = 0.5

# the hardness scale's upper bound (every signal saturated).  The cascade
# threshold is a fraction of it, so thresh 0 escalates everything and 1
# nothing: entropy 1 needs a uniform positive score mass, so max_score > 0
# and the bound itself is never reached
HARDNESS_MAX = W_ENTROPY + W_DISAGREE + W_LOW_MAX


def score_stats(records) -> dict:
    """Per-image signals from detection records: count, max and mean
    score, the score mass's entropy normalised by log(count), and the
    survivor count at each of :data:`SCORE_BANDS`."""
    scores = np.asarray([float(r["score"]) for r in records], np.float64)
    n = scores.size
    stats = {"count": int(n), "max_score": 0.0, "mean_score": 0.0,
             "entropy": 0.0,
             "bands": {f"{t:.1f}": 0 for t in SCORE_BANDS}}
    if n == 0:
        return stats
    stats["max_score"] = float(scores.max())
    stats["mean_score"] = float(scores.mean())
    if n > 1 and scores.sum() > 0:
        p = scores / scores.sum()
        p = p[p > 0]
        stats["entropy"] = float(-(p * np.log(p)).sum() / np.log(n))
    for t in SCORE_BANDS:
        stats["bands"][f"{t:.1f}"] = int((scores >= t).sum())
    return stats


def hardness(stats: dict):
    """(hardness, its three terms) of one image from its score stats."""
    bands = stats.get("bands", {})
    loose = bands.get(f"{SCORE_BANDS[0]:.1f}", 0)
    strict = bands.get(f"{SCORE_BANDS[-1]:.1f}", 0)
    disagree = (loose - strict) / max(1, loose)
    entropy = float(stats.get("entropy", 0.0))
    low_max = 1.0 - float(stats.get("max_score", 0.0))
    score = W_ENTROPY * entropy + W_DISAGREE * disagree + W_LOW_MAX * low_max
    return score, {"entropy": entropy, "disagreement": disagree,
                   "low_max": low_max}


def hardness_from_records(records) -> float:
    """The host reference: detection records → hardness, which the device
    gate must agree with on the same detections."""
    score, _ = hardness(score_stats(records))
    return score


def build_device_hardness():
    """The cascade gate: ``fn(dets (B, cap, 6), valid (B, cap)) → (B,)``
    float32 on the detections' device, term by term
    :func:`score_stats` + :func:`hardness` in float32 (the host is
    float64, so the two agree to float32 rounding):

    - entropy over the valid rows' score mass, normalised by log(n), 0
      when n <= 1 or the mass is empty;
    - disagreement ``(loose − strict) / max(1, loose)``;
    - low max ``1 − max_score``."""
    loose_t = float(SCORE_BANDS[0])
    strict_t = float(SCORE_BANDS[-1])

    def fn(dets: torch.Tensor, valid: torch.Tensor) -> torch.Tensor:
        v = valid.to(torch.float32)
        s = dets[..., 4].to(torch.float32) * v         # zeros off the mask
        n = v.sum(dim=-1)
        total = s.sum(dim=-1)
        max_score = s.amax(dim=-1)
        p = s / torch.where(total > 0, total, 1.0)[..., None]
        plogp = torch.where(p > 0, p * torch.log(torch.where(p > 0, p, 1.0)),
                            0.0)
        raw_ent = -plogp.sum(dim=-1) / torch.log(torch.clamp(n, min=2.0))
        entropy = torch.where((n > 1) & (total > 0), raw_ent, 0.0)
        on = v > 0
        loose = ((s >= loose_t) & on).sum(dim=-1).to(torch.float32)
        strict = ((s >= strict_t) & on).sum(dim=-1).to(torch.float32)
        disagree = (loose - strict) / torch.clamp(loose, min=1.0)
        low_max = 1.0 - max_score
        return (W_ENTROPY * entropy + W_DISAGREE * disagree
                + W_LOW_MAX * low_max).to(torch.float32)

    return fn
