"""Log-log interpolated cost curves with confidence.

Counterpart of ``repro/tune/model.py``, the same arithmetic.

Sorting cost is near power-law in n (`us ≈ c·n^k`), so a straight line
through (log2 n, log2 us) observations is an excellent local model and
piecewise-linear interpolation between measured size bins is strictly
better where the curve bends (e.g. at cache/HBM cliffs). ``CostModel``
wraps a :class:`~repro_torch.tune.store.TuneStore` and answers two questions:

* ``predict(op, backend, dtype, n)`` — expected wall-us and a
  confidence in [0, 1] that discounts thin data and extrapolation.
* ``choose(op, candidates, dtype, n)`` — the predicted-fastest backend,
  or ``None`` unless *every* candidate clears the confidence bar. The
  planner treats ``None`` as "stay on the static rules": a model that
  has only measured one side of a decision must not flip it.
"""
from __future__ import annotations

import math

from .store import TuneStore

MODEL_VERSION = 1

# a curve needs this many total observations before predictions count
MIN_COUNT = 3

# confidence saturates once a curve holds this many observations
FULL_COUNT = 6

# planner default: act on the model only above this confidence
MIN_CONFIDENCE = 0.5

# confidence penalty when the curve is a single bin (slope is assumed,
# not measured)
SINGLE_BIN_PENALTY = 0.3

# assumed d(log2 us)/d(log2 n) when extrapolating from a single point:
# ~linear in n, the right asymptote for a bandwidth-bound sort pipeline
DEFAULT_SLOPE = 1.0


class Prediction:
    """One backend's predicted cost at one size."""

    __slots__ = ("us", "confidence", "extrapolated")

    def __init__(self, us: float, confidence: float, extrapolated: float):
        self.us = float(us)
        self.confidence = float(confidence)
        self.extrapolated = float(extrapolated)  # octaves beyond data

    def __repr__(self):
        return (f"Prediction(us={self.us:.1f}, "
                f"confidence={self.confidence:.2f})")


class CostModel:
    def __init__(self, store: TuneStore):
        self.store = store

    def predict(self, op: str, backend: str, dtype, n: int):
        """Predicted cost, or ``None`` when the store has never seen
        this (op, backend, dtype) at all."""
        pts = self.store.samples(op, backend, dtype)
        if not pts or n <= 0:
            return None
        x = math.log2(n)
        xs = [p[0] for p in pts]
        ys = [p[1] for p in pts]
        total = sum(p[2] for p in pts)

        if len(pts) == 1:
            y = ys[0] + DEFAULT_SLOPE * (x - xs[0])
            dist = abs(x - xs[0])
        elif x <= xs[0]:
            slope = (ys[1] - ys[0]) / max(xs[1] - xs[0], 1e-9)
            y = ys[0] + slope * (x - xs[0])
            dist = xs[0] - x
        elif x >= xs[-1]:
            slope = (ys[-1] - ys[-2]) / max(xs[-1] - xs[-2], 1e-9)
            y = ys[-1] + slope * (x - xs[-1])
            dist = x - xs[-1]
        else:
            y = _interp(x, xs, ys)
            dist = 0.0

        conf = min(1.0, total / float(FULL_COUNT))
        if total < MIN_COUNT:
            conf = min(conf, 0.2)
        if len(pts) == 1:
            conf *= SINGLE_BIN_PENALTY
        # each octave of extrapolation halves confidence
        conf *= 0.5 ** dist
        return Prediction(2.0 ** y, max(0.0, min(1.0, conf)), dist)

    def choose(self, op: str, candidates, dtype, n: int,
               min_confidence: float = MIN_CONFIDENCE):
        """``(winner, {backend: Prediction|None})``. ``winner`` is None
        unless every candidate has a prediction above the bar — the
        model only overrides static rules when it can rank all options."""
        preds = {b: self.predict(op, b, dtype, n) for b in candidates}
        usable = all(p is not None and p.confidence >= min_confidence
                     for p in preds.values())
        if not usable:
            return None, preds
        winner = min(preds, key=lambda b: preds[b].us)
        return winner, preds


def _interp(x: float, xs, ys) -> float:
    for i in range(1, len(xs)):
        if x <= xs[i]:
            t = (x - xs[i - 1]) / max(xs[i] - xs[i - 1], 1e-9)
            return ys[i - 1] + t * (ys[i] - ys[i - 1])
    return ys[-1]
