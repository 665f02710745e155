"""repro_torch.tune: the empirical cost model and the adaptive control plane.

Counterpart of ``repro.tune``:

* :mod:`~repro_torch.tune.store`: persisted per-(op, size, dtype, backend)
  cost observations (``repro``'s JSON schema), updated online from
  ``SortOutput`` timings;
* :mod:`~repro_torch.tune.model`: log-log interpolated cost curves with
  confidence; the planner consults them at dispatch time;
* :mod:`~repro_torch.tune.adapt`: the serve-side feedback controller
  that tunes ``SortServer`` flush parameters against a p99 objective.

Nothing here activates by itself. The planner, the overflow ladder and
the result-side recorder ask :func:`current` for the ambient
:class:`Tuner` and do exactly what they did before when it is ``None``
(the default), or when its store is cold or low-confidence.
:func:`configure` installs a tuner backed by a store file; :func:`active`
scopes one to a ``with`` block.

A sort's wall time is recorded once its output is complete on the
device: with a tuner present, ``planner.execute_request`` fences the
result's CUDA device before :func:`record_sort`, so the model learns the
time to run a sort, not the time to enqueue it.
"""
from __future__ import annotations

import contextlib
import os
import threading

from repro_torch.obs import metrics as _metrics
from repro_torch.tune.adapt import AdaptConfig, AdaptiveController
from repro_torch.tune.model import MIN_CONFIDENCE, MODEL_VERSION, CostModel, Prediction
from repro_torch.tune.store import SCHEMA_VERSION, TuneStore, TuneStoreError, dtype_str

__all__ = [
    "AdaptConfig", "AdaptiveController", "CostModel", "Prediction",
    "TuneStore", "TuneStoreError", "Tuner", "COST_MODEL_VERSION",
    "DEFAULT_STORE_PATH", "active", "configure", "current", "disable",
    "record_sort",
]

COST_MODEL_VERSION = f"tune-{SCHEMA_VERSION}.{MODEL_VERSION}"

DEFAULT_STORE_PATH = os.environ.get("REPRO_TUNE_STORE", ".repro_tune.json")

_C_OBSERVATIONS = _metrics.counter(
    "repro_tune_observations_total",
    "Cost observations recorded into the tune store, by op.",
    labels=("op",),
)
_C_PLANS = _metrics.counter(
    "repro_tune_plans_total",
    "Planner decisions while a tuner was active, by cost source.",
    labels=("source",),  # model|static
)


class Tuner:
    """An installed store + model pair, plus its runtime knobs.

    min_confidence: the bar every candidate's prediction must clear
      before the planner acts on the model instead of the static rules.
    autosave_every: persist the store back to ``path`` every N
      observations (0 disables; explicit ``save()`` always works).
    """

    def __init__(self, store: TuneStore | None = None, *,
                 path: str | None = None,
                 min_confidence: float = MIN_CONFIDENCE,
                 autosave_every: int = 0):
        self.store = store if store is not None else TuneStore()
        self.model = CostModel(self.store)
        self.path = path
        self.min_confidence = float(min_confidence)
        self.autosave_every = int(autosave_every)
        self._lock = threading.Lock()
        self._since_save = 0

    def observe(self, op: str, backend: str, dtype, n: int, us: float) -> None:
        with self._lock:
            self.store.observe(op, backend, dtype, n, us)
            self._since_save += 1
            flush = (self.autosave_every and self.path
                     and self._since_save >= self.autosave_every)
            if flush:
                self._since_save = 0
        _C_OBSERVATIONS.labels(op=op).inc()
        if flush:
            try:
                self.store.save(self.path)
            except OSError:
                pass  # an unwritable store path must never fail a sort

    def save(self, path: str | None = None) -> str:
        p = path or self.path or DEFAULT_STORE_PATH
        self.store.save(p)
        return p


_ambient: Tuner | None = None
_ambient_lock = threading.Lock()


def current() -> Tuner | None:
    """The ambient tuner, or None: the everything-static default."""
    return _ambient


def install(tuner: Tuner | None) -> Tuner | None:
    """Install (or with None, remove) the ambient tuner; returns it."""
    global _ambient
    with _ambient_lock:
        _ambient = tuner
    return tuner


def disable() -> None:
    install(None)


def configure(path: str = DEFAULT_STORE_PATH, *, bench=(),
              min_confidence: float = MIN_CONFIDENCE,
              autosave_every: int = 0) -> Tuner:
    """Install a tuner backed by the store file at ``path``.

    A missing or damaged file yields a cold store (static behavior until
    observations accumulate), never an error. ``bench`` optionally names
    ``BENCH_*.json`` files whose records seed the store on first load, as
    in ``repro``; those files hold times of other devices, so a store
    meant for the card is warmed by the card's own sorts instead."""
    import json

    store, _ = TuneStore.load_or_cold(path)
    if len(store) == 0:
        for b in bench:
            try:
                with open(b) as f:
                    store.ingest_bench(json.load(f))
            except (OSError, ValueError):
                continue
    return install(Tuner(store, path=path, min_confidence=min_confidence,
                         autosave_every=autosave_every))


@contextlib.contextmanager
def active(store_or_tuner):
    """Scope a tuner (or a bare TuneStore) as the ambient one."""
    tuner = (store_or_tuner if isinstance(store_or_tuner, Tuner)
             else Tuner(store_or_tuner))
    prev = _ambient
    install(tuner)
    try:
        yield tuner
    finally:
        install(prev)


def note_plan(source: str) -> None:
    """Planner hook: count one dispatch decision by cost source."""
    _C_PLANS.labels(source=source).inc()


def record_sort(meta, elapsed_s: float) -> None:
    """Result hook: feed one completed top-level sort's wall time back
    into the ambient store (no-op when no tuner is installed); when the
    plan predicted the backend that ran, park the predicted-vs-actual
    pair in the flight recorder."""
    tuner = _ambient
    if tuner is None or not meta.n:
        return
    tuner.observe("sort", meta.backend, dtype_str(meta.dtype), int(meta.n),
                  elapsed_s * 1e6)
    predicted = getattr(meta.plan, "cost_predicted", None) or {}
    if meta.backend in predicted:
        from repro_torch.obs import flight as _flight

        _flight.RECORDER.record_prediction(
            "sort", meta.backend, int(meta.n),
            predicted[meta.backend]["us"], elapsed_s * 1e6)
