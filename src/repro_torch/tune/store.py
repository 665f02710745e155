"""Persisted empirical cost observations: the tune subsystem's disk tier.

Counterpart of ``repro/tune/store.py``, with the same JSON document and
schema version, so ``tests/check_tune_schema.py`` pins both and a store
written by either package loads in the other. Per-``(op, backend,
dtype)`` curves of (size, wall-us) observations, aggregated into
quarter-log2 size bins with an EWMA over log-cost. dtypes are keyed by
``repro``'s numpy names (``"float32"``; a torch dtype drops its
``torch.`` prefix).

Loading is strict by default (a corrupt or old-schema file raises
``TuneStoreError``); the ambient runtime path (``repro_torch.tune.configure``)
uses ``load_or_cold`` and starts from an empty store.
"""
from __future__ import annotations

import json
import math
import os
import tempfile

SCHEMA_VERSION = 1

# quarter-octave size bins: observations within ~19% of each other in n
# share a bin, so steady traffic at one size converges to one EWMA cell
BINS_PER_OCTAVE = 4

# EWMA weight of a new observation against the bin's running log-cost
EWMA_ALPHA = 0.25


class TuneStoreError(RuntimeError):
    """The store file is corrupt, unreadable, or a different schema."""


def dtype_str(dtype) -> str:
    """A dtype as the store names it: numpy's name, for numpy and torch
    dtypes alike."""
    return str(dtype).removeprefix("torch.")


def _key(op: str, backend: str, dtype) -> str:
    return f"{op}|{backend}|{dtype_str(dtype)}"


class TuneStore:
    """Per-(op, backend, dtype) cost observations, binned by log2(size).

    ``observe`` feeds one measurement; ``samples`` returns the curve the
    cost model interpolates. The in-memory shape mirrors the JSON
    document exactly: ``keys[key][bin] = {log2n, log_us, count}`` where
    ``log2n``/``log_us`` are EWMA means and ``count`` the observation
    total (the model's confidence input).
    """

    def __init__(self):
        self.keys: dict[str, dict[str, dict]] = {}

    # ----------------------------------------------------------- feeding
    def observe(self, op: str, backend: str, dtype, n: int, us: float,
                weight: float = 1.0) -> None:
        """Record one measurement: ``op`` on ``backend`` over ``n``
        elements of ``dtype`` took ``us`` microseconds of wall time."""
        n = int(n)
        us = float(us)
        if n <= 0 or not math.isfinite(us) or us <= 0:
            return
        log2n = math.log2(n)
        log_us = math.log2(us)
        bins = self.keys.setdefault(_key(op, backend, dtype), {})
        b = str(int(round(log2n * BINS_PER_OCTAVE)))
        cell = bins.get(b)
        if cell is None:
            bins[b] = {"log2n": log2n, "log_us": log_us, "count": 1}
            return
        a = min(1.0, EWMA_ALPHA * float(weight))
        cell["log2n"] += a * (log2n - cell["log2n"])
        cell["log_us"] += a * (log_us - cell["log_us"])
        cell["count"] = int(cell["count"]) + 1

    def ingest_bench(self, records) -> int:
        """Seed/extend the store from BENCH_<suite>.json records.

        A record is ingestible when it names an explicit ``tune_op``
        (benchmarks that calibrate stamp one) or is an ``api_sort_*``
        backend-matrix record, and carries ``backend``/``size``/
        ``dtype``/``us_per_call``. Everything else (gate ratios, serve
        aggregates) is skipped — those numbers measure something other
        than one sort's wall cost. Returns the count ingested."""
        if isinstance(records, dict):
            records = records.get("records", [])
        n_in = 0
        for rec in records:
            if not isinstance(rec, dict):
                continue
            op = rec.get("tune_op")
            if op is None and str(rec.get("op", "")).startswith("api_sort_"):
                op = "sort"
            if op is None:
                continue
            backend, size, dtype = (rec.get("backend"), rec.get("size"),
                                    rec.get("dtype"))
            us = rec.get("us_per_call")
            if None in (backend, size, dtype, us):
                continue
            self.observe(str(op), str(backend), dtype_str(dtype), int(size),
                         float(us))
            n_in += 1
        return n_in

    # ----------------------------------------------------------- queries
    def samples(self, op: str, backend: str, dtype) -> list[tuple]:
        """The (log2n, log2us, count) curve for one key, sorted by size.
        Empty list when the store has never seen this key."""
        bins = self.keys.get(_key(op, backend, dtype), {})
        pts = [(float(c["log2n"]), float(c["log_us"]), int(c["count"]))
               for c in bins.values()]
        pts.sort()
        return pts

    def __len__(self) -> int:
        return sum(len(b) for b in self.keys.values())

    @property
    def total_count(self) -> int:
        return sum(int(c["count"])
                   for b in self.keys.values() for c in b.values())

    # ------------------------------------------------------- persistence
    def to_json(self) -> dict:
        return {"schema": SCHEMA_VERSION, "keys": self.keys}

    @classmethod
    def from_json(cls, obj) -> "TuneStore":
        if not isinstance(obj, dict):
            raise TuneStoreError(
                f"tune store document must be a JSON object, got "
                f"{type(obj).__name__}"
            )
        schema = obj.get("schema")
        if schema != SCHEMA_VERSION:
            raise TuneStoreError(
                f"tune store schema {schema!r} != supported "
                f"{SCHEMA_VERSION} — delete the file (it will recalibrate) "
                f"or regenerate it with `benchmarks.run --calibrate`"
            )
        keys = obj.get("keys")
        if not isinstance(keys, dict):
            raise TuneStoreError("tune store 'keys' must be an object")
        store = cls()
        for key, bins in keys.items():
            if not isinstance(bins, dict):
                raise TuneStoreError(f"tune store key {key!r}: not an object")
            clean: dict[str, dict] = {}
            for b, cell in bins.items():
                try:
                    clean[str(b)] = {
                        "log2n": float(cell["log2n"]),
                        "log_us": float(cell["log_us"]),
                        "count": int(cell["count"]),
                    }
                except (TypeError, KeyError, ValueError) as e:
                    raise TuneStoreError(
                        f"tune store key {key!r} bin {b!r} is malformed: {e}"
                    ) from e
            store.keys[str(key)] = clean
        return store

    def save(self, path: str) -> None:
        """Atomic write (tmp + rename): a crash mid-save can never leave
        a half-written store for the next load to choke on."""
        d = os.path.dirname(os.path.abspath(path)) or "."
        fd, tmp = tempfile.mkstemp(dir=d, prefix=".tune-", suffix=".json")
        try:
            with os.fdopen(fd, "w") as f:
                json.dump(self.to_json(), f, indent=1)
            os.replace(tmp, path)
        except BaseException:
            try:
                os.unlink(tmp)
            except OSError:
                pass
            raise

    @classmethod
    def load(cls, path: str) -> "TuneStore":
        """Strict load: raises ``TuneStoreError`` for corrupt JSON or a
        schema-version mismatch (and ``FileNotFoundError`` when absent)."""
        try:
            with open(path) as f:
                obj = json.load(f)
        except FileNotFoundError:
            raise
        except (OSError, ValueError) as e:
            raise TuneStoreError(f"cannot read tune store {path!r}: {e}") from e
        return cls.from_json(obj)

    @classmethod
    def load_or_cold(cls, path: str) -> tuple:
        """Runtime load: ``(store, reason)``. Missing/corrupt/old files
        come back as an empty (cold) store with the reason string — the
        ambient tuner must degrade to static behavior, never crash."""
        try:
            return cls.load(path), "loaded"
        except FileNotFoundError:
            return cls(), "cold: no store file"
        except TuneStoreError as e:
            return cls(), f"cold: {e}"
