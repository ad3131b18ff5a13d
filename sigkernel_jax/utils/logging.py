"""Structured logging: JSON-lines metric events + a std-logging bridge.

The reference reports progress with bare prints scattered through its
examples; this gives the library one sink for machine-readable metrics
(training curves, benchmark stages, validation results):

- ``log_event(event, **fields)`` appends one JSON object per call to
  ``$SIGKERNEL_LOG_FILE`` (if set) and mirrors it through a standard
  ``logging.Logger`` at INFO, so callers plug into any logging config.
- ``get_logger(name)`` returns a namespaced child of the ``sigkernel_jax``
  logger (lazily given a stderr handler unless the app configured one).

Events carry a monotonic ``t`` (seconds since process start) instead of a
wall-clock string so diffs between lines are meaningful under NTP jumps.
"""
from __future__ import annotations

import json
import logging
import os
import time

_T0 = time.monotonic()
_ROOT = "sigkernel_jax"


def get_logger(name: str = "") -> logging.Logger:
    root = logging.getLogger(_ROOT)
    if not root.handlers and not logging.getLogger().handlers:
        h = logging.StreamHandler()
        h.setFormatter(logging.Formatter(
            "%(asctime)s %(name)s %(levelname)s %(message)s"))
        root.addHandler(h)
        root.setLevel(logging.INFO)
    return root.getChild(name) if name else root


def log_event(event: str, **fields) -> dict:
    """Emit one structured event; returns the record (handy for tests)."""
    rec = {"event": event, "t": round(time.monotonic() - _T0, 6), **fields}
    path = os.environ.get("SIGKERNEL_LOG_FILE")
    if path:
        with open(path, "a") as f:
            f.write(json.dumps(rec) + "\n")
    get_logger("events").info("%s %s", event,
                              json.dumps(fields, default=str))
    return rec
