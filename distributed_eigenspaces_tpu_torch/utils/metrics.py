"""Structured log lines of the port.

The port's copy of ``log_line`` from ``distributed_eigenspaces_tpu/utils/
metrics.py``. ``MetricsLogger`` is not ported yet (ROADMAP.md Queue 1
item 16).
"""

from __future__ import annotations

import json
import sys
import time


def log_line(msg: str, **fields) -> None:
    """One structured log line to stderr. Carries both clocks like every
    other event (``time`` stays for existing consumers; it is the unix
    stamp)."""
    rec = {
        "msg": msg,
        "time": time.time(),
        "t_unix": time.time(),
        "t_mono": time.perf_counter(),
        **fields,
    }
    print(json.dumps(rec), file=sys.stderr, flush=True)
