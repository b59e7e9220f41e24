"""Fault types for the port's host-side runtime.

The port's copy of ``KillSwitch`` from ``distributed_eigenspaces_tpu/utils/
faults.py``: the scheduler re-raises it instead of retrying. The chaos
plans, injectors and streams there are not ported yet (ROADMAP.md Queue 1
item 16).
"""

from __future__ import annotations


class KillSwitch(RuntimeError):
    """Simulated hard process death (chaos harness kill-at-step-t).

    Deliberately NOT in the supervisor's retryable set: a real SIGKILL
    doesn't retry — it takes the process down, and recovery is the next
    process restoring the newest committed checkpoint and seeking the
    stream cursor. Tests/scripts catch it OUTSIDE the supervised run and
    call it again to simulate the restart.
    """
