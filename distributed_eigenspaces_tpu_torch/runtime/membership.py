"""Elastic-membership errors of the port's runtime.

The port's copy of ``QuorumLost`` from ``distributed_eigenspaces_tpu/
runtime/membership.py``. ``MembershipTable`` and ``ElasticStream`` are not
ported yet (ROADMAP.md Queue 1 item 16).
"""

from __future__ import annotations

__all__ = ["QuorumLost"]


class QuorumLost(RuntimeError):
    """Live membership fell below ``min_quorum_frac``: the run cannot
    claim a representative merge and fails LOUDLY instead of silently
    averaging a sliver of the fleet. Carries the table (anything with
    ``live_count``, ``live_frac``, ``min_quorum_frac``, ``num_workers`` and
    ``state_counts``) so the handler can wait for quorum to return and
    resume."""

    def __init__(self, table, step: int | None = None):
        self.table = table
        self.step = step
        self.live = table.live_count()
        self.frac = table.live_frac()
        self.required = table.min_quorum_frac
        super().__init__(
            f"quorum lost at step {step}: {self.live}/{table.num_workers} "
            f"workers live ({self.frac:.2f} < min_quorum_frac "
            f"{self.required:.2f}); states {table.state_counts()}"
        )
