"""Host-side runtime of the port: the dispatch queues, the serve lane's
supervision, elastic and per-tier membership, population ingest, the
online autoscaler, and the scenario replay that composes them."""

from distributed_eigenspaces_tpu_torch.runtime.scenario import (
    ScenarioRunner,
    ScenarioSpec,
    build_schedule,
    load_spec,
    run_scenario,
)

__all__ = [
    "ScenarioRunner",
    "ScenarioSpec",
    "build_schedule",
    "load_spec",
    "run_scenario",
]
