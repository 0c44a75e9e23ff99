"""Rollout-fragment metadata + staleness accounting for the podracer plane
(port of ``ray_tpu/rllib/podracer/fragment.py``, unchanged).

A fragment's PAYLOAD (the (T, B) arrays from ``EnvRunnerActor.sample``)
never rides these types — it lives in the shm arena and moves by
ObjectRef.  ``FragmentMeta`` is the few-dozen-byte control record the
driver routes: who sampled it, under which policy version, how many env
steps it carries, and whether its runner's node was SUSPECT when it
landed (the health plane's deprioritization input).
"""

from __future__ import annotations

import dataclasses
from typing import Dict


@dataclasses.dataclass
class FragmentMeta:
    """Control-plane record for one rollout fragment."""

    runner_index: int       # position in the fleet (stable across replaces)
    seq: int                # per-runner fragment counter (bit-repro key)
    policy_version: int     # learner version of the weights that sampled it
    env_steps: int          # T * num_envs
    suspect: bool = False   # runner's node SUSPECT at arrival (deprioritize)
    incarnation: int = 0    # bumps when the runner is replaced after a death

    def to_dict(self) -> dict:
        return dataclasses.asdict(self)

    @classmethod
    def from_dict(cls, d: dict) -> "FragmentMeta":
        return cls(**d)


class StalenessHistogram:
    """Counts of policy lag (learner version − fragment version) over the
    fragments that actually TRAINED — the published observability row for
    the staleness bound (lag ≤ K is enforced upstream; this shows the
    realized distribution inside the bound)."""

    def __init__(self):
        self._counts: Dict[int, int] = {}

    def add(self, lag: int) -> None:
        lag = int(lag)
        self._counts[lag] = self._counts.get(lag, 0) + 1

    @property
    def max_lag(self) -> int:
        return max(self._counts) if self._counts else 0

    @property
    def total(self) -> int:
        return sum(self._counts.values())

    def snapshot(self) -> Dict[int, int]:
        return dict(sorted(self._counts.items()))

    def state(self) -> Dict[int, int]:
        return dict(self._counts)

    def restore(self, state: Dict[int, int]) -> None:
        self._counts = {int(k): int(v) for k, v in state.items()}

    def __repr__(self):
        return f"StalenessHistogram({self.snapshot()})"
