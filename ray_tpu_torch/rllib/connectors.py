"""Connector pipelines: observation/action transforms around the module
(a copy of ``ray_tpu/rllib/connectors.py``: numpy only).

Role-equivalent of ray: rllib/connectors/ (ConnectorV2,
env_to_module/*.py, module_to_env/*.py) — reduced to the two pipelines
this stack actually routes through: env→module (batched observation
preprocessing inside the EnvRunner, before the module's inference) and
module→env (action post-processing before `env.step`).  Connectors are
stateful objects living inside each runner, so stateful transforms
(running normalization, frame stacking) keep per-runner state exactly
like the reference's per-EnvRunner connector instances.
"""

from __future__ import annotations

from typing import List, Optional, Sequence

import numpy as np


class Connector:
    """One transform stage.  Called with a batch (B, ...) ndarray."""

    def __call__(self, batch: np.ndarray) -> np.ndarray:
        raise NotImplementedError

    def reset(self, env_index: Optional[int] = None) -> None:
        """Clear per-episode state (frame stacks) for one env or all."""


class Pipeline(Connector):
    """Ordered connector list (ray: ConnectorPipelineV2)."""

    def __init__(self, connectors: Optional[Sequence[Connector]] = None):
        self.connectors: List[Connector] = list(connectors or [])

    def append(self, c: Connector) -> "Pipeline":
        self.connectors.append(c)
        return self

    def prepend(self, c: Connector) -> "Pipeline":
        self.connectors.insert(0, c)
        return self

    def __call__(self, batch: np.ndarray) -> np.ndarray:
        for c in self.connectors:
            batch = c(batch)
        return batch

    def reset(self, env_index: Optional[int] = None) -> None:
        for c in self.connectors:
            c.reset(env_index)


class FlattenObs(Connector):
    """(B, ...) → (B, prod(...)) — images/dict-leaves to MLP input
    (ray: connectors/env_to_module/flatten_observations.py)."""

    def __call__(self, batch: np.ndarray) -> np.ndarray:
        return np.asarray(batch, np.float32).reshape(len(batch), -1)


class NormalizeObs(Connector):
    """Running mean/std normalization (ray: connectors/env_to_module/
    mean_std_filter.py MeanStdFilter; Welford's algorithm)."""

    def __init__(self, clip: float = 10.0, eps: float = 1e-8):
        self.clip = clip
        self.eps = eps
        self._count = 0.0
        self._mean: Optional[np.ndarray] = None
        self._m2: Optional[np.ndarray] = None

    def __call__(self, batch: np.ndarray) -> np.ndarray:
        batch = np.asarray(batch, np.float32)
        if self._mean is None:
            self._mean = np.zeros(batch.shape[1:], np.float64)
            self._m2 = np.ones(batch.shape[1:], np.float64)
        for row in batch:  # batch sizes here are tiny (num_envs)
            self._count += 1.0
            delta = row - self._mean
            self._mean += delta / self._count
            self._m2 += delta * (row - self._mean)
        std = np.sqrt(self._m2 / max(self._count, 2.0)) + self.eps
        out = (batch - self._mean) / std
        return np.clip(out, -self.clip, self.clip).astype(np.float32)

    def state(self) -> dict:
        return {"count": self._count, "mean": self._mean, "m2": self._m2}


class FrameStack(Connector):
    """Stack the last k observations per env along the feature axis
    (ray: connectors/env_to_module/frame_stacking.py)."""

    def __init__(self, k: int = 4):
        self.k = k
        self._frames: Optional[np.ndarray] = None  # (B, k, F)
        self._pending_reset: set = set()

    def __call__(self, batch: np.ndarray) -> np.ndarray:
        batch = np.asarray(batch, np.float32).reshape(len(batch), -1)
        if self._frames is None or len(batch) != len(self._frames):
            self._frames = np.repeat(batch[:, None, :], self.k, axis=1)
            self._pending_reset.clear()
        else:
            self._frames = np.concatenate(
                [self._frames[:, 1:], batch[:, None, :]], axis=1
            )
            # envs flagged by reset(): re-seed with the NEW episode's
            # first frame repeated k times, exactly like the very first
            # call — every episode start sees the same input convention
            for i in self._pending_reset:
                self._frames[i] = batch[i]
            self._pending_reset.clear()
        return self._frames.reshape(len(batch), -1)

    def reset(self, env_index: Optional[int] = None) -> None:
        if env_index is None:
            self._frames = None
            self._pending_reset.clear()
        else:
            self._pending_reset.add(int(env_index))


class ClipActions(Connector):
    """Clip continuous actions into bounds (module→env;
    ray: connectors/module_to_env/clip_actions.py)."""

    def __init__(self, low: float, high: float):
        self.low, self.high = low, high

    def __call__(self, batch: np.ndarray) -> np.ndarray:
        return np.clip(batch, self.low, self.high)


def obs_shape_after(pipeline: Optional[Pipeline], obs_shape: tuple) -> tuple:
    """Probe the per-row obs SHAPE the module will see after env→module
    connectors (so module configs can be built — and the CNN/MLP catalog
    dispatched — before any env steps).  A normalize-only pipeline keeps
    image rank; a FlattenObs collapses it."""
    dummy = np.zeros((1,) + tuple(obs_shape), np.float32)
    if pipeline is not None:
        dummy = pipeline(dummy)
        pipeline.reset()
    return tuple(dummy.shape[1:])


def obs_dim_after(pipeline: Optional[Pipeline], obs_shape: tuple) -> int:
    return int(np.prod(obs_shape_after(pipeline, obs_shape)))
