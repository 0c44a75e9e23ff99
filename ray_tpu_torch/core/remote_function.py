"""@remote functions.

Role-equivalent of ray: python/ray/remote_function.py:40 (RemoteFunction,
_remote:266).
"""

from __future__ import annotations

import functools
from typing import Any, Dict, Optional

from ray_tpu_torch.common.config import cfg
from ray_tpu_torch.common.resources import validate_task_resources


def _build_resources(
    num_cpus=None, num_tpus=None, num_gpus=None, memory=None, resources=None
) -> Dict[str, float]:
    out: Dict[str, float] = dict(resources or {})
    if num_tpus or any(k == "TPU" or k.startswith("TPU-") for k in out):
        # no node of this runtime has TPUs: such a request would pend
        # forever, so it is refused here
        raise ValueError(
            "the PyTorch/CUDA runtime schedules no TPU resource; "
            "ask for num_gpus instead"
        )
    out["CPU"] = num_cpus if num_cpus is not None else out.get("CPU", 1)
    if num_gpus:
        out["GPU"] = num_gpus
    if memory:
        out["memory"] = memory
    if out.get("CPU") == 0:
        out.pop("CPU")
    validate_task_resources(out)
    return out


class RemoteFunction:
    def __init__(self, fn, **default_opts):
        self._fn = fn
        self._opts = default_opts
        # spec template (runtime.TaskTemplate), built at first submit and
        # reused for every later `.remote()` on this option-set: function
        # shipping, resource validation, scheduling-class key and the
        # spec skeleton are paid once, not per call
        self._template = None
        functools.update_wrapper(self, fn)

    def options(self, **opts) -> "RemoteFunction":
        merged = dict(self._opts)
        merged.update(opts)
        return RemoteFunction(self._fn, **merged)

    def bind(self, *args, **kwargs):
        """Lazy task-DAG binding (ray: python/ray/dag/function_node.py);
        consumed by ray_tpu_torch.workflow for durable graphs."""
        from ray_tpu_torch.workflow.dag import FunctionNode

        return FunctionNode(self, args, kwargs)

    def remote(self, *args, **kwargs):
        from ray_tpu_torch.core.runtime import get_runtime

        rt = get_runtime()
        tmpl = self._template
        if tmpl is None or tmpl.rt() is not rt:
            # first submit on this runtime (or the runtime was recycled
            # by shutdown/init): build and cache the template
            tmpl = self._build_template(rt)
        # single ObjectRef, list of refs, or ObjectRefGenerator — the
        # template path already returns the caller-facing shape
        return rt.submit_task_from_template(tmpl, args, kwargs)

    def _build_template(self, rt):
        import inspect

        o = self._opts
        resources = _build_resources(
            o.get("num_cpus"), o.get("num_tpus"), o.get("num_gpus"),
            o.get("memory"), o.get("resources"),
        )
        num_returns = o.get("num_returns", 1)
        # generator functions stream by default (reference: generators
        # return ObjectRefGenerator, remote_function.py:343-349)
        if num_returns == 1 and (
            inspect.isgeneratorfunction(self._fn)
            or inspect.isasyncgenfunction(self._fn)
        ):
            num_returns = "streaming"
        tmpl = rt.make_task_template(
            self._fn,
            name=o.get("name") or self._fn.__qualname__,
            num_returns=num_returns,
            resources=resources,
            max_retries=o.get(
                "max_retries", cfg.task_max_retries_default
            ),
            strategy=_strategy_dict(o.get("scheduling_strategy")),
            runtime_env=o.get("runtime_env"),
        )
        self._template = tmpl
        return tmpl

    def __getstate__(self):
        # the template caches runtime-bound state (the Runtime itself,
        # with its loop futures) — it never ships; the receiver rebuilds
        # its own at first submit
        d = self.__dict__.copy()
        d["_template"] = None
        return d

    def __call__(self, *args, **kwargs):
        raise TypeError(
            f"remote function {self._fn.__qualname__} cannot be called directly; "
            "use .remote()"
        )


def _strategy_dict(strategy) -> dict:
    if strategy is None:
        return {}
    if isinstance(strategy, dict):
        return strategy
    # scheduling_strategies objects expose to_dict()
    return strategy.to_dict()
