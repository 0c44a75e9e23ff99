"""Replica actor: hosts one copy of the user callable.

Role-equivalent of ray: python/ray/serve/_private/replica.py:231
(ReplicaActor, UserCallableWrapper:737).  Requests arrive as actor calls;
the replica tracks ongoing-request count (the router's pow-2 signal and
the controller's autoscaling signal).
"""

from __future__ import annotations

import inspect
from typing import Any

import ray_tpu_torch


def _resolve_handle_refs(value, app_name: str):
    """Swap HandleRef placeholders (left by serve.run's graph flatten)
    for live DeploymentHandles to sibling deployments of this app —
    model composition's injection point (reference:
    serve/_private/deployment_graph_build.py handle injection)."""
    from ray_tpu_torch.serve.deployment import HandleRef

    if isinstance(value, HandleRef):
        from ray_tpu_torch.serve.api import get_deployment_handle

        return get_deployment_handle(value.deployment_name, app_name)
    if isinstance(value, list):
        return [_resolve_handle_refs(v, app_name) for v in value]
    if isinstance(value, tuple):
        return tuple(_resolve_handle_refs(v, app_name) for v in value)
    if isinstance(value, dict):
        return {
            k: _resolve_handle_refs(v, app_name) for k, v in value.items()
        }
    return value


@ray_tpu_torch.remote
class ReplicaActor:
    def __init__(
        self, func_or_class, init_args, init_kwargs, method_default,
        app_name: str = "",
    ):
        from ray_tpu_torch.serve.deployment import SealedCallable

        if isinstance(func_or_class, SealedCallable):
            func_or_class, init_args, init_kwargs = func_or_class.open()
        init_args = _resolve_handle_refs(tuple(init_args), app_name)
        init_kwargs = _resolve_handle_refs(dict(init_kwargs), app_name)
        self._is_function = inspect.isfunction(func_or_class) or (
            callable(func_or_class) and not inspect.isclass(func_or_class)
        )
        if inspect.isclass(func_or_class):
            self._callable = func_or_class(*init_args, **init_kwargs)
            self._is_function = False
        else:
            self._callable = func_or_class
        self._method_default = method_default
        self._ongoing = 0
        self._total = 0

    @staticmethod
    async def _resolve_chained(args, kwargs):
        """Resolve ObjectRef args left by response-chaining (an upstream
        DeploymentResponse passed into this call travels as its ref;
        it's nested inside the method-args tuple, so the task layer's
        top-level auto-resolution never sees it)."""
        from ray_tpu_torch.core.object_ref import ObjectRef
        from ray_tpu_torch.core.runtime import get_runtime

        rt = get_runtime()

        async def one(v):
            if isinstance(v, ObjectRef):
                return await rt.await_ref(v)
            if isinstance(v, list):
                return [await one(x) for x in v]
            if isinstance(v, tuple):
                return tuple([await one(x) for x in v])
            if isinstance(v, dict):
                return {k: await one(x) for k, x in v.items()}
            return v

        args = [await one(a) for a in args]
        kwargs = {k: await one(v) for k, v in kwargs.items()}
        return args, kwargs

    async def handle_request(self, method: str, args, kwargs) -> Any:
        self._ongoing += 1
        self._total += 1
        try:
            args, kwargs = await self._resolve_chained(args, kwargs)
            kwargs = self._apply_multiplex(kwargs)
            kwargs = self._apply_deadline(kwargs)
            if self._is_function:
                target = self._callable
            else:
                target = getattr(self._callable, method or "__call__")
            result = target(*args, **kwargs)
            if inspect.iscoroutine(result):
                result = await result
            return result
        finally:
            self._ongoing -= 1

    @staticmethod
    def _apply_multiplex(kwargs):
        """Pop the smuggled model id and expose it via the contextvar
        (ray: serve.get_multiplexed_model_id)."""
        from ray_tpu_torch.serve import multiplex

        if multiplex.MODEL_ID_KWARG in kwargs:
            kwargs = dict(kwargs)
            multiplex.set_multiplexed_model_id(
                kwargs.pop(multiplex.MODEL_ID_KWARG)
            )
        return kwargs

    @staticmethod
    def _apply_deadline(kwargs):
        """Pop the traffic scheduler's remaining-SLO-budget kwarg and
        re-anchor it against THIS process's monotonic clock (budgets
        cross the wire as durations — clocks don't transfer), exposing
        the deadline via serve.traffic.get_request_deadline() for the
        LLM slot admitter and any deadline-aware user code."""
        from ray_tpu_torch.serve.traffic import config as traffic_config

        if traffic_config.DEADLINE_KWARG in kwargs:
            import time

            kwargs = dict(kwargs)
            budget_s = kwargs.pop(traffic_config.DEADLINE_KWARG)
            traffic_config.set_request_deadline(
                time.monotonic() + float(budget_s)
            )
        else:
            # actor reuse: a prior deadline must not leak into a request
            # that arrived without one
            traffic_config.set_request_deadline(None)
        return kwargs

    async def handle_request_stream(self, method: str, args, kwargs):
        """Streaming call: the target must return a (async) generator or
        iterable; items ride the core streaming-generator transport
        (num_returns="streaming" → ObjectRefGenerator), matching ray:
        serve's ObjectRefGenerator-backed streaming responses."""
        import inspect as _inspect

        self._ongoing += 1
        self._total += 1
        try:
            args, kwargs = await self._resolve_chained(args, kwargs)
            kwargs = self._apply_multiplex(kwargs)
            kwargs = self._apply_deadline(kwargs)
            if self._is_function:
                target = self._callable
            else:
                target = getattr(self._callable, method or "__call__")
            result = target(*args, **kwargs)
            if _inspect.iscoroutine(result):
                result = await result
            if _inspect.isasyncgen(result):
                async for item in result:
                    yield item
            elif hasattr(result, "__iter__") and not isinstance(
                result, (str, bytes, dict)
            ):
                for item in result:
                    yield item
            else:
                raise TypeError(
                    f"streaming call to {method!r} returned "
                    f"{type(result).__name__}, expected a generator/iterable"
                )
        finally:
            self._ongoing -= 1

    async def queue_len(self) -> int:
        return self._ongoing

    async def stats(self) -> dict:
        import os

        return {
            "ongoing": self._ongoing,
            "total": self._total,
            "pid": os.getpid(),
        }

    async def reconfigure(self, user_config) -> bool:
        fn = getattr(self._callable, "reconfigure", None)
        if fn is not None:
            out = fn(user_config)
            if inspect.iscoroutine(out):
                await out
        return True

    async def check_health(self) -> bool:
        fn = getattr(self._callable, "check_health", None)
        if fn is not None:
            out = fn()
            if inspect.iscoroutine(out):
                out = await out
            return bool(out) if out is not None else True
        return True
