"""Model multiplexing: many models per replica, routed by model id.

Role-equivalent of ray: python/ray/serve/api.py:607 (@serve.multiplexed
+ serve.get_multiplexed_model_id): a replica lazily loads models on
first use and keeps at most ``max_num_models_per_replica`` resident
(LRU eviction); callers pick the model with
``handle.options(multiplexed_model_id=...)``.
"""

from __future__ import annotations

import asyncio
import contextvars
import functools
from collections import OrderedDict
from typing import Callable, Optional

_model_id_ctx: contextvars.ContextVar = contextvars.ContextVar(
    "rt_multiplexed_model_id", default=""
)

#: kwarg smuggled through handle.remote() -> replica.handle_request
MODEL_ID_KWARG = "_rt_multiplexed_model_id"


def get_multiplexed_model_id() -> str:
    """The model id of the current request (empty when not multiplexed)."""
    return _model_id_ctx.get()


def set_multiplexed_model_id(model_id: str):
    _model_id_ctx.set(model_id)


def multiplexed(
    _fn: Optional[Callable] = None, *, max_num_models_per_replica: int = 3
):
    """Decorator for an async model loader ``async def get_model(self,
    model_id)``; calls are cached per replica with LRU eviction."""

    def wrap(fn):
        if not asyncio.iscoroutinefunction(fn):
            raise TypeError("@serve.multiplexed requires an async def loader")
        attr = f"__rt_mux_cache_{fn.__name__}"

        locks_attr = f"__rt_mux_locks_{fn.__name__}"

        @functools.wraps(fn)
        async def wrapper(self, model_id: Optional[str] = None):
            if model_id is None:
                model_id = get_multiplexed_model_id()
            cache: OrderedDict = getattr(self, attr, None)
            if cache is None:
                cache = OrderedDict()
                setattr(self, attr, cache)
            if model_id in cache:
                cache.move_to_end(model_id)
                return cache[model_id]
            # per-model-id load lock: concurrent cold requests must not
            # load (and then leak) duplicate copies of the same model
            locks = getattr(self, locks_attr, None)
            if locks is None:
                locks = {}
                setattr(self, locks_attr, locks)
            lock = locks.setdefault(model_id, asyncio.Lock())
            async with lock:
                if model_id in cache:  # loaded while we waited
                    cache.move_to_end(model_id)
                    return cache[model_id]
                model = await fn(self, model_id)
                cache[model_id] = model
            locks.pop(model_id, None)
            while len(cache) > max_num_models_per_replica:
                evicted_id, evicted = cache.popitem(last=False)
                # models with a release hook get it called on eviction
                release = getattr(evicted, "__serve_multiplexed_release__",
                                  None)
                if release is not None:
                    try:
                        release()
                    except Exception:
                        pass
            return model

        return wrapper

    if _fn is not None:
        return wrap(_fn)
    return wrap
