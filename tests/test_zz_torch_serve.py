"""The port's serve plane end to end on the CPU: dynamic batching,
multiplexing, a replica's death mid-stream, the HTTP ndjson token stream
and the gRPC ingress (adapted from the reference's own serve tests to
``ray_tpu_torch``), and a collective group that survives an actor's drain
migration (the worker's re-join path).

Marked slow: each test starts replicas or raylets, several with a torch
import of their own; together they take minutes, more than the port's
tier-1 tests may spend.  Run with
``python -m pytest tests/test_zz_torch_serve.py -m slow``.  The HTTP
proxy needs aiohttp and the gRPC one grpc.
"""

import json
import os
import sys
import threading
import time
import urllib.request

import cloudpickle
import numpy as np
import pytest

import ray_tpu_torch as rt
from ray_tpu_torch import serve
from ray_tpu_torch.common.faults import ChaosController
from ray_tpu_torch.cluster_utils import Cluster
from ray_tpu_torch.util import collective as col

pytestmark = pytest.mark.slow


@pytest.fixture(scope="class")
def cluster():
    cloudpickle.register_pickle_by_value(sys.modules[__name__])
    rt.init(num_cpus=4, log_to_driver=False)
    try:
        yield
    finally:
        serve.shutdown()
        rt.shutdown()
        cloudpickle.unregister_pickle_by_value(sys.modules[__name__])


def _llama(name, **kw):
    from ray_tpu_torch.models import llama
    from ray_tpu_torch.serve.llm import LlamaDeployment

    return LlamaDeployment.options(name=name).bind(
        config=llama.LlamaConfig.tiny(), device="cpu", **kw)


@pytest.mark.usefixtures("cluster")
class TestServeOnCluster:
    def test_concurrent_calls_batch_together(self):
        @serve.deployment
        class Batcher:
            def __init__(self):
                self.batch_sizes = []

            @serve.batch(max_batch_size=8, batch_wait_timeout_s=0.2)
            async def pred(self, items):
                self.batch_sizes.append(len(items))
                return [x * 2 for x in items]

            async def __call__(self, x):
                return await self.pred(x)

            async def sizes(self):
                return self.batch_sizes

        h = serve.run(Batcher.bind(), name="batch_app", route_prefix=None)
        resps = [h.remote(i) for i in range(8)]
        assert sorted(r.result(timeout_s=60) for r in resps) == [i * 2 for i in range(8)]
        sizes = h.options(method_name="sizes").remote().result(timeout_s=30)
        assert max(sizes) > 1, f"no batching happened: {sizes}"
        serve.delete("batch_app")

    def test_batch_error_propagates_to_all(self):
        @serve.deployment
        class Bad:
            @serve.batch(max_batch_size=4, batch_wait_timeout_s=0.1)
            async def pred(self, items):
                raise RuntimeError("batch exploded")

            async def __call__(self, x):
                return await self.pred(x)

        h = serve.run(Bad.bind(), name="badbatch_app", route_prefix=None)
        for r in [h.remote(i) for i in range(3)]:
            with pytest.raises(Exception, match="batch exploded"):
                r.result(timeout_s=60)
        serve.delete("badbatch_app")

    def test_model_id_routes_and_caches(self):
        @serve.deployment
        class Mux:
            def __init__(self):
                self.loads = []

            @serve.multiplexed(max_num_models_per_replica=2)
            async def get_model(self, model_id: str):
                self.loads.append(model_id)
                return f"model::{model_id}"

            async def __call__(self, x):
                model = await self.get_model()
                return (model, serve.get_multiplexed_model_id(), x)

            async def loads_seen(self):
                return self.loads

        h = serve.run(Mux.bind(), name="mux_app", route_prefix=None)
        assert h.options(multiplexed_model_id="a").remote(1).result(timeout_s=60) == ("model::a", "a", 1)
        assert h.options(multiplexed_model_id="a").remote(2).result(timeout_s=60) == ("model::a", "a", 2)
        h.options(multiplexed_model_id="b").remote(3).result(timeout_s=60)
        h.options(multiplexed_model_id="c").remote(4).result(timeout_s=60)
        # "a" loaded once despite two calls; "c" evicted the LRU entry
        assert h.options(method_name="loads_seen").remote().result(timeout_s=30) == ["a", "b", "c"]
        serve.delete("mux_app")

    def test_llm_replica_death_failover(self):
        from ray_tpu_torch.serve.llm import LlamaDeployment

        class CrashableLlama(LlamaDeployment.func_or_class):
            async def crash(self):
                os._exit(1)

        from ray_tpu_torch.models import llama

        dep = serve.deployment(CrashableLlama).options(name="llm2")
        h = serve.run(dep.bind(config=llama.LlamaConfig.tiny(), device="cpu", max_slots=2, max_len=128),
                      name="llm2_app", route_prefix=None)
        gen = h.options(method_name="generate", stream=True).remote([1, 2, 3], max_new_tokens=64)
        assert isinstance(next(gen), int)
        h.options(method_name="crash").remote()
        # the stream must surface the death rather than hang
        with pytest.raises(Exception):
            for _ in range(128):
                next(gen)
            raise AssertionError("stream survived a dead replica")
        # the controller restarts the replica; a new request succeeds
        deadline, out = time.monotonic() + 120, None
        while time.monotonic() < deadline:
            try:
                out = list(h.options(method_name="generate", stream=True).remote([4, 5], max_new_tokens=3))
                break
            except Exception:
                time.sleep(2)
        assert out is not None and len(out) == 3
        serve.delete("llm2_app")

    def test_restarted_replica_resolves_a_weights_ref_the_driver_dropped(self):
        """The controller holds a deployment's ``weights_ref``: after the
        driver has dropped its ref and the replica died, the restarted
        replica still loads those weights and gives the JAX engine's
        tokens."""
        import asyncio
        import gc

        import jax

        from ray_tpu.models import llama as jax_llama
        from ray_tpu.serve.llm import LLMEngine as JaxLLMEngine
        from ray_tpu_torch.models import llama
        from ray_tpu_torch.models.convert import llama_params_from_jax
        from ray_tpu_torch.serve.llm import LlamaDeployment

        class CrashableLlama(LlamaDeployment.func_or_class):
            async def crash(self):
                os._exit(1)

        params = jax.tree_util.tree_map(
            np.asarray, jax_llama.init(jax.random.key(0), jax_llama.LlamaConfig.tiny()))
        prompt, new, engine = [3, 7, 11, 2], 6, dict(max_slots=2, max_len=32)
        jax_engine = JaxLLMEngine(params, jax_llama.LlamaConfig.tiny(), **engine)

        async def jax_tokens():
            return [t async for t in jax_engine.stream(prompt, new)]

        want = asyncio.run(jax_tokens())
        cfg = llama.LlamaConfig.tiny()
        ref = rt.put(llama_params_from_jax(params, cfg, device="cpu").state_dict())
        dep = serve.deployment(CrashableLlama).options(name="llmw")
        h = serve.run(dep.bind(config=cfg, weights_ref=ref, device="cpu", **engine),
                      name="llmw_app", route_prefix=None)
        del ref
        gc.collect()
        assert h.options(method_name="generate_all").remote(prompt, new).result(timeout_s=60) == want
        h.options(method_name="crash").remote()
        time.sleep(1.0)
        deadline, got = time.monotonic() + 120, None
        while time.monotonic() < deadline:
            try:
                got = h.options(method_name="generate_all").remote(prompt, new).result(timeout_s=30)
                break
            except Exception:
                time.sleep(2)
        serve.delete("llmw_app")
        assert got == want

    def test_llm_tokens_stream_over_http_ndjson(self):
        pytest.importorskip("aiohttp")
        from ray_tpu_torch.serve import api as serve_api

        h = serve.run(_llama("llmh", max_slots=2, max_len=48), name="llmh_app",
                      route_prefix="/llm", http_port=0)
        port = rt.get(serve_api._proxy_handle.start.remote(), timeout=60)
        req = urllib.request.Request(
            f"http://127.0.0.1:{port}/llm?method=generate&stream=1",
            data=json.dumps({"prompt": [1, 2, 3], "max_new_tokens": 5}).encode(),
            headers={"Content-Type": "application/json"},
        )
        with urllib.request.urlopen(req, timeout=120) as r:
            assert r.headers["Content-Type"].startswith("application/x-ndjson")
            toks = [json.loads(ln) for ln in r.read().decode().splitlines() if ln]
        assert toks == h.options(method_name="generate_all").remote([1, 2, 3], 5).result(timeout_s=60)
        serve.delete("llmh_app")

    def test_grpc_ingress_routes(self):
        grpc = pytest.importorskip("grpc")

        @serve.deployment(num_replicas=1)
        class Echo:
            def __call__(self, payload=None, **kwargs):
                if kwargs:
                    return {"kwargs": kwargs}
                return {"echo": payload}

        serve.run(Echo.bind(), name="echo", route_prefix="/echo")
        port = serve.start_grpc_proxy(0)
        channel = grpc.insecure_channel(f"127.0.0.1:{port}")
        try:
            def call(method, payload, metadata=()):
                return channel.unary_unary(method)(payload, metadata=metadata, timeout=60)

            assert json.loads(call("/rt.serve/echo", json.dumps(42).encode())) == {"echo": 42}
            out = call("/rt.serve/Anything", json.dumps({"a": 1}).encode(),
                       metadata=(("application", "/echo"),))
            assert json.loads(out) == {"kwargs": {"a": 1}}
            with pytest.raises(grpc.RpcError):
                call("/rt.serve/nope", b"{}")
        finally:
            channel.close()
            serve.delete("echo")

    def test_control_actors_load_no_torch(self):
        """The controller and the proxies run without a card and import no
        torch, even while a replica beside them serves a torch model."""
        pytest.importorskip("aiohttp")
        from ray_tpu_torch.core.actor import get_actor
        from ray_tpu_torch.serve.api import PROXY_NAME
        from ray_tpu_torch.serve.controller import CONTROLLER_NAME

        h = serve.run(_llama("llmc", max_slots=2, max_len=32), name="llmc_app",
                      route_prefix="/c", http_port=0)
        assert len(h.options(method_name="generate_all").remote([1, 2], 3).result(timeout_s=60)) == 3

        def facts(_):
            return (os.environ.get("CUDA_VISIBLE_DEVICES"),
                    sorted(m for m in ("torch", "jax") if m in sys.modules))

        for name in (CONTROLLER_NAME, PROXY_NAME):
            assert rt.get(get_actor(name)._apply(facts), timeout=30) == ("", [])
        serve.delete("llmc_app")


# -- a collective rank migrates off a draining node and re-joins its group ---

class CkptRank:
    """A collective rank with user state: both migrate together."""

    def __init__(self):
        self.tag = None

    def init(self, world, rank, group):
        col.init_collective_group(world, rank, group_name=group)
        self.tag = 100 * rank
        return rank

    def allreduce(self, arr, group):
        return col.allreduce(arr, group_name=group)

    def rank(self, group):
        return col.get_rank(group)

    def get_tag(self):
        return self.tag

    def __rt_checkpoint__(self):
        return {"tag": self.tag}

    def __rt_restore__(self, state):
        self.tag = state["tag"]


class TestDrainMigration:
    def test_collective_rank_rejoins_after_drain_migration(self):
        """Rank 1 of a two-rank group lives on a node that is preempted:
        the drain checkpoints it, restarts it on a survivor, and the new
        process re-joins the group under its rank (the worker's
        ``_rejoin_collective_group``), so an allreduce is bit-exact
        afterwards."""
        cloudpickle.register_pickle_by_value(sys.modules[__name__])
        cluster = Cluster()
        try:
            cluster.add_node(2, resources={"h": 4.0})
            rt.init(address=cluster.address, log_to_driver=False)
            victim = cluster.add_node(1, resources={"pre": 1.0})
            cluster.wait_for_nodes()
            rank = rt.remote(CkptRank)
            home = rank.options(num_cpus=0, resources={"h": 0.5}).remote()
            moving = rank.options(num_cpus=0, resources={"pre": 0.4}, max_restarts=0).remote()
            members, group = [home, moving], "drain-rejoin"
            assert rt.get([m.init.remote(2, i, group) for i, m in enumerate(members)], timeout=120) == [0, 1]
            datas = [np.random.RandomState(7 + i).randint(-1024, 1024, 65536).astype(np.float32)
                     for i in range(2)]
            want = datas[0] + datas[1]
            for out in rt.get([m.allreduce.remote(datas[i], group) for i, m in enumerate(members)],
                              timeout=120):
                assert np.array_equal(out, want)
            pid = rt.get(moving._apply(lambda _: os.getpid()), timeout=60)

            cluster.add_node(1, resources={"pre": 1.0})
            cluster.wait_for_nodes()
            _, state = ChaosController(cluster, seed=3).preempt_node(node=victim, deadline_s=15.0)
            assert state == "drained", state
            assert rt.get(moving.get_tag.remote(), timeout=120) == 100
            assert rt.get(moving._apply(lambda _: os.getpid()), timeout=60) != pid
            deadline = time.monotonic() + 60
            while time.monotonic() < deadline:
                try:
                    if rt.get([m.rank.remote(group) for m in members], timeout=30) == [0, 1]:
                        break
                except Exception:
                    pass
                time.sleep(0.3)
            else:
                raise AssertionError("the group never re-formed")
            for out in rt.get([m.allreduce.remote(datas[i], group) for i, m in enumerate(members)],
                              timeout=120):
                assert np.array_equal(out, want)
        finally:
            rt.shutdown()
            cluster.shutdown()
            cloudpickle.unregister_pickle_by_value(sys.modules[__name__])
