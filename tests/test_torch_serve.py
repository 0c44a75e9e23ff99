"""The port's serve plane and runtime collectives (ray_tpu_torch.serve,
ray_tpu_torch.util.collective) against the JAX package's, and on a cluster.

The codec and the pytree strip/fill of ``broadcast_tree`` are held against
``ray_tpu.util.collective`` directly, bit for bit.  The cluster tests share
one cluster for the module, ``init(num_cpus=4)`` under
``gpu_count_override=1``: one GPU is declared and none exists, so the GPU
seam is checked by the ``CUDA_VISIBLE_DEVICES`` a replica is given.  The
tiny Llama served there runs on the CPU (``device="cpu"``) in f32, with
weights converted from the JAX package's seeded init, and its greedy tokens
must equal the JAX ``LLMEngine``'s, before and after a weight push.
"""

import asyncio
import os
import sys
import threading
import time

import cloudpickle
import jax
import numpy as np
import pytest
import torch

import ray_tpu_torch as rt
from ray_tpu.models import llama as jax_llama
from ray_tpu.serve.llm import LLMEngine as JaxLLMEngine
from ray_tpu.util.collective import collective as ref_collective
from ray_tpu.util.collective import quantize as ref_quantize
from ray_tpu_torch import serve
from ray_tpu_torch.common import config as port_config
from ray_tpu_torch.common import serialization as port_ser
from ray_tpu_torch.models import llama
from ray_tpu_torch.models.convert import llama_params_from_jax
from ray_tpu_torch.serve.llm import LlamaDeployment
from ray_tpu_torch.util.collective import collective as port_collective
from ray_tpu_torch.util.collective import quantize as port_quantize
from ray_tpu_torch.util.collective.types import CollectiveError

_GPU_ENV = ("CUDA_VISIBLE_DEVICES", "RT_GPU_VISIBLE_DEVICES", "RT_GPU_COUNT_OVERRIDE")

# Three concurrent requests of one prompt length (one JAX prefill compile),
# through four slots; the tiny config's vocabulary is 256.
PROMPTS = [[3, 7, 11, 2], [5, 1, 4, 9], [2, 200, 17, 80]]
MAX_NEW = 6
ENGINE = dict(max_slots=4, max_len=32)


# -- codec: the port's quantize against the reference's, bit for bit -------

def _flats():
    rng = np.random.default_rng(0)
    return {
        "ragged-5000": rng.standard_normal(5000).astype(np.float32),
        "one-block-2048": (rng.standard_normal(2048) * 100).astype(np.float32),
        "outlier": np.concatenate([rng.standard_normal(3000), [1e6]]).astype(np.float32),
        "one": np.array([0.3], np.float32),
    }


@pytest.mark.parametrize("path", ["native", "numpy"])
@pytest.mark.parametrize("wire", ["int8", "bf16"])
@pytest.mark.parametrize("name", list(_flats()))
def test_codec_matches_reference(monkeypatch, name, wire, path):
    if path == "numpy":
        monkeypatch.setattr(port_quantize, "_qlib", lambda: None)
        monkeypatch.setattr(ref_quantize, "_qlib", lambda: None)
    else:
        assert port_quantize._qlib() is not None, "the native codec did not build"
    flat = _flats()[name]
    port, ref = port_quantize.get_codec(wire), ref_quantize.get_codec(wire)
    wire_bytes = port.encode(flat)
    assert wire_bytes.tobytes() == ref.encode(flat).tobytes()
    assert port.decode(wire_bytes, flat.size).tobytes() == ref.decode(wire_bytes, flat.size).tobytes()


# -- broadcast_tree's strip and fill with tensor leaves ----------------------

def _tensor_tree():
    g = torch.Generator().manual_seed(1)
    return {
        "w": torch.randn(50, 100, generator=g),
        "emb": torch.randn(64, 96, generator=g).to(torch.bfloat16),
        "step": torch.arange(12, dtype=torch.int64).reshape(3, 4),
        "nested": [torch.randn(7, generator=g), ("tag", np.arange(5, dtype=np.float32))],
    }


def test_tree_strip_keeps_non_f32_tensors_exact():
    """Only float32 leaves (tensor or numpy) ride the quantized tensor, in
    the reference's order; bf16 and int64 tensors stay in the skeleton and
    come through the serializer exactly; the filled tree has every leaf's
    type, dtype and shape."""
    tree = _tensor_tree()
    leaves = []
    skel = port_collective._strip_f32(tree, leaves)
    ref_tree = {"w": tree["w"].numpy(), "emb": None, "step": tree["step"].numpy(),
                "nested": [tree["nested"][0].numpy(), tree["nested"][1]]}
    ref_leaves = []
    ref_collective._strip_f32(ref_tree, ref_leaves)
    assert [a.tobytes() for a in leaves] == [a.tobytes() for a in ref_leaves]
    assert len(leaves) == 3
    assert skel["emb"] is tree["emb"] and skel["step"] is tree["step"]
    flat = np.concatenate([a.reshape(-1) for a in leaves])
    codec = port_quantize.get_codec("int8")
    decoded = codec.decode(codec.encode(flat), flat.size)
    assert decoded.tobytes() == ref_quantize.get_codec("int8").decode(
        ref_quantize.get_codec("int8").encode(flat), flat.size).tobytes()
    # the skeleton travels through the serializer (broadcast_object's path)
    skel = port_ser.deserialize(port_ser.serialize(skel).to_bytes())
    arrs, off = [], 0
    for a in leaves:
        arrs.append(decoded[off:off + a.size])
        off += a.size
    out = port_collective._fill_f32(skel, arrs)
    assert torch.equal(out["emb"], tree["emb"]) and out["emb"].dtype == torch.bfloat16
    assert torch.equal(out["step"], tree["step"])
    for got, want, idx in ((out["w"], tree["w"], 0), (out["nested"][0], tree["nested"][0], 1)):
        assert isinstance(got, torch.Tensor) and got.dtype == torch.float32
        assert got.shape == want.shape
        assert got.numpy().tobytes() == arrs[idx].tobytes()
    assert isinstance(out["nested"][1][1], np.ndarray)
    assert out["nested"][1][1].tobytes() == arrs[2].tobytes()
    assert out["nested"][1][0] == "tag"


def test_dropped_backends_raise():
    """The reference's JAX-only backend names raise, naming the torch
    backend in their place; "nccl" and "device_mesh" resolve."""
    from ray_tpu_torch.parallel.collectives import MeshInProgramBackend
    from ray_tpu_torch.util.collective import backend
    from ray_tpu_torch.util.collective.nccl_backend import NcclGangBackend

    for name, torch_name in (("jax", "nccl"), ("mesh", "nccl"), ("xla", "device_mesh"),
                             ("ici", "device_mesh")):
        with pytest.raises(CollectiveError, match=f"torch counterpart is '{torch_name}'"):
            backend.resolve_backend(name)
        with pytest.raises(CollectiveError, match=f"torch counterpart is '{torch_name}'"):
            backend.backend_kind(name)
    assert backend.available_backends() == {"rpc": "runtime", "nccl": "runtime",
                                            "device_mesh": "in_program"}
    assert backend.resolve_backend("gloo") is backend.resolve_backend("rpc")
    assert backend.resolve_backend("nccl") is NcclGangBackend
    assert backend.resolve_backend("device_mesh") is MeshInProgramBackend


# -- seams that need no cluster ----------------------------------------------

@pytest.mark.parametrize("opts", [{"num_tpus": 1}, {"resources": {"TPU": 4}}],
                         ids=["num_tpus", "TPU-resource"])
def test_tpu_requests_raise(opts):
    """A deployment that asks for TPUs is refused where it is made, by
    ``.options`` and by the decorator; a GPU request is taken."""
    with pytest.raises(ValueError, match="no TPU"):
        LlamaDeployment.options(ray_actor_options=opts)
    with pytest.raises(ValueError, match="no TPU"):
        serve.deployment(ray_actor_options=opts)(lambda: 1)
    assert LlamaDeployment.options(ray_actor_options={"num_gpus": 0.5}).ray_actor_options


def _tiny_state(seed):
    return llama.init(llama.LlamaConfig.tiny(), torch.Generator().manual_seed(seed), "cpu").state_dict()


def test_update_weights_never_changes_the_running_step(monkeypatch):
    """While a (slowed) decode step runs in the engine's thread, an
    ``update_weights`` from another thread swaps in a new model: the
    tensors the running step reads stay as they were, and the following
    steps run on the new weights."""
    dep = LlamaDeployment.func_or_class(config=llama.LlamaConfig.tiny(), device="cpu",
                                        max_slots=2, max_len=32)
    old = dep.engine.model
    before = {k: v.clone() for k, v in old.state_dict().items()}
    new_state = _tiny_state(1)
    in_step, seen = threading.Event(), []
    decode = llama.decode_step_rowwise

    def slow_decode(model, tokens, cache, pos):
        seen.append(model)
        if len(seen) == 1:
            in_step.set()
            time.sleep(0.5)
            # the swap happened during this step
            assert dep.engine.model is not model
            assert all(torch.equal(v, before[k]) for k, v in model.state_dict().items())
        return decode(model, tokens, cache, pos)

    monkeypatch.setattr(llama, "decode_step_rowwise", slow_decode)
    pusher = threading.Thread(target=lambda: (in_step.wait(10), dep.update_weights(new_state)))
    pusher.start()

    async def run():
        return [t async for t in dep.generate([1, 2, 3], 4)]

    toks = asyncio.run(run())
    pusher.join()
    assert len(toks) == 4 and seen[0] is old
    assert all(m is dep.engine.model for m in seen[1:]) and len(seen) == 3
    assert all(torch.equal(v, before[k]) for k, v in old.state_dict().items())
    assert all(torch.equal(v, new_state[k]) for k, v in dep.engine.model.state_dict().items())
    assert dep.last_update["apply_s"] >= 0


def test_update_weights_refuses_a_mismatched_state_dict():
    model = llama.init(llama.LlamaConfig.tiny(), torch.Generator().manual_seed(2), "cpu")
    dep = LlamaDeployment.func_or_class(config=llama.LlamaConfig.tiny(), weights_loader=lambda: model,
                                        device="cpu")
    assert dep.engine.model is model
    bad_shape = dict(_tiny_state(1))
    bad_shape["final_norm"] = torch.ones(3)
    missing = dict(_tiny_state(1))
    missing.pop("lm_head")
    for bad in (bad_shape, missing):
        with pytest.raises(RuntimeError):
            dep.update_weights(bad)
        assert dep.engine.model is model


def test_deployment_device_defaults_to_cuda():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present; the default device is usable")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        LlamaDeployment.func_or_class(config=llama.LlamaConfig.tiny())


# -- on a cluster -----------------------------------------------------------

@pytest.fixture(scope="module")
def cluster():
    saved = {k: os.environ.pop(k) for k in _GPU_ENV if k in os.environ}
    os.environ["RT_GPU_COUNT_OVERRIDE"] = "1"
    port_config.cfg._values.pop("gpu_count_override", None)
    cloudpickle.register_pickle_by_value(sys.modules[__name__])
    try:
        rt.init(num_cpus=4, log_to_driver=False)
        yield
        serve.shutdown()
        rt.shutdown()
    finally:
        cloudpickle.unregister_pickle_by_value(sys.modules[__name__])
        os.environ.pop("RT_GPU_COUNT_OVERRIDE", None)
        port_config.cfg._values.pop("gpu_count_override", None)
        os.environ.update(saved)


def _jax_params(seed):
    params = jax_llama.init(jax.random.key(seed), jax_llama.LlamaConfig.tiny())
    return jax.tree_util.tree_map(np.asarray, params)


def _jax_tokens(np_params, prompts):
    engine = JaxLLMEngine(np_params, jax_llama.LlamaConfig.tiny(), **ENGINE)

    async def main():
        async def one(p):
            return [t async for t in engine.stream(p, MAX_NEW)]
        return await asyncio.gather(*(one(p) for p in prompts))

    return asyncio.run(main())


def _load_jax(np_params):
    return llama_params_from_jax(np_params, llama.LlamaConfig.tiny(), device="cpu")


def _streams(handle, prompts):
    out, errors = [None] * len(prompts), []

    def client(i):
        try:
            out[i] = list(handle.options(method_name="generate", stream=True).remote(prompts[i], MAX_NEW))
        except Exception as e:  # noqa: BLE001 — reported below
            errors.append(e)

    threads = [threading.Thread(target=client, args=(i,)) for i in range(len(prompts))]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=120)
    assert not errors, errors
    return out


def test_deployment_matches_jax_engine_before_and_after_a_push(cluster):
    p0, p1 = _jax_params(0), _jax_params(1)
    handle = serve.run(
        LlamaDeployment.options(name="llm").bind(
            config=llama.LlamaConfig.tiny(), weights_ref=rt.put(_load_jax(p0).state_dict()),
            device="cpu", **ENGINE),
        name="llm_app", route_prefix=None,
    )
    try:
        got = _streams(handle, PROMPTS)
        want = _jax_tokens(p0, PROMPTS)
        assert got == want
        assert all(len(t) == MAX_NEW and all(isinstance(x, int) for x in t) for t in got)
        assert len({tuple(t) for t in got}) == len(PROMPTS)
        new_state = _load_jax(p1).state_dict()
        assert serve.push_deployment_weights("llm", new_state, app_name="llm_app") == 1
        prompt = [9, 8, 7, 6]
        after = handle.options(method_name="generate_all").remote(prompt, MAX_NEW).result(timeout_s=60)
        assert after == _jax_tokens(p1, [prompt])[0]
        assert after != _jax_tokens(p0, [prompt])[0]
    finally:
        serve.delete("llm_app")


class _Holder:
    """A plain actor that takes pushed weights."""

    def __init__(self):
        self.w = None

    def update_weights(self, w):
        self.w = w
        return True

    def get(self):
        return self.w


def test_push_weights_over_two_ranks_is_bit_identical(cluster):
    tree = _tensor_tree()
    holder = rt.remote(num_cpus=0)(_Holder)
    actors = [holder.remote() for _ in range(2)]
    try:
        assert serve.push_weights(actors, tree, wire_dtype="int8") == 2
        a, b = rt.get([x.get.remote() for x in actors], timeout=60)
    finally:
        for x in actors:
            rt.kill(x)
    flat = np.concatenate([tree["w"].numpy().ravel(), tree["nested"][0].numpy().ravel(),
                           tree["nested"][1][1]])
    codec = ref_quantize.get_codec("int8")
    want = codec.decode(codec.encode(flat), flat.size)
    for out in (a, b):
        got = np.concatenate([out["w"].numpy().ravel(), out["nested"][0].numpy().ravel(),
                              out["nested"][1][1]])
        assert got.tobytes() == want.tobytes()
        assert out["w"].shape == tree["w"].shape and out["w"].dtype == torch.float32
        assert torch.equal(out["emb"], tree["emb"]) and out["emb"].dtype == torch.bfloat16
        assert torch.equal(out["step"], tree["step"])
        assert out["nested"][1][0] == "tag"


def _visible():
    return os.environ.get("CUDA_VISIBLE_DEVICES")


def test_gpu_replica_gets_its_lease(cluster):
    @serve.deployment(ray_actor_options={"num_gpus": 1})
    class Probe:
        def __call__(self):
            return _visible()

    h = serve.run(Probe.bind(), name="probe", route_prefix=None)
    try:
        assert h.remote().result(timeout_s=60) == "0"
    finally:
        serve.delete("probe")
    # the controller runs on a lease without a card, and the deployments it
    # started (a torch model's among them) reach it sealed: it loads no torch
    from ray_tpu_torch.serve.controller import get_or_create_controller

    facts = rt.get(get_or_create_controller()._apply(lambda _: (_visible(), _loaded())), timeout=30)
    assert facts == ("", [])


def _loaded():
    return sorted(m for m in ("torch", "jax") if m in sys.modules)


def test_cuda_replica_without_a_lease_raises_in_serve_run(cluster):
    with pytest.raises(RuntimeError, match="no CUDA device"):
        serve.run(LlamaDeployment.options(name="nolease").bind(config=llama.LlamaConfig.tiny()),
                  name="nolease", route_prefix=None)
    assert "nolease" not in serve.status()
