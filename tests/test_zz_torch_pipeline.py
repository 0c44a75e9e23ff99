"""The port's pipeline parallelism where it takes processes: the MPMD
``PipelineTrainer`` on the port's runtime with CPU stage actors, a stage's
exactly-once ledger and its checkpoint hooks, and the in-program pipeline
over 2, 4 and 8 gloo ranks against the JAX package on as many virtual
devices.

Marked slow: each trainer starts a worker a stage, each with a torch import
of its own, and the rank layouts spawn up to eight processes.  Run with
``python -m pytest tests/test_zz_torch_pipeline.py -m slow``.

The trainer is held to the port's ``LocalPipelineRunner`` bit for bit (the
same per-stage programs in one process); the rank layouts to the
reference's steps at the f32 tolerance of ``test_torch_pipeline.py``.
"""


import contextlib
import os
import sys
import threading
import time

import cloudpickle
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import test_torch_pipeline as base
import test_torch_runtime
import torch_pipeline_ranks as ranks
import ray_tpu_torch as rt
from ray_tpu.models import gpt2 as jax_gpt2
from ray_tpu.models import llama as jax_llama
from ray_tpu.models import pp as jax_pp
from ray_tpu.parallel import mesh as jax_mesh
from ray_tpu_torch.models import gpt2, llama
from ray_tpu_torch.parallel.launch import run_ranks
from ray_tpu_torch.train import pipeline as tp
from ray_tpu_torch.train.backend_executor import TrainWorkerGroupError
from ray_tpu_torch.train.pipeline import driver as tp_driver
from ray_tpu_torch.train.pipeline import schedule

pytestmark = pytest.mark.slow
TOL = base.TOL


def equal_models(a, b) -> bool:
    sa, sb = a.state_dict(), b.state_dict()
    return sa.keys() == sb.keys() and all(torch.equal(sa[k], sb[k]) for k in sa)


# -- the trainer on the port's runtime -----------------------------------------

@pytest.fixture(scope="class")
def cluster():
    """Eight CPUs and two declared GPUs (on a host without a card, a stage
    leased one finds no CUDA device), for one class's tests: the tests
    between the classes start runtimes of their own."""
    with test_torch_runtime.runtime_defaults():
        rt.init(num_cpus=8, num_gpus=2, log_to_driver=False)
        try:
            yield
        finally:
            rt.shutdown()


def parity_config(handoff, **kw):
    """The reference's bit-parity configuration (tests/test_zz_pipeline.py)."""
    args = dict(model_config=gpt2.GPTConfig.tiny(num_layers=3, max_seq_len=32), n_stages=3, n_micro=4,
                micro_batch=2, seq_len=32, optimizer={"name": "adam", "lr": 1e-3},
                name=f"parity-{handoff}", handoff=handoff, device="cpu")
    args.update(kw)
    return tp.PipelineConfig(**args)


def train_both(pc, steps):
    """``steps`` synthetic steps through a PipelineTrainer and through the
    LocalPipelineRunner: (trainer losses, runner losses, trainer params,
    runner params, micro-ops the stage lanes executed, the ideal count)."""
    batches = tp.synthetic_batches(pc, steps)
    trainer = tp.PipelineTrainer(pc)
    trainer.start()
    try:
        losses = trainer.train(batches)
        params = trainer.gather_params()
        executed = sum(c["executed"] for lanes in trainer.counters() for c in lanes)
        ideal = trainer.ideal_micro_ops(steps)
        extra = {"ranks": rt.get([a.group_rank.remote() for a in trainer.actors[0]], timeout=60)
                 if pc.dp > 1 else None}
    finally:
        trainer.shutdown()
    ref = tp.LocalPipelineRunner(pc)
    return losses, ref.train(batches), params, ref.gather_params(), executed, ideal, extra


@pytest.mark.usefixtures("cluster")
class TestTrainer:
    @pytest.mark.parametrize("handoff", ["p2p", "driver"])
    def test_three_stage_gpt2_bitwise_vs_local_runner(self, handoff):
        """A 3-stage bf16 GPT-2 over stage actor gangs trains to the local
        runner's losses and parameters bit for bit, every micro-op run
        once; its first loss is the unpipelined model's."""
        pc = parity_config(handoff)
        losses, want, params, want_params, executed, ideal, _ = train_both(pc, 3)
        assert losses == want
        assert equal_models(params, want_params)
        assert executed == ideal
        (x, y), = tp.synthetic_batches(pc, 1)
        model = gpt2.init(pc.model_config, torch.Generator().manual_seed(pc.seed), "cpu")
        with torch.no_grad():
            mono = gpt2.loss_fn(model, {"inputs": torch.from_numpy(x.reshape(-1, 32)).long(),
                                        "targets": torch.from_numpy(y.reshape(-1, 32)).long()}).item()
        assert np.isclose(losses[0], mono, rtol=1e-3), (losses[0], mono)

    def test_dp2_stage_groups_bitwise(self):
        """dp = 2 lanes a stage: the gradients all-reduce through each
        stage's collective group (a 2-rank ring sum, a + b), bit for bit
        the local runner's lane sum."""
        pc = parity_config("p2p", model_config=gpt2.GPTConfig.tiny(num_layers=2, max_seq_len=32),
                           n_stages=2, n_micro=3, micro_batch=4, dp=2, optimizer={"name": "sgd", "lr": 0.1},
                           name="dp2")
        losses, want, params, want_params, executed, ideal, extra = train_both(pc, 2)
        assert losses == want
        assert equal_models(params, want_params)
        assert executed == ideal
        assert extra["ranks"] == [0, 1]

    def test_two_stage_llama(self):
        cfg = llama.LlamaConfig.tiny(dtype=torch.bfloat16, max_seq_len=32)
        pc = parity_config("p2p", model="llama", model_config=cfg, n_stages=2, name="llama")
        losses, want, params, want_params, executed, ideal, _ = train_both(pc, 2)
        assert losses == want
        assert equal_models(params, want_params)
        assert executed == ideal

    def test_cuda_trainer_refused_without_cards(self):
        """A "cuda" pipeline wanting more cards than the cluster declares is
        refused at start(), naming both counts, before any stage is placed;
        one that fits the declared cards but lands on a lease with no CUDA
        device fails in its stages' configure, not on the CPU."""
        before = rt.available_resources()
        with pytest.raises(RuntimeError, match=r"wants 3 GPU\(s\) \(3 stages x dp 1 x 1\), "
                                               r"the cluster has 2"):
            tp.PipelineTrainer(tp.PipelineConfig(model_config=gpt2.GPTConfig.tiny(num_layers=3),
                                                 n_stages=3, name="refused")).start()
        assert rt.available_resources() == before
        trainer = tp.PipelineTrainer(tp.PipelineConfig(model_config=gpt2.GPTConfig.tiny(), n_stages=2,
                                                       name="no-card"))
        try:
            with pytest.raises(TrainWorkerGroupError, match="wants device 'cuda', but its lease holds no card"):
                trainer.start()
        finally:
            trainer.shutdown()


# -- a stage host preempted mid-run: the drain migrates the stage ------------

def _gcs(method, payload):
    from ray_tpu_torch.core.runtime import get_runtime

    runtime = get_runtime()
    return runtime._run(runtime.gcs.call(method, payload))


def preemption_run(steps, seed, preempt_after_step=2, deadline_s=20.0, preemptions=1):
    """The reference's acceptance scenario: the 3-stage GPT-2 at dp = 2
    (every stage a 2-rank collective group), the middle stage's lane 1 on a
    preemptible node, a seeded preemption of that node after
    ``preempt_after_step`` steps while training goes on (with
    ``preemptions=2``, the node the lane moved to is preempted in turn);
    raylets of ``cluster_utils.Cluster``."""
    from ray_tpu_torch.cluster_utils import Cluster
    from ray_tpu_torch.common.faults import ChaosController
    from ray_tpu_torch.core.runtime import get_runtime

    pc = parity_config("p2p", micro_batch=4, dp=2, name=f"accept{seed}")
    cluster = Cluster()
    try:
        cluster.add_node(4, resources={"h": 8.0})
        rt.init(address=cluster.address, log_to_driver=False)
        victim = cluster.add_node(1, resources={"pre": 1.0})
        cluster.wait_for_nodes()
        h = {"num_cpus": 0, "resources": {"h": 0.5}}
        v = {"num_cpus": 0, "resources": {"pre": 0.4}}
        trainer = tp.PipelineTrainer(pc, stage_actor_options=[[h, h], [h, v], [h, h]])
        trainer.start()
        batches = tp.synthetic_batches(pc, steps)
        losses, errs, reached = [], [], threading.Event()

        def loop():
            try:
                for i, (x, y) in enumerate(batches):
                    losses.append(trainer.run_step(x, y))
                    if i == preempt_after_step - 1:
                        reached.set()
            except BaseException as e:  # noqa: BLE001 — asserted below
                errs.append(e)
                reached.set()

        th = threading.Thread(target=loop, daemon=True)
        th.start()
        assert reached.wait(timeout=300), "never reached the preempt step"
        assert not errs, errs
        chaos = ChaosController(cluster, seed=seed)
        states = []
        for _ in range(preemptions):
            spare = cluster.add_node(1, resources={"pre": 1.0})
            cluster.wait_for_nodes()
            _, state = chaos.preempt_node(node=victim, deadline_s=deadline_s)
            states.append(state)
            victim = spare  # the lane's next home
        th.join(timeout=600)
        assert not th.is_alive(), "training wedged after the preemption"
        assert not errs, f"driver-visible failure: {errs!r}"
        moved = trainer.actors[1][1]._actor_id.hex()
        result = {
            "pc": pc, "losses": losses, "drain_states": states,
            "executed": sum(c["executed"] for lanes in trainer.counters() for c in lanes),
            "ideal": trainer.ideal_micro_ops(steps),
            "ranks": rt.get([trainer.actors[1][r].group_rank.remote() for r in range(2)], timeout=120),
            "moved_row": next(r for r in _gcs("list_actors", {}) if r["actor_id"] == moved),
            "reconstructions": get_runtime().reconstructions,
            "chaos_log": [e["event"] for e in chaos.log],
        }
        trainer.shutdown()
        return result
    finally:
        rt.shutdown()
        cluster.shutdown()


def test_seeded_mid_run_preemption_costs_at_most_one_bubble():
    """A middle-stage host preempted mid-run: no driver-visible failure,
    the loss trajectory bit for bit the undisturbed local runner's (the
    stage's parameters, optimizer state and in-flight microbatches moved
    with it), at most one pipeline bubble of micro-ops re-run, no lineage
    reconstruction, the lane re-joined its group under its rank with no
    restart spent."""
    r = preemption_run(steps=8, seed=2026)
    pc = r["pc"]
    assert r["drain_states"] == ["drained"]
    assert r["losses"] == tp.LocalPipelineRunner(pc).train(tp.synthetic_batches(pc, 8))
    assert 0 <= r["executed"] - r["ideal"] <= schedule.bubble_micro_ops(pc.n_stages)
    assert r["reconstructions"] == 0
    assert r["ranks"] == [0, 1]
    assert r["moved_row"]["restarts_used"] == 0 and r["moved_row"]["state"] == "ALIVE"
    assert r["chaos_log"] == ["node_preempt", "node_kill"]


def test_preemption_is_seed_reproducible():
    """The same seed on a fresh cluster: the same drain verdict, the same
    loss trajectory bit for bit and the same chaos log."""
    a = preemption_run(steps=6, seed=777)
    b = preemption_run(steps=6, seed=777)
    assert a["drain_states"] == b["drain_states"] == ["drained"]
    assert a["losses"] == b["losses"]
    assert a["chaos_log"] == b["chaos_log"]


def test_two_sequential_stage_host_preemptions():
    """The middle stage's lane preempted twice (its second home is the
    first spare): the pipeline survives both, bit for bit the local
    runner's."""
    r = preemption_run(steps=12, seed=31337, deadline_s=30.0, preemptions=2)
    assert r["drain_states"] == ["drained", "drained"]
    assert r["losses"] == tp.LocalPipelineRunner(r["pc"]).train(tp.synthetic_batches(r["pc"], 12))
    assert r["reconstructions"] == 0
    assert r["chaos_log"] == ["node_preempt", "node_kill"] * 2


# -- the channel plane under injected faults, and the handoff's copies -------

@pytest.mark.parametrize("side", ["send", "recv"])
def test_nth_hit_channel_drop_is_bitwise_invisible(side):
    """A drop armed through RT_FAULTS (inherited by the stage workers) on
    the forward stream's 3rd and 4th hits, at the send attempt or at the
    receive poll: the channel absorbs it (a send retries the same seq, a
    receive parks its round), so the losses are the local runner's bit for
    bit, at most one bubble of micro-ops re-runs, and the firing shows in
    the workers' fault traces."""
    from ray_tpu_torch.common import faults
    from ray_tpu_torch.common.faults import FaultPlan

    name = f"chaos{side[0]}"
    plan = FaultPlan(site=faults.SITE_COLLECTIVE_P2P, action="drop",
                     match=f"{name}:lane0:pp:{side}:F.", nth=3, count=2)
    pc = parity_config("p2p", name=name)
    with test_torch_runtime.runtime_defaults():
        os.environ["RT_FAULTS"] = faults.plans_to_json([plan])
        rt.init(num_cpus=4, log_to_driver=False)
        try:
            trainer = tp.PipelineTrainer(pc)
            trainer.start()
            batches = tp.synthetic_batches(pc, 3)
            losses = trainer.train(batches)
            counters = trainer.counters()
            trainer.shutdown()
        finally:
            rt.shutdown()
            os.environ.pop("RT_FAULTS", None)
            faults.clear()
    assert losses == tp.LocalPipelineRunner(pc).train(batches)
    executed = sum(c["executed"] for lanes in counters for c in lanes)
    assert 0 <= executed - trainer.ideal_micro_ops(3) <= schedule.bubble_micro_ops(pc.n_stages)
    fired = [e for lanes in counters for c in lanes for e in c["fault_trace"]
             if e["site"] == faults.SITE_COLLECTIVE_P2P]
    assert fired, "the armed collective.p2p plan never fired"
    assert all(e["action"] == "drop" and f":{side}:F." in e["ctx"] for e in fired)


@pytest.mark.usefixtures("cluster")
class TestHandoffCopies:
    def test_small_activations_ride_the_inline_slab(self):
        """Activations under 16 KiB (2 rows x 32 x 64 in bf16: 8 KiB) under
        the driver handoff: each reply is inline, and passing its ref on
        publishes it through the driver's put path into the inline slab."""
        from ray_tpu_torch.core.runtime import get_runtime

        pc = parity_config("driver", model_config=gpt2.GPTConfig.tiny(num_layers=2, max_seq_len=32),
                           n_stages=2, name="slabrun")
        trainer = tp.PipelineTrainer(pc)
        trainer.start()
        try:
            batches = tp.synthetic_batches(pc, 2)
            trainer.run_step(*batches[0])
            store = get_runtime().store
            hits0 = store.stats()["slab_hits"]
            trainer.run_step(*batches[1])
            assert store.stats()["slab_hits"] - hits0 >= pc.n_micro
        finally:
            trainer.shutdown()

    def test_large_activations_copied_once(self):
        """Activations above the inline cap (4 rows x 64 x 256 in bf16:
        128 KiB) are stored by the producing worker: its serializer writes
        each stored byte once (the out-of-band tensors: the activations and
        the tail gradients of 64 KiB or more), and the driver, which only
        passes refs on, copies no payload."""
        from ray_tpu_torch.common import serialization as ser
        from ray_tpu_torch.common.config import cfg as rt_cfg

        cfg = gpt2.GPTConfig.tiny(num_layers=2, max_seq_len=64, embed_dim=256)
        pc = parity_config("driver", model_config=cfg, n_stages=2, micro_batch=4, seq_len=64,
                           name="bigact")
        act_bytes = 4 * 64 * 256 * 2
        assert act_bytes > rt_cfg.inline_object_max_bytes
        tail = [cfg.vocab_size * 256 * 4, 64 * 256 * 4, 256 * 4, 256 * 4]  # wte, wpe, lnf
        oob = 64 * 1024  # the serializer's out-of-band threshold for a tensor
        trainer = tp.PipelineTrainer(pc)
        trainer.start()
        try:
            batches = tp.synthetic_batches(pc, 2)
            trainer.run_step(*batches[0])
            c0 = rt.get(trainer.actors[0][0].counters.remote(), timeout=120)["copy_trace"]
            d0 = dict(ser.COPY_TRACE)
            trainer.run_step(*batches[1])
            c1 = rt.get(trainer.actors[0][0].counters.remote(), timeout=120)["copy_trace"]
            d1 = dict(ser.COPY_TRACE)
        finally:
            trainer.shutdown()
        assert c1["writes"] - c0["writes"] >= pc.n_micro + 1
        assert (c1["payload_bytes"] - c0["payload_bytes"]
                == pc.n_micro * act_bytes + sum(n for n in tail if n >= oob))
        assert d1["payload_bytes"] == d0["payload_bytes"]


# -- channel reform and checkpoint blobs --------------------------------------

class ChanMember:
    """One end of a 2-rank channel group, driven method by method (an actor
    class; it travels to the workers by value)."""

    def init(self, world, rank, group):
        col().init_collective_group(world, rank, group_name=group)
        return col().get_rank(group)

    def open_sender(self, group, dst, window=2):
        self._tx = col().ChannelSender(group, "F", dst, window=window)
        return True

    def open_receiver(self, group, src):
        self._rx = col().ChannelReceiver(group, "F", src)
        return True

    def post(self, seq, arr):
        self._tx.post(seq, np.asarray(arr))
        return True

    def post_empty_error(self, seq):
        try:
            self._tx.post(seq, np.empty((0,), np.float32))
        except col().ChannelError as e:
            return str(e)
        return None

    def flush(self):
        self._tx.flush(timeout=90.0)
        return True

    def fetch(self, seq):
        return self._rx.fetch(seq, timeout=90.0)

    def outbox_seqs(self):
        return sorted(self._tx.outbox_state())

    def purge_below(self, seq):
        self._tx.purge_below(seq)
        return sorted(self._tx.outbox_state())

    def reform(self, world, group, rank=None):
        col().reform_collective_group(world, group_name=group, rank=rank)
        return col().get_rank(group)


def col():
    from ray_tpu_torch.util import collective

    return collective


@contextlib.contextmanager
def by_value():
    cloudpickle.register_pickle_by_value(sys.modules[__name__])
    try:
        yield
    finally:
        cloudpickle.unregister_pickle_by_value(sys.modules[__name__])


def test_replacement_receiver_gets_the_outbox_resent():
    """The receiving member of a channel is killed mid-stream and a
    replacement joins by reform under its rank: the sender's group listener
    re-offers its whole outbox to the new incarnation, so the replacement
    fetches every seq bit for bit with no post from the application; the
    step-boundary purge then empties the outbox, and an empty payload is
    refused (a zero-byte send has no chunk to acknowledge)."""
    group = "chrf2"
    rng = np.random.default_rng(2026)
    payloads = {s: rng.standard_normal(4096).astype(np.float32) for s in range(3)}
    with test_torch_runtime.runtime_defaults(), by_value():
        rt.init(num_cpus=4, log_to_driver=False)
        try:
            member = rt.remote(ChanMember)
            ms = [member.options(num_cpus=0).remote() for _ in range(2)]
            assert rt.get([m.init.remote(2, i, group) for i, m in enumerate(ms)], timeout=120) == [0, 1]
            rt.get([ms[0].open_sender.remote(group, 1), ms[1].open_receiver.remote(group, 0)], timeout=60)
            rt.get(ms[0].post.remote(0, payloads[0]), timeout=60)
            assert np.array_equal(rt.get(ms[1].fetch.remote(0), timeout=120), payloads[0])
            for s in (1, 2):
                rt.get(ms[0].post.remote(s, payloads[s]), timeout=60)
            rt.get(ms[0].flush.remote(), timeout=120)
            assert rt.get(ms[0].outbox_seqs.remote(), timeout=60) == [0, 1, 2]
            rt.kill(ms[1])
            time.sleep(1.0)
            fresh = member.options(num_cpus=0).remote()
            assert rt.get([ms[0].reform.remote(2, group), fresh.reform.remote(2, group, 1)],
                          timeout=120) == [0, 1]
            rt.get(fresh.open_receiver.remote(group, 0), timeout=60)
            for s in range(3):
                assert np.array_equal(rt.get(fresh.fetch.remote(s), timeout=120), payloads[s]), s
            assert rt.get(ms[0].purge_below.remote(3), timeout=60) == []
            err = rt.get(ms[0].post_empty_error.remote(99), timeout=60)
            assert err is not None and "empty" in err
        finally:
            rt.shutdown()


class BigState:
    def __init__(self):
        self.arr = None

    def fill(self, n):
        self.arr = np.arange(n, dtype=np.int64)
        return True

    def total(self):
        return int(self.arr.sum())

    def pid(self):
        return os.getpid()

    def __rt_checkpoint__(self):
        return {"arr": self.arr}

    def __rt_restore__(self, state):
        self.arr = state["arr"]


class SmallState:
    def __init__(self):
        self.n = 0

    def inc(self):
        self.n += 1
        return self.n

    def value(self):
        return self.n

    def __rt_checkpoint__(self):
        return {"n": self.n}

    def __rt_restore__(self, state):
        self.n = state["n"]


def test_checkpoint_blob_rides_the_object_plane():
    """One drain, two checkpointed actors: the 4 MB state goes through the
    object plane (one blob object in the drain's status), the small one
    stays inline in the GCS; both move with their state and no restart
    spent, and the blob's record is gone after the restore."""
    from ray_tpu_torch.cluster_utils import Cluster
    from ray_tpu_torch.common.faults import ChaosController

    with test_torch_runtime.runtime_defaults(), by_value():
        os.environ["RT_ACTOR_CKPT_INLINE_MAX_BYTES"] = "20000"
        cluster = Cluster()
        try:
            cluster.add_node(2, resources={})
            rt.init(address=cluster.address, log_to_driver=False)
            victim = cluster.add_node(1, resources={"pre": 1.0})
            cluster.wait_for_nodes()
            opts = dict(num_cpus=0, resources={"pre": 0.3}, max_restarts=0)
            big = rt.remote(BigState).options(**opts).remote()
            small = rt.remote(SmallState).options(**opts).remote()
            rt.get(big.fill.remote(500_000), timeout=120)
            expect, pid0 = rt.get([big.total.remote(), big.pid.remote()], timeout=60)
            for _ in range(3):
                rt.get(small.inc.remote(), timeout=60)
            cluster.add_node(1, resources={"pre": 1.0})
            cluster.wait_for_nodes()
            _, state = ChaosController(cluster, seed=17).preempt_node(node=victim, deadline_s=20.0)
            assert state == "drained", state
            st = _gcs("get_drain_status", {"node_id": victim.node_id})
            assert st["ckpt_blob_objects"] == 1 and st["actors_moved"] == 2, st
            assert rt.get(big.total.remote(), timeout=120) == expect
            assert rt.get(big.pid.remote(), timeout=60) != pid0
            assert rt.get(small.value.remote(), timeout=120) == 3
            rows = {r["actor_id"]: r for r in _gcs("list_actors", {})}
            for a in (big, small):
                row = rows[a._actor_id.hex()]
                assert row["restarts_used"] == 0 and row["state"] == "ALIVE"
            assert _gcs("kv_get", {"key": f"__rt_actor_ckpt:{big._actor_id.hex()}"}) is None
        finally:
            os.environ.pop("RT_ACTOR_CKPT_INLINE_MAX_BYTES", None)
            rt.shutdown()
            cluster.shutdown()


# -- a stage's ledger and checkpoint hooks, in process -------------------------

def local_stages(pc, pp_params=None):
    """The driver-handoff stage objects of ``pc``, configured in this
    process (no runtime: dp 1, no channels)."""
    pp_params = pp_params if pp_params is not None else tp.init_pp_params(pc)
    tail = pp_params["tail"].state_dict()
    stages = []
    for s in range(pc.n_stages):
        st = tp.PipelineStageActor._cls()
        st.configure(pc.stage_spec(s, 0), pp_params["stages"][s].state_dict(),
                     tail if s in (0, pc.n_stages - 1) else None)
        stages.append(st)
    return stages


def drive(stages, pc, step, tokens, targets, ops, done):
    """Run ``ops`` (submission-order triples) of one step that ``done``
    has not seen, passing activations and gradients as the driver does."""
    S = pc.n_stages
    for s, kind, m in ops:
        if (s, kind, m) in done:
            continue
        if kind == "F":
            arg = tokens[m] if s == 0 else done[(s - 1, "F", m)]
            done[(s, kind, m)] = stages[s].forward(step, m, arg, targets[m] if s == S - 1 else None)
        else:
            done[(s, kind, m)] = stages[s].backward(step, m, done[(s + 1, "B" if s < S - 2 else "F", m)])


def finish(stages, pc, step):
    S = pc.n_stages
    first, last = stages[0].tail_grads(step), stages[S - 1].tail_grads(step)
    stages[0].apply_gradients(step, last)
    stages[S - 1].apply_gradients(step, first)
    for s in range(1, S - 1):
        stages[s].apply_gradients(step)
    return stages[S - 1].step_loss(step)


def test_retried_micro_op_returns_the_cached_reply():
    """A micro-op called again (a retry after a lost reply) returns the
    ledger's reply and applies nothing twice: the step still equals the
    local runner's bit for bit."""
    pc = parity_config("driver")
    stages = local_stages(pc)
    (x, y), = tp.synthetic_batches(pc, 1)
    done = {}
    order = schedule.submission_order(pc.n_stages, pc.n_micro)
    drive(stages, pc, 0, x, y, order, done)
    for s, kind, m in order[:6]:  # retried: same replies, no second execution
        op = stages[s].forward if kind == "F" else stages[s].backward
        arg = x[m] if (s, kind) == (0, "F") else None
        again = op(0, m, arg, y[m]) if (kind, s) == ("F", pc.n_stages - 1) else op(0, m, arg)
        assert again is done[(s, kind, m)]
    assert sum(st._deduped for st in stages) == 6
    assert [st._executed for st in stages] == [2 * pc.n_micro, 2 * pc.n_micro, pc.n_micro]
    loss = finish(stages, pc, 0)
    ref = tp.LocalPipelineRunner(pc)
    assert loss == ref.run_step(x, y)
    assert equal_models(tp_driver._merged(pc, [st.get_params()["blocks"] for st in stages],
                                          stages[0].get_params()["tail"]), ref.gather_params())


def test_checkpoint_restore_mid_step_finishes_bitwise():
    """The middle stage checkpointed halfway through step 1 and restored
    into a fresh actor from the checkpoint's bytes (its stash, accumulators,
    ledger and optimizer state) finishes the step, and the next, bit for
    bit as the local runner does."""
    pc = parity_config("driver")
    stages = local_stages(pc)
    batches = tp.synthetic_batches(pc, 3)
    order = schedule.submission_order(pc.n_stages, pc.n_micro)
    losses = []
    for step, (x, y) in enumerate(batches):
        done = {}
        if step == 1:
            half = len(order) // 2
            drive(stages, pc, step, x, y, order[:half], done)
            state = cloudpickle.loads(cloudpickle.dumps(stages[1].__rt_checkpoint__()))
            assert state["stash"] and state["acc_blocks"] and state["ledger"]
            stages[1] = tp.PipelineStageActor._cls()
            stages[1].__rt_restore__(state)
            # the restored stage answers the ops it ran before from its ledger
            done = {k: v for k, v in done.items() if k[0] != 1}
        drive(stages, pc, step, x, y, order, done)
        losses.append(finish(stages, pc, step))
    ref = tp.LocalPipelineRunner(pc)
    assert losses == ref.train(batches)
    assert stages[1]._deduped > 0
    assert equal_models(tp_driver._merged(pc, [st.get_params()["blocks"] for st in stages],
                                          stages[0].get_params()["tail"]), ref.gather_params())


# -- the in-program pipeline over 2, 4 and 8 gloo ranks ------------------------

def model_case(kind, mesh, lr=1e-4, steps=2, seq=16, **cfg):
    np_params = base.draw_params(kind, max_seq_len=seq, **cfg)
    toks = base.tokens((4, 2, seq + 1))
    return dict(kind=kind, mesh=mesh, np_params=np_params, x=toks[..., :-1], y=toks[..., 1:], lr=lr,
                steps=steps, cfg=dict(max_seq_len=seq, **cfg))


def jax_model_pp(case, n):
    """The reference's {gpt2,llama}_pp_train_step on n virtual devices:
    the losses and the cut parameters after them."""
    mod = {"gpt2": jax_gpt2, "llama": jax_llama}[case["kind"]]
    cfg = base.JAX_FAMILIES[case["kind"]][1].tiny(dtype=jnp.float32, **case["cfg"])
    mesh = jax_mesh.make_mesh(jax_mesh.MeshConfig(**case["mesh"]), devices=jax.devices()[:n])
    try:
        opt = optax.adam(case["lr"])
        part = jax_pp.get_partition(case["kind"], cfg)
        params = part.to_pp(jax.tree.map(jnp.asarray, case["np_params"]), mesh.shape["pp"])
        params = jax.device_put(params, jax_pp.pp_params_sharding(mesh, params))
        state = opt.init(params)
        step_fn = jax_pp.gpt2_pp_train_step if mod is jax_gpt2 else jax_pp.llama_pp_train_step
        step = step_fn(cfg, mesh, opt, n_micro=case["x"].shape[0])
        losses = []
        for _ in range(case["steps"]):
            params, state, loss = step(params, state, case["x"], case["y"])
            losses.append(float(loss))
        return losses, jax.tree.map(np.asarray, params)
    finally:
        jax_mesh.set_current_mesh(None)


def assert_model_pp_matches(results, case, n):
    got = {r["pp"]: r for r in results if r is not None}
    want_losses, want = jax_model_pp(case, n)
    assert sorted(got) == list(range(len(got)))
    for r in got.values():
        np.testing.assert_allclose(r["losses"], want_losses, rtol=TOL)
    for s, r in got.items():
        for name, v in r["stage"].items():  # "i.leaf": layer i of stage s
            i, leaf = name.split(".", 1)
            base.close(v, want["stages"][leaf][s, int(i)], what=f"stage {s} {name}")
        for name, v in r["tail"].items():
            base.close(v, want["tail"][name], what=f"stage {s}'s tail {name}")


TWO_RANK_CASES = [model_case("gpt2", {"dp": 1, "pp": 2}), model_case("llama", {"dp": 1, "pp": 2})]


@pytest.mark.parametrize("i", range(len(TWO_RANK_CASES)), ids=["gpt2", "llama"])
def test_two_rank_model_pp_matches_reference(two_rank_results, i):
    assert_model_pp_matches([r[i] for r in two_rank_results], TWO_RANK_CASES[i], 2)


@pytest.fixture(scope="module")
def two_rank_results():
    return run_ranks(ranks.jobs, 2, 2, [("model_pp_steps", c) for c in TWO_RANK_CASES],
                     backend="gloo", timeout=600)


GPIPE4 = base.gpipe_case(4)


def test_four_rank_gpipe_matches_reference():
    """Pass 3 at four stages against the reference on four virtual devices."""
    got = run_ranks(ranks.gpipe_steps, 4, 4, GPIPE4, backend="gloo", timeout=600)[0]
    want_losses, want_params = base.jax_gpipe(GPIPE4, 4)
    np.testing.assert_allclose(got["losses"], want_losses, rtol=TOL)
    for k in ("w", "b"):
        base.close(got["params"][k], want_params[k], what=k)


EIGHT_RANK_CASE = model_case("gpt2", {"dp": 2, "pp": 2, "tp": 2})


def test_eight_rank_gpt2_dp2_pp2_tp2_matches_reference():
    """``gpt2_pp_train_step`` over dp2 x pp2 x tp2: each stage's and each
    tail copy's parameters after two Adam steps, and the losses, against
    the reference's on eight virtual devices."""
    got = run_ranks(ranks.model_pp_steps, 8, 8, EIGHT_RANK_CASE, backend="gloo", timeout=600)
    assert_model_pp_matches(got, EIGHT_RANK_CASE, 8)


def test_dryrun_eight_ranks_runs_the_pipeline_passes(capsys):
    from ray_tpu_torch.dryrun import dryrun_multigpu

    lines = dryrun_multigpu(8, device_type="cpu")
    passes = [line.split(":")[0] for line in lines]
    assert passes == ["dryrun_multigpu OK", "dryrun_multigpu MoE OK", "dryrun_multigpu pipeline OK",
                      "dryrun_multigpu gpt2-pp OK", "dryrun_multigpu multislice OK",
                      "dryrun_multigpu decode OK", "dryrun_multigpu vit OK",
                      "dryrun_multigpu distributed OK"]
    assert "dryrun_multigpu pipeline OK: 4 stages" in capsys.readouterr().out
    assert "gpt2-pp OK: mesh=dp=2xpp=2xtp=2" in lines[3]
