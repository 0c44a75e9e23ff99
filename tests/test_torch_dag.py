"""The port's compiled DAGs (``ray_tpu_torch.dag``) against the JAX
package's (``ray_tpu.dag``), on the CPU.

The channel's wire format is shared byte for byte: a channel made by one
package is read by the other, and the same writes leave the same bytes.
Both runtimes run in this process, side by side (one module-scoped cluster
each, 4 CPUs, three actors each): every case builds the same graph in both
packages over the same actor classes, executes it on the same inputs, and
the results must be equal (exact: Python ints and the same errors).  The
throughput, pipelined-in-flight and actor-death tests are in
``tests/test_zz_torch_dag.py``.
"""

import os
import sys

import cloudpickle
import pytest
import torch

import ray_tpu
import ray_tpu.dag as ref_dag
import ray_tpu_torch
import ray_tpu_torch.dag as port_dag
from ray_tpu.dag import channel as ref_channel
from ray_tpu_torch.dag import channel as port_channel
from test_torch_runtime import runtime_defaults

PACKAGES = {"ref": (ray_tpu, ref_dag), "port": (ray_tpu_torch, port_dag)}


class Adder:
    def __init__(self, delta):
        self.delta = delta
        self.calls = 0

    def add(self, x):
        self.calls += 1
        return x + self.delta

    def boom(self, x):
        raise ValueError(f"boom on {x}")

    def call_count(self):
        return self.calls

    def mul_add(self, x, m, c):
        return x * m + c

    def scaled(self, x):
        return torch.arange(6, dtype=torch.float32).reshape(2, 3) * x

    def big(self, x):
        return b"x" * (1 << 16)


@pytest.fixture(scope="module")
def actors():
    """Both runtimes up, each with actors a (+1), b (+10) and c (+100)."""
    module = sys.modules[__name__]
    cloudpickle.register_pickle_by_value(module)
    with runtime_defaults():
        ray_tpu.init(num_cpus=4, num_tpus=0, log_to_driver=False)
        try:
            ray_tpu_torch.init(num_cpus=4, log_to_driver=False)
            try:
                out = {}
                for name, (rt, _) in PACKAGES.items():
                    cls = rt.remote(num_cpus=0.5)(Adder)
                    out[name] = {k: cls.remote(d) for k, d in (("a", 1), ("b", 10), ("c", 100))}
                for name, (rt, _) in PACKAGES.items():
                    rt.get([h.call_count.remote() for h in out[name].values()], timeout=120)
                yield out
            finally:
                ray_tpu_torch.shutdown()
        finally:
            ray_tpu.shutdown()
            cloudpickle.unregister_pickle_by_value(module)


def run(dag_node, inputs):
    dag = dag_node.experimental_compile()
    try:
        return [dag.execute(x).get(timeout=60) for x in inputs]
    finally:
        dag.teardown()


def both(actors, build, inputs):
    """The graph ``build(dag_module, actors)`` run on both runtimes."""
    return {name: run(build(d, actors[name]), inputs) for name, (_, d) in PACKAGES.items()}


# -- channels ---------------------------------------------------------------


@pytest.mark.parametrize("maker,reader", [(port_channel, ref_channel), (ref_channel, port_channel)],
                         ids=["port-writes", "ref-writes"])
def test_channel_crosses_packages(maker, reader):
    name = maker.make_channel_name()
    ch = maker.Channel(name, 1 << 12, create=True)
    other = reader.Channel(name, 1 << 12)
    try:
        for i in range(5):
            ch.write(b"y" * (7 * i))
            assert other.read(timeout=5) == b"y" * (7 * i)
        other.write(b"back")
        assert ch.read(timeout=5) == b"back"
        other.close()
        with pytest.raises(maker.ChannelClosedError):
            ch.read(timeout=5)
    finally:
        other.detach()
        ch.unlink()


def test_channel_bytes_equal():
    """The same writes leave the same file bytes: the 32-byte ``<IIQQQ``
    header (state, pad, length, seq, capacity) and the payload."""
    assert port_channel.HEADER_BYTES == ref_channel.HEADER_BYTES == 32
    assert (port_channel.EMPTY, port_channel.FULL, port_channel.CLOSED) == (
        ref_channel.EMPTY, ref_channel.FULL, ref_channel.CLOSED) == (0, 1, 2)
    raw = {}
    for mod in (port_channel, ref_channel):
        ch = mod.Channel(mod.make_channel_name(), 64, create=True)
        try:
            ch.write(b"abc")
            ch.read(timeout=5)
            ch.write(b"defgh")
            with open(ch.path, "rb") as f:
                raw[mod] = f.read()
        finally:
            ch.unlink()
    assert raw[port_channel] == raw[ref_channel]
    assert raw[port_channel][:32] == port_channel._HDR.pack(1, 0, 5, 2, 64)


# -- compiled DAGs, each graph on both runtimes ------------------------------


def test_linear(actors):
    def build(d, h):
        with d.InputNode() as inp:
            return h["b"].add.bind(h["a"].add.bind(inp))

    got = both(actors, build, range(10))
    assert got["port"] == got["ref"] == [i + 11 for i in range(10)]


def test_fanout_multi_output(actors):
    def build(d, h):
        with d.InputNode() as inp:
            return d.MultiOutputNode([h["a"].add.bind(inp), h["c"].add.bind(inp),
                                      h["b"].add.bind(h["a"].add.bind(inp))])

    got = both(actors, build, [5, -3])
    assert got["port"] == got["ref"] == [[6, 105, 16], [-2, 97, 8]]


def test_same_actor_chain(actors):
    def build(d, h):
        with d.InputNode() as inp:
            return h["a"].add.bind(h["a"].add.bind(h["a"].add.bind(inp)))

    got = both(actors, build, [0, 4])
    assert got["port"] == got["ref"] == [3, 7]


def test_const_args(actors):
    def build(d, h):
        with d.InputNode() as inp:
            return h["c"].mul_add.bind(h["a"].add.bind(inp), 3, 7)

    got = both(actors, build, [10, 0])
    assert got["port"] == got["ref"] == [40, 10]


def test_error_propagates_and_dag_runs_on(actors):
    """An error in a stage reaches get() as the stage's own exception, skips
    the stages after it, and the pipeline serves the next execution."""
    def outcome(name, d, h):
        with d.InputNode() as inp:
            dag = d.MultiOutputNode([h["b"].add.bind(h["a"].boom.bind(inp)),
                                     h["c"].add.bind(inp)]).experimental_compile()
        try:
            out = []
            for x in (1, 2):
                with pytest.raises(ValueError) as e:
                    dag.execute(x).get(timeout=60)
                out.append(str(e.value))
            return out
        finally:
            dag.teardown()

    got = {name: outcome(name, d, actors[name]) for name, (_, d) in PACKAGES.items()}
    assert got["port"] == got["ref"] == ["boom on 1", "boom on 2"]


def test_teardown_frees_actor(actors):
    """After teardown the actor serves .remote() calls again and the DAG
    refuses to execute, in both packages."""
    got = {}
    for name, (rt, d) in PACKAGES.items():
        h = actors[name]
        before = rt.get(h["b"].call_count.remote(), timeout=60)
        with d.InputNode() as inp:
            dag = h["b"].add.bind(inp).experimental_compile()
        first = dag.execute(1).get(timeout=60)
        dag.teardown()
        with pytest.raises(d.DAGExecutionError, match="torn down"):
            dag.execute(2)
        got[name] = (first, rt.get(h["b"].call_count.remote(), timeout=60) - before,
                     rt.get(h["b"].add.remote(5), timeout=60))
    assert got["port"] == got["ref"] == (11, 1, 15)


def test_tensor_output_arrives_on_the_cpu(actors):
    """A torch tensor a stage returns reaches the driver as a CPU tensor,
    equal to the stage's (on the card, a CUDA output arrives so too)."""
    h = actors["port"]
    with port_dag.InputNode() as inp:
        dag = port_dag.MultiOutputNode([h["a"].scaled.bind(inp),
                                        h["c"].scaled.bind(h["a"].add.bind(inp))]).experimental_compile()
    try:
        first, second = dag.execute(2.0).get(timeout=60)
    finally:
        dag.teardown()
    want = torch.arange(6, dtype=torch.float32).reshape(2, 3)
    for got, scale in ((first, 2.0), (second, 3.0)):
        assert isinstance(got, torch.Tensor) and got.device.type == "cpu"
        assert got.dtype == torch.float32 and torch.equal(got, want * scale)


def test_over_capacity_names_the_writer_error(actors):
    """An output over ``buffer_size_bytes`` ends the writer's loop.  The
    port's get() raises that loop's ValueError; the JAX package's raises a
    bare ChannelClosedError, since its liveness check waits with timeout=0
    and so never sees the ended loop (ROADMAP C)."""
    errors = {}
    for name, (rt, d) in PACKAGES.items():
        with d.InputNode() as inp:
            dag = actors[name]["a"].big.bind(inp).experimental_compile(buffer_size_bytes=1 << 12)
        try:
            with pytest.raises(Exception) as e:
                dag.execute(0).get(timeout=60)
            errors[name] = e.value
        finally:
            dag.teardown()
    assert isinstance(errors["ref"], ref_channel.ChannelClosedError)
    assert isinstance(errors["port"], ray_tpu_torch.TaskError)
    assert "ValueError" in str(errors["port"]) and "exceeds channel capacity 4096" in str(errors["port"])


def test_no_channel_files_left(actors):
    """Teardown unlinks every channel the DAG made."""
    h = actors["port"]
    with port_dag.InputNode() as inp:
        dag = port_dag.MultiOutputNode([h["b"].add.bind(h["a"].add.bind(inp)),
                                        h["c"].add.bind(inp)]).experimental_compile()
    names = list(dag._all_channel_names)
    assert len(names) == 5 and all(os.path.exists(os.path.join("/dev/shm", n)) for n in names)
    assert dag.execute(0).get(timeout=60) == [11, 100]
    dag.teardown()
    assert not [n for n in names if os.path.exists(os.path.join("/dev/shm", n))]
