"""The port's Data library on its runtime, on the CPU: the tests of
``tests/test_data_streaming.py``, ``tests/test_data_shuffle_scale.py`` and
``tests/test_train_data_ingest.py``, and the cases of ``tests/test_data.py``
and ``tests/test_data_io.py`` that ``tests/test_torch_data.py`` does not
hold against the reference (actor pools, the concurrency budget, pandas,
images, SQL, the error paths).

Marked ``slow`` (past the tier-1 window, ``test_zz_*``): the streaming and
shuffle cases push four times a 96 MB object store through it, and the
Train ingest trains the tiny GPT-2 from a Dataset larger than the store,
its blocks streaming and spilling.  One cluster for the module,
``init(num_cpus=4, num_gpus=2, object_store_bytes=96 MB)``: two GPUs are
declared and none exists, so a ``use_gpu`` worker is leased a card index
that it cannot use (``iter_device_batches()`` refuses there, and its
``device="cpu"`` reads the shard).
"""

import functools
import os
import sqlite3
import sys

import cloudpickle
import numpy as np
import pytest

import ray_tpu_torch as rt
import ray_tpu_torch.data as rd
from ray_tpu_torch import train
from ray_tpu_torch.core.runtime import get_runtime
from ray_tpu_torch.data.dataset import Dataset, ReadTask
from test_torch_runtime import runtime_defaults

STORE_BYTES = 96 * 1024 * 1024  # 96 MB store
BLOCK_MB = 8
NUM_BLOCKS = 48  # 384 MB total through a 96 MB store
_GPU_ENV = ("CUDA_VISIBLE_DEVICES", "RT_GPU_VISIBLE_DEVICES", "RT_GPU_COUNT_OVERRIDE")

pytestmark = pytest.mark.slow


@pytest.fixture(scope="module")
def cluster():
    module = sys.modules[__name__]
    cloudpickle.register_pickle_by_value(module)
    with runtime_defaults():
        rt.init(num_cpus=4, num_gpus=2, object_store_bytes=STORE_BYTES, log_to_driver=False)
        try:
            yield
        finally:
            rt.shutdown()
            cloudpickle.unregister_pickle_by_value(module)


def _make_block(i: int):
    from ray_tpu_torch.data import block as block_mod

    rows = BLOCK_MB * 1024 * 1024 // 8
    return block_mod.from_numpy({"x": np.full(rows, i, np.int64)})


# -- tests/test_data_streaming.py -------------------------------------------


class TestStreamingBackpressure:
    def test_4x_store_dataset_streams_bounded(self, cluster):
        ds = Dataset([ReadTask(_make_block, i) for i in range(NUM_BLOCKS)])
        ds = ds.map_batches(lambda b: {"x": b["x"] * 2})
        runtime = get_runtime()
        peak = seen = total = 0
        for batch in ds.iter_batches(batch_size=None):
            seen += 1
            total += int(batch["x"][0])
            peak = max(peak, runtime.store.stats()["used"])
        assert seen == NUM_BLOCKS
        assert total == sum(2 * i for i in range(NUM_BLOCKS))
        # bounded: the window (8 blocks) + the consumer's copy is the
        # expected high-water mark, never the dataset's size
        assert peak < STORE_BYTES, f"peak {peak} filled the store"
        assert peak < 3 * NUM_BLOCKS * BLOCK_MB * 1024 * 1024 // 4

    def test_lazy_sources_not_read_up_front(self, cluster):
        ds = Dataset([ReadTask(_make_block, i) for i in range(12)])
        it = ds.iter_block_refs()
        first = next(it)
        assert rt.get(first, timeout=60).num_rows == BLOCK_MB * 1024 * 1024 // 8
        del it, first

    def test_split_stays_lazy_and_streams(self, cluster):
        ds = Dataset([ReadTask(_make_block, i) for i in range(8)])
        ds = ds.map_batches(lambda b: {"x": b["x"] + 1})
        shards = ds.split(2)
        assert len(shards) == 2
        counts = [sum(1 for _ in s.iter_batches(batch_size=None)) for s in shards]
        assert counts == [4, 4]

    def test_device_prefetch_double_buffer(self, cluster):
        """iter_device_batches must yield every batch exactly once in
        order with the double-buffered transfer."""
        ds = rd.range(1000, override_num_blocks=4)
        vals = [int(b["id"][0]) for b in ds.iter_device_batches(batch_size=100, device="cpu")]
        assert vals == list(range(0, 1000, 100))


# -- tests/test_data_shuffle_scale.py ---------------------------------------


class TestDistributedShuffleCorrectness:
    def test_repartition_preserves_order_and_balances(self, cluster):
        ds = rd.range(1000).repartition(7)
        assert ds.num_blocks() == 7
        assert [r["id"] for r in ds.take_all()] == list(range(1000))

    def test_random_shuffle_is_seeded_permutation(self, cluster):
        ds = rd.range(500)
        a = [r["id"] for r in ds.random_shuffle(seed=7).take_all()]
        b = [r["id"] for r in ds.random_shuffle(seed=7).take_all()]
        c = [r["id"] for r in ds.random_shuffle(seed=8).take_all()]
        assert sorted(a) == list(range(500))
        assert a != list(range(500))
        assert a == b
        assert a != c

    def test_sort_globally_ordered_across_blocks(self, cluster):
        vals = np.random.default_rng(0).permutation(2000)
        ds = rd.from_items([{"k": int(v)} for v in vals]).repartition(6)
        assert [r["k"] for r in ds.sort("k").take_all()] == sorted(vals.tolist())
        out_d = [r["k"] for r in ds.sort("k", descending=True).take_all()]
        assert out_d == sorted(vals.tolist(), reverse=True)

    def test_groupby_hash_exchange_is_exact(self, cluster):
        rows = [{"g": f"key{i % 13}", "x": float(i)} for i in range(1300)]
        ds = rd.from_items(rows).repartition(5)
        got = {r["g"]: r["x_sum"] for r in ds.groupby("g").sum("x").take_all()}
        expect = {}
        for r in rows:
            expect[r["g"]] = expect.get(r["g"], 0.0) + r["x"]
        assert got == expect
        counts = {r["g"]: r["g_count"] for r in ds.groupby("g").count().take_all()}
        assert all(v == 100 for v in counts.values()), counts


class TestShuffleThroughSmallStore:
    def test_shuffle_4x_store(self, cluster):
        # ~200 MB through a 96 MB arena: the exchange's map outputs and
        # reduce inputs must spill rather than co-reside
        n_blocks, rows_per = 25, 1_000_000  # 8 MB per block of int64
        shuffled = rd.range(n_blocks * rows_per).repartition(n_blocks).random_shuffle(seed=1)
        assert shuffled.count() == n_blocks * rows_per
        s = sum(int(b["id"].sum()) for b in shuffled.iter_batches(batch_size=500_000))
        total = n_blocks * rows_per
        assert s == total * (total - 1) // 2


# -- tests/test_train_data_ingest.py ----------------------------------------


class TestStreamingSplit:
    def test_streaming_split_covers_all_rows(self, cluster):
        shards = rd.from_numpy({"x": np.arange(1000)}).repartition(8).streaming_split(3)
        seen = [v for it in shards for b in it.iter_batches(batch_size=64, drop_last=False)
                for v in b["x"].tolist()]
        assert sorted(seen) == list(range(1000))

    def test_equal_split_gives_exactly_equal_rows(self, cluster):
        shards = rd.from_numpy({"x": np.arange(1000)}).repartition(7).streaming_split(3, equal=True)
        assert [it.count() for it in shards] == [333, 333, 333]

    def test_equal_split_applies_pending_ops_once(self, cluster):
        ds = rd.from_numpy({"x": np.arange(100)}).map_batches(lambda b: {"x": b["x"] * 3})
        a, b = ds.streaming_split(2, equal=True)
        va = [r for batch in a.iter_batches(batch_size=64, drop_last=False) for r in batch["x"].tolist()]
        vb = [r for batch in b.iter_batches(batch_size=64, drop_last=False) for r in batch["x"].tolist()]
        assert sorted(va + vb) == [i * 3 for i in range(100)]

    def test_iterator_is_serializable_to_workers(self, cluster):
        ds = rd.from_numpy({"x": np.arange(100)}).map_batches(lambda b: {"x": b["x"] * 2})
        (it,) = ds.streaming_split(1)

        @rt.remote
        def consume(shard):
            return sum(int(b["x"].sum()) for b in shard.iter_device_batches(
                batch_size=32, drop_last=False, device="cpu"))

        assert rt.get(consume.remote(it), timeout=120) == int(np.arange(100).sum() * 2)


def _shard_loop(config):
    """Reads ``train``'s shard in a GPU-leased worker: the default device
    must refuse (the lease's card index names no device here), the CPU
    read must see every row of the shard once."""
    import os as _os

    from ray_tpu_torch import train as tr

    shard = tr.get_dataset_shard("train")
    try:
        shard.iter_device_batches(batch_size=8)
        refused = None
    except RuntimeError as e:
        refused = str(e)
    ids = [int(v) for b in shard.iter_device_batches(batch_size=8, device="cpu") for v in b["id"]]
    tr.report({"ids": ids, "refused": refused, "visible": _os.environ.get("CUDA_VISIBLE_DEVICES")})


def _gpt2_loop(config):
    """The tiny GPT-2 (dense attention, f32) trained with Adam(1e-2) from
    the ``train`` shard, one report a step."""
    import dataclasses

    import torch

    from ray_tpu_torch import train as tr
    from ray_tpu_torch.models import gpt2
    from ray_tpu_torch.parallel import spmd

    cfg = dataclasses.replace(gpt2.GPTConfig.tiny(dtype=torch.float32), vocab_size=256, max_seq_len=64)
    model = gpt2.init(cfg, torch.Generator().manual_seed(0), "cpu")
    step = spmd.compile_train_step(gpt2.loss_fn, spmd.adam(model.parameters(), 1e-2))
    state = spmd.TrainState(0, model)
    shard = tr.get_dataset_shard("train")
    for i, batch in enumerate(shard.iter_device_batches(batch_size=8, device="cpu")):
        state, metrics = step(state, {"tokens": batch["tokens"].long()})
        tr.report({"step": i, "loss": float(metrics["loss"])})
        if i + 1 >= config["max_steps"]:
            break


class TestTrainerIngest:
    def test_shard_reaches_gpu_leased_worker(self, cluster, tmp_path):
        """``datasets=`` iterators pickle into a GPU-leased worker, and
        ``get_dataset_shard`` serves them there."""
        saved = {k: os.environ.pop(k) for k in _GPU_ENV if k in os.environ}
        try:
            r = train.TorchTrainer(
                _shard_loop,
                scaling_config=train.ScalingConfig(num_workers=1, use_gpu=True),
                run_config=train.RunConfig(name="shard_gpu", storage_path=str(tmp_path)),
                datasets={"train": rd.range(40, override_num_blocks=3)},
            ).fit()
        finally:
            os.environ.update(saved)
        assert r.error is None, r.error
        m = r.metrics
        assert m["visible"] in ("0", "1")
        assert m["refused"] is not None and "no CUDA device" in m["refused"]
        assert m["ids"] == list(range(40))

    def test_gpt2_trains_from_dataset_through_small_store(self, cluster, tmp_path):
        # ~150 MB of tokens through a 96 MB store: the earliest blocks
        # must spill rather than co-reside with the rest
        refs = []
        for s in range(72):
            rng = np.random.default_rng(s)
            # tokens drawn from 16 of 256 vocab entries: unigram entropy
            # ln(16) << ln(256), so a few steps visibly drop the loss
            blk = rd.from_numpy({"tokens": rng.integers(0, 16, (8192, 65), dtype=np.int32)})
            refs.extend(blk._input_refs)
        r = train.TorchTrainer(
            _gpt2_loop,
            train_loop_config={"max_steps": 8},
            scaling_config=train.ScalingConfig(num_workers=1),
            run_config=train.RunConfig(name="gpt2_ingest", storage_path=str(tmp_path)),
            datasets={"train": Dataset(refs)},
        ).fit()
        assert r.error is None, r.error
        losses = [m["loss"] for m in r.metrics_dataframe]
        assert len(losses) == 8
        assert losses[-1] < losses[0], losses

    def test_dataset_to_trainer(self, cluster, tmp_path):
        """A Dataset made inside the loop, read by iter_device_batches."""

        def loop(config):
            from ray_tpu_torch import data as port_data
            from ray_tpu_torch import train as tr

            ds = port_data.range(64).map_batches(lambda b: {"x": b["id"].astype(np.float32)})
            total = sum(float(b["x"].sum()) for b in ds.iter_device_batches(batch_size=16, device="cpu"))
            tr.report({"total": total})

        r = train.TorchTrainer(
            loop, scaling_config=train.ScalingConfig(num_workers=1),
            run_config=train.RunConfig(name="ingest", storage_path=str(tmp_path)),
        ).fit()
        assert r.error is None
        assert r.metrics["total"] == float(sum(range(64)))


# -- tests/test_data.py: the cases the fast file does not hold --------------


class TestDataCases:
    def test_stateful_class_runs_on_pool(self, cluster):
        class AddBias:
            def __init__(self, bias):
                self.bias = bias
                self.pid = os.getpid()

            def __call__(self, batch):
                return {"x": batch["x"] + self.bias, "pid": [self.pid] * len(batch["x"])}

        ds = rd.range(200).repartition(8).map_batches(lambda b: {"x": b["id"]}).map_batches(
            AddBias, compute=rd.ActorPoolStrategy(size=2), fn_constructor_args=(100,))
        rows = ds.take_all()
        assert [r["x"] for r in rows] == [i + 100 for i in range(200)]
        assert len({r["pid"] for r in rows}) <= 2

    def test_concurrency_kwarg_with_class(self, cluster):
        class Echo:
            def __call__(self, batch):
                return {"id": batch["id"]}

        ds = rd.range(64).repartition(4).map_batches(Echo, concurrency=2)
        assert sorted(r["id"] for r in ds.take_all()) == list(range(64))

    def test_stats_actor_pool_stage(self, cluster):
        class AddOne:
            def __call__(self, b):
                return {"id": b["id"] + 1}

        ds = rd.range(40, override_num_blocks=4).map_batches(AddOne, concurrency=2)
        assert ds.count() == 40
        s = ds.stats()
        assert "MapBatches(actors:AddOne)" in s, s
        assert "Output rows: 40 total" in s, s

    def test_stats_before_execution_is_explicit(self, cluster):
        assert "No execution stats recorded yet" in rd.range(10).map(lambda r: r).stats()

    def test_with_resources_budget_applies(self, cluster):
        @rt.remote
        class Gauge:
            def __init__(self):
                self.cur = self.peak = 0

            def enter(self):
                self.cur += 1
                self.peak = max(self.peak, self.cur)

            def exit(self):
                self.cur -= 1

            def peak_seen(self):
                return self.peak

        g = Gauge.remote()

        def probe(batch):
            import time as _t

            rt.get(g.enter.remote(), timeout=60)
            _t.sleep(0.3)
            rt.get(g.exit.remote(), timeout=60)
            return batch

        rd.range(8).repartition(8).map_batches(probe).with_resources(num_cpus=2.0).materialize()
        assert rt.get(g.peak_seen.remote(), timeout=60) <= 2

    def test_from_pandas(self, cluster):
        import pandas as pd

        ds = rd.from_pandas(pd.DataFrame({"a": [1, 2], "b": ["x", "y"]}))
        assert ds.take_all() == [{"a": 1, "b": "x"}, {"a": 2, "b": "y"}]
        assert ds.to_pandas().equals(pd.DataFrame({"a": [1, 2], "b": ["x", "y"]}))

    def test_zip_and_join_errors(self, cluster):
        with pytest.raises(ValueError, match="equal row counts"):
            rd.range(5).zip(rd.range(6))
        with pytest.raises(ValueError, match="unknown join"):
            rd.range(3).join(rd.range(3), on="id", how="cross")
        left = rd.from_items([{"k": i, "a": i} for i in range(4)])
        right = rd.from_items([{"k": 0, "b": 7}, {"k": 2, "b": 9}])
        rows = sorted(left.join(right, on="k", how="left").take_all(), key=lambda r: r["k"])
        assert [r.get("b") for r in rows] == [7, None, 9, None]

    def test_file_based_datasource_custom_reader(self, cluster, tmp_path):
        for i in range(3):
            (tmp_path / f"f{i}.vals").write_text("\n".join(str(i * 100 + j) for j in range(4)))

        def read_vals(path):
            from ray_tpu_torch.data import block as block_mod

            with open(path) as f:
                return block_mod.from_rows([{"n": int(line)} for line in f if line.strip()])

        ds = rd.read_datasource(rd.FileBasedDatasource(str(tmp_path), suffix=".vals", reader=read_vals))
        assert sorted(r["n"] for r in ds.take_all()) == sorted(i * 100 + j for i in range(3) for j in range(4))


# -- tests/test_data_io.py --------------------------------------------------


@pytest.fixture(scope="module")
def image_dir(tmp_path_factory):
    from PIL import Image

    d = tmp_path_factory.mktemp("imgs")
    for i in range(4):
        Image.fromarray(np.full((10 + i, 12, 3), i * 10, np.uint8)).save(d / f"img_{i}.png")
    (d / "notes.txt").write_text("not an image")
    return str(d)


class TestReadImagesAndSql:
    def test_images_resized_and_grayscale(self, cluster, image_dir):
        rows = rd.read_images(image_dir, size=(8, 8), mode="RGB").take_all()
        assert len(rows) == 4 and all(r["image"].shape == (8, 8, 3) for r in rows)
        assert rd.read_images(image_dir, size=(6, 6), mode="L").take(1)[0]["image"].shape == (6, 6, 1)
        means = rd.read_images(image_dir, size=(8, 8), mode="RGB").map_batches(
            lambda b: {"mean": b["image"].reshape(len(b["image"]), -1).mean(axis=1)}).take_all()
        assert sorted(r["mean"] for r in means) == [0.0, 10.0, 20.0, 30.0]

    def test_no_images_raises(self, cluster, tmp_path):
        (tmp_path / "only.txt").write_text("x")
        with pytest.raises(FileNotFoundError):
            rd.read_images(str(tmp_path))

    def test_sql_query_and_ops(self, cluster, tmp_path):
        p = str(tmp_path / "t.sqlite")
        conn = sqlite3.connect(p)
        conn.execute("CREATE TABLE pts (x REAL, label TEXT)")
        conn.executemany("INSERT INTO pts VALUES (?, ?)", [(float(i), f"l{i % 3}") for i in range(30)])
        conn.commit()
        conn.close()
        rows = rd.read_sql("SELECT x, label FROM pts WHERE x < 10 ORDER BY x",
                           functools.partial(sqlite3.connect, p)).take_all()
        assert len(rows) == 10 and rows[0] == {"x": 0.0, "label": "l0"}
        agg = rd.read_sql("SELECT label, COUNT(*) AS n FROM pts GROUP BY label", functools.partial(sqlite3.connect, p))
        assert agg.count() == 3 and sum(r["n"] for r in agg.take_all()) == 30
