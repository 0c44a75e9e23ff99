"""The port's Data library (``ray_tpu_torch.data``) against the JAX
package's (``ray_tpu.data``), on the CPU.

Both runtimes run in this process, side by side (one module-scoped cluster
each, 4 CPUs): every case builds the same pipeline in both packages, from
the same seeded numpy arrays or the same files (written once per case),
runs it on its own runtime (the two at once, the reference's from a second
thread of the driver), and the results must be equal value for value,
in the same order where the reference fixes one (every case here: the
shuffles are seeded, the exchanges deterministic).  The cases cover the
operations of ``tests/test_data.py`` and ``tests/test_data_io.py``; the
streaming, shuffle-at-scale and Train-ingest tests are in
``tests/test_zz_torch_data.py``.

The ingest step: the tiny GPT-2 at D = 64 (flash attention, f32) scores the
batches of one seeded token Dataset, fed by the port's
``iter_device_batches(device="cpu")`` and by the reference's
``iter_jax_batches``: the batches must be equal and the losses agree within
``tests/test_torch_train.py``'s f32 tolerance (1e-5).
"""

import os
import sys

import cloudpickle
import jax
import numpy as np
import pyarrow as pa
import pytest
import torch

import ray_tpu
import ray_tpu.data as ref_data
import ray_tpu_torch
import ray_tpu_torch.data as port_data
from ray_tpu.models import gpt2 as jax_gpt2
from ray_tpu.parallel import mesh as jax_mesh
from ray_tpu_torch.models import gpt2
from ray_tpu_torch.models.convert import gpt2_params_from_jax
from test_torch_runtime import runtime_defaults

LOSS_TOL = 1e-5  # tests/test_torch_train.py TOL[torch.float32]["loss"]
PACKAGES = {"ref": ref_data, "port": port_data}


@pytest.fixture(scope="module")
def clusters():
    """Both runtimes up; this module's functions travel to the workers by
    value (a worker cannot import a test module)."""
    module = sys.modules[__name__]
    cloudpickle.register_pickle_by_value(module)
    with runtime_defaults():
        ray_tpu.init(num_cpus=4, num_tpus=0, log_to_driver=False)
        try:
            ray_tpu_torch.init(num_cpus=4, log_to_driver=False)
            try:
                yield
            finally:
                ray_tpu_torch.shutdown()
        finally:
            ray_tpu.shutdown()
            cloudpickle.unregister_pickle_by_value(module)


@pytest.fixture(scope="module", autouse=True)
def _no_jax_mesh():
    """Other files leave the JAX package's process-wide mesh set; its flash
    attention would shard over it (ROADMAP §C, R2)."""
    jax_mesh.set_current_mesh(None)


def plain(x):
    """A result as plain Python values: arrays and tensors as lists."""
    if isinstance(x, dict):
        return {k: plain(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return [plain(v) for v in x]
    if isinstance(x, torch.Tensor):
        return [str(x.dtype).replace("torch.", ""), x.tolist()]
    if isinstance(x, np.ndarray):
        return [str(x.dtype), x.tolist()]
    if isinstance(x, np.generic):
        return x.item()
    return x


def rows_of(ds):
    return plain(ds.take_all())


def seeded_rows(n, seed=0):
    rng = np.random.default_rng(seed)
    return [{"k": int(k), "g": f"g{int(g)}", "x": float(x), "n": int(m)}
            for k, g, x, m in zip(rng.permutation(n), rng.integers(0, 7, n), rng.normal(size=n),
                                  rng.integers(-50, 50, n))]


# -- the cases: each builds one pipeline from a data package ----------------


def case_range(d, tmp):
    ds = d.range(100)
    return {"count": ds.count(), "take": plain(ds.take(3)), "schema": ds.schema().names,
            "blocks": ds.num_blocks()}


def case_from_items(d, tmp):
    return {"dicts": rows_of(d.from_items(seeded_rows(30))),
            "scalars": rows_of(d.from_items([1, 2, 3]))}


def case_from_numpy(d, tmp):
    rng = np.random.default_rng(1)
    img = rng.normal(size=(10, 4, 4, 3)).astype(np.float32)
    ds = d.from_numpy({"img": img, "y": np.arange(10)})
    first = next(ds.iter_batches(batch_size=5))
    return {"first": plain(first), "through_map": plain(
        next(ds.map_batches(lambda b: {"z": b["img"] * 2}).iter_batches(batch_size=10)))}


def case_map_filter_fused(d, tmp):
    ds = d.range(50).map(lambda r: {"id": r["id"] * 2}).filter(lambda r: r["id"] % 4 == 0)
    return rows_of(ds)


def case_map_batches(d, tmp):
    numpy_fmt = d.range(20, override_num_blocks=3).map_batches(lambda b: {"sq": b["id"] ** 2})
    arrow_fmt = d.range(10).map_batches(
        lambda t: t.append_column("neg", pa.array([-x for x in t.column("id").to_pylist()])),
        batch_format="pyarrow")
    return {"numpy": rows_of(numpy_fmt), "sum": numpy_fmt.sum("sq"), "pyarrow": rows_of(arrow_fmt)}


def case_flat_map(d, tmp):
    return rows_of(d.from_items([1, 2, 3]).flat_map(lambda r: [{"v": r["item"]}, {"v": r["item"] * 10}]))


def case_column_ops(d, tmp):
    ds = (d.range(5).add_column("double", lambda t: [x * 2 for x in t.column("id").to_pylist()])
          .rename_columns({"id": "orig"}))
    return {"rows": rows_of(ds), "dropped": ds.drop_columns(["orig"]).columns()}


def case_repartition(d, tmp):
    ds = d.range(1000).repartition(7)
    return {"blocks": ds.num_blocks(), "rows": rows_of(ds)}


def case_random_shuffle(d, tmp):
    ds = d.range(500)
    return {"7": rows_of(ds.random_shuffle(seed=7)), "42": rows_of(ds.random_shuffle(seed=42))}


def case_sort(d, tmp):
    ds = d.from_items(seeded_rows(300), override_num_blocks=4)
    return {"asc": rows_of(ds.sort("k")), "desc": rows_of(ds.sort("k", descending=True))}


def case_groupby(d, tmp):
    ds = d.from_items(seeded_rows(200), override_num_blocks=3)
    g = ds.groupby("g")
    # The reference fixes no order of groups, and pyarrow's threaded hash
    # aggregation sums floats in no fixed order: integer columns are summed.

    def by_group(out):
        return sorted(rows_of(out), key=lambda r: r["g"])

    return {"sum": by_group(g.sum("n")), "count": by_group(g.count()), "mean": by_group(g.mean("n")),
            "min": by_group(g.min("k")), "max": by_group(g.max("k")),
            "whole": [ds.sum("k"), ds.min("x"), ds.max("x"), ds.mean("x")]}


def case_union_zip_join(d, tmp):
    a = d.from_items([{"x": i} for i in range(10)], override_num_blocks=3)
    b = d.from_items([{"y": i * 2} for i in range(10)], override_num_blocks=4)
    users = d.from_items([{"uid": i, "name": f"u{i}"} for i in range(8)], override_num_blocks=3)
    orders = d.from_items([{"uid": i % 4, "amount": 10 * i} for i in range(12)], override_num_blocks=2)
    return {"union": rows_of(d.range(10).union(d.range(5))), "zip": rows_of(a.zip(b)),
            "collide": rows_of(d.from_items([{"x": 1}]).zip(d.from_items([{"x": 9}]))),
            # the reference fixes no order of a join's rows
            "join": sorted(rows_of(users.join(orders, on="uid")), key=lambda r: (r["uid"], r["amount"]))}


def case_limit_split(d, tmp):
    ds = d.range(1000, override_num_blocks=7)
    equal = ds.streaming_split(3, equal=True)
    return {"limit": rows_of(d.range(100).limit(7)),
            "split": [p.count() for p in d.range(100).split(4)],
            "split_rows": [rows_of(p) for p in d.range(20).split(3)],
            "equal_counts": [it.count() for it in equal],
            "equal_rows": [[plain(b["id"]) for b in it.iter_batches(batch_size=64)] for it in equal]}


def case_iter_batches(d, tmp):
    ds = d.range(100, override_num_blocks=7)
    return {"sizes": [len(b["id"]) for b in ds.iter_batches(batch_size=32)],
            "dropped": [len(b["id"]) for b in ds.iter_batches(batch_size=32, drop_last=True)],
            "values": plain(list(ds.iter_batches(batch_size=30))),
            "rows": plain(list(ds.iter_rows())[:5])}


def case_iter_torch_batches(d, tmp):
    ds = d.range(100)
    return {"default": plain(list(ds.iter_torch_batches(batch_size=32))),
            "typed": plain(next(iter(ds.iter_torch_batches(batch_size=10, dtypes={"id": torch.float32}))))}


def write_source_files(tmp):
    """The same files for both packages, written once, with pyarrow and
    numpy, under ``tmp/src``."""
    import pyarrow.parquet as pq

    src = os.path.join(tmp, "src")
    os.makedirs(src)
    rng = np.random.default_rng(3)
    for i in range(3):
        t = pa.table({"a": np.arange(i * 5, i * 5 + 5), "b": [f"s{j}" for j in range(5)],
                      "c": rng.normal(size=5)})
        pq.write_table(t, os.path.join(src, f"p{i}.parquet"))
        np.save(os.path.join(src, f"n{i}.npy"), rng.normal(size=(4, 3)).astype(np.float32))
    with open(os.path.join(src, "f.txt"), "w") as f:
        f.write("hello\nworld\n")


def case_io_round_trip(d, tmp):
    src = os.path.join(tmp, "src")
    out = os.path.join(tmp, d.__name__)
    ds = d.read_parquet(src)
    got = {"parquet": rows_of(ds), "pushdown": rows_of(d.read_parquet(src).select_columns(["a"])),
           "columns": rows_of(d.read_parquet(src, columns=["b", "c"])),
           "npy": rows_of(d.read_numpy(os.path.join(src, "*.npy"))),
           "text": rows_of(d.read_text(os.path.join(src, "f.txt")))}
    for fmt, reader in (("parquet", d.read_parquet), ("csv", d.read_csv), ("json", d.read_json)):
        paths = getattr(ds, f"write_{fmt}")(os.path.join(out, fmt))
        got[f"{fmt}_files"] = [os.path.basename(p) for p in paths]
        got[f"{fmt}_back"] = rows_of(reader(os.path.join(out, fmt)))
    return got


def case_datasource(d, tmp):
    class Squares(d.Datasource):
        def get_read_tasks(self, parallelism):
            def load(i):
                return d.block.from_rows([{"v": (i * 10 + j) ** 2} for j in range(3)])

            return [d.dataset.ReadTask(load, i) for i in range(3)]

    return rows_of(d.read_datasource(Squares()))


def case_stats(d, tmp):
    def double(b):
        return {"id": b["id"] * 2}

    ds = d.range(100, override_num_blocks=4).map_batches(double).random_shuffle(seed=0)
    n = ds.count()
    s = ds.stats()
    lines = [ln.split(":")[0] for ln in s.splitlines() if ln.startswith("Stage")]
    rows = [ln for ln in s.splitlines() if ln.startswith("* Output rows")]
    return {"count": n, "stages": lines, "rows": rows, "store": "Cluster object store:" in s}


CASES = {name[5:]: fn for name, fn in globals().items() if name.startswith("case_")}


@pytest.mark.parametrize("case", sorted(CASES))
def test_pipeline_matches_reference(case, clusters, tmp_path):
    """The two packages run the case at once, the reference's from a
    second thread of this driver: each runtime is its own."""
    from concurrent.futures import ThreadPoolExecutor

    write_source_files(str(tmp_path))
    with ThreadPoolExecutor(1) as pool:
        ref = pool.submit(CASES[case], ref_data, str(tmp_path))
        port = CASES[case](port_data, str(tmp_path))
        assert port == ref.result()


def test_with_resources_budget(clusters):
    for d in PACKAGES.values():
        ds = d.range(4).with_resources(window=3).map(lambda r: {"id": r["id"] + 1})
        assert ds._exec_opts["window"] == 3
        assert ds.repartition(2)._exec_opts == {}
        blocks = d.range(20, override_num_blocks=10).with_resources(window=2).iter_block_refs()
        assert sum(b.num_rows for b in map(_getter(d), blocks)) == 20


def _getter(d):
    rt = ray_tpu_torch if d is port_data else ray_tpu
    return lambda ref: rt.get(ref, timeout=120)


def test_device_batches_refuse_without_card(clusters):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    ds = port_data.range(8)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ds.iter_device_batches(batch_size=4)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ds.streaming_split(1)[0].iter_device_batches(batch_size=4)


def test_ingest_step_matches_reference(clusters):
    """The tiny GPT-2 at D = 64, flash, f32, scores each batch of one seeded
    token Dataset: the port's batches come from iter_device_batches(device=
    "cpu"), the reference's from iter_jax_batches."""
    widths = dict(embed_dim=256, num_heads=4, num_layers=1)
    jcfg = jax_gpt2.GPTConfig.tiny(attention_impl="flash", dtype=jax.numpy.float32, **widths)
    cfg = gpt2.GPTConfig.tiny(attention_impl="flash", dtype=torch.float32, **widths)
    shapes = jax.eval_shape(lambda: jax_gpt2.init(jax.random.key(0), jcfg))
    rng = np.random.default_rng(0)

    def draw(path, s):
        base = 1.0 if "scale" in jax.tree_util.keystr(path) else 0.0
        return (base + rng.standard_normal(s.shape) * 0.02).astype(np.float32)

    params = jax.tree_util.tree_map_with_path(draw, shapes)
    tokens = rng.integers(0, cfg.vocab_size, (6, 129), dtype=np.int32)

    def split(b):
        return {"inputs": b["tokens"][:, :-1].astype(np.int64), "targets": b["tokens"][:, 1:].astype(np.int64)}

    def dataset(d):
        return d.from_numpy({"tokens": tokens}).repartition(3).map_batches(split)

    port = list(dataset(port_data).iter_device_batches(batch_size=2, device="cpu"))
    ref = list(dataset(ref_data).iter_jax_batches(batch_size=2))
    assert len(port) == len(ref) == 3
    for p, r in zip(port, ref):
        assert set(p) == set(r) == {"inputs", "targets"}
        for k in p:
            assert p[k].device.type == "cpu" and p[k].dtype == torch.int64
            np.testing.assert_array_equal(p[k].numpy(), np.asarray(r[k]), err_msg=k)

    ref_loss = jax.jit(lambda p, b: jax_gpt2.loss_fn(p, b, jcfg))
    model = gpt2_params_from_jax(params, cfg, device="cpu")
    with torch.no_grad():
        got = [float(gpt2.loss_fn(model, b)) for b in port]
    want = [float(ref_loss(params, b)) for b in ref]
    np.testing.assert_allclose(got, want, atol=LOSS_TOL, rtol=LOSS_TOL)


def test_device_batches_shard_over_a_mesh(clusters, tmp_path):
    """``sharding=`` hands each batch to ``spmd.shard_batch``: on a gloo
    mesh of one rank every tensor is a DTensor over the mesh holding the
    batch."""
    import torch.distributed as dist
    from torch.distributed.tensor import DTensor

    from ray_tpu_torch.parallel import mesh as port_mesh

    dist.init_process_group("gloo", init_method=f"file://{tmp_path}/store", rank=0, world_size=1)
    try:
        mesh = port_mesh.make_mesh(port_mesh.MeshConfig(dp=1), device_type="cpu")
        ds = port_data.range(12, override_num_blocks=3).map_batches(lambda b: {"x": b["id"] * 2})
        batches = list(ds.iter_device_batches(batch_size=4, device="cpu", sharding=mesh))
        assert len(batches) == 3
        for i, b in enumerate(batches):
            assert isinstance(b["x"], DTensor)
            assert b["x"].to_local().tolist() == [2 * v for v in range(4 * i, 4 * i + 4)]
    finally:
        port_mesh.set_current_mesh(None)
        dist.destroy_process_group()
