"""Dataset: lazy transformation plan over distributed Arrow blocks (port
of ``ray_tpu/data/dataset.py``).

Role-equivalent of ray: python/ray/data/dataset.py:137 (Dataset) with the
plan layer (data/_internal/logical/) collapsed to a fused-stage executor:
consecutive row/batch transforms fuse into ONE task per block (the
optimization the reference's rule optimizer does for map chains), with
shuffle ops (repartition / random_shuffle / sort / groupby) as stage
boundaries.  Blocks are ObjectRefs to pyarrow Tables, processed by
@remote tasks, so transform parallelism and locality come from the core
scheduler.

Execution is STREAMING by default (ray: data/_internal/execution/
streaming_executor.py:51 analogue): consumption iterates block-by-block
with a bounded in-flight window — sources are lazy ReadTasks executed
inside the fused stage task, at most `cfg.data_streaming_window` blocks
are being produced at once, and consumed blocks are freed by the core's
distributed refcounting as their refs drop — so a dataset much larger
than the object store flows through map→ingest at bounded memory
(backpressure = the consumer's pull rate).

The card-facing consumption path is iter_device_batches() (the
counterpart of the reference's iter_jax_batches): dicts of tensors on
the card, optionally handed to ``parallel.spmd.shard_batch`` for a mesh,
with double-buffered copies from pinned host memory on a side stream so
the host→device transfer of batch N+1 overlaps the caller's step N.
"""

from __future__ import annotations

import builtins
import os
from typing import Any, Callable, Dict, Iterator, List, Optional, Union

import numpy as np
import pyarrow as pa

import ray_tpu_torch
from ray_tpu_torch.data import block as block_mod
from ray_tpu_torch.data.block import Block, BlockAccessor, concat_blocks

BatchFormat = Union[str]  # "pyarrow" | "numpy" | "pandas"


# -- transform ops ---------------------------------------------------------


class ReadTask:
    """Lazy block source: fn(*args) → Block, run on a worker inside the
    fused stage task (ray: data ReadTask analogue).  Keeping sources lazy
    means a read is only issued when the streaming window pulls it."""

    def __init__(self, fn: Callable[..., "Block"], *args):
        self.fn = fn
        self.args = args

    def __call__(self) -> "Block":
        return self.fn(*self.args)


class _Op:
    def label(self) -> str:
        """Stage-name fragment for Dataset.stats()."""
        name = type(self).__name__.lstrip("_")
        fn = getattr(self, "fn", None)
        fn_name = getattr(fn, "__name__", None)
        return f"{name}({fn_name})" if fn_name else name


class ActorPoolStrategy:
    """Run a map_batches stage on a pool of stateful actors (ray:
    ray.data.ActorPoolStrategy; the actor_pool_map_operator role).
    The pool provisions between min_size and max_size actors, scaled to
    the stage's block count (no dynamic autoscaling mid-stage)."""

    def __init__(self, size: int = 2, min_size: Optional[int] = None,
                 max_size: Optional[int] = None):
        self.min_size = min_size if min_size is not None else (
            size if max_size is None else 1
        )
        self.max_size = max_size if max_size is not None else size


class _MapBatches(_Op):
    def __init__(self, fn, batch_format="numpy", fn_kwargs=None):
        self.fn = fn
        self.batch_format = batch_format
        self.fn_kwargs = fn_kwargs or {}

    def apply(self, block: Block) -> Block:
        batch = _from_block(block, self.batch_format)
        out = self.fn(batch, **self.fn_kwargs)
        return _to_block(out)


class _MapRows(_Op):
    def __init__(self, fn):
        self.fn = fn

    def apply(self, block: Block) -> Block:
        rows = [self.fn(r) for r in BlockAccessor(block).iter_rows()]
        return block_mod.from_rows(rows)


class _FlatMap(_Op):
    def __init__(self, fn):
        self.fn = fn

    def apply(self, block: Block) -> Block:
        rows = []
        for r in BlockAccessor(block).iter_rows():
            rows.extend(self.fn(r))
        return block_mod.from_rows(rows)


class _Filter(_Op):
    def __init__(self, fn):
        self.fn = fn

    def apply(self, block: Block) -> Block:
        mask = [bool(self.fn(r)) for r in BlockAccessor(block).iter_rows()]
        return block.filter(pa.array(mask)) if len(mask) else block


def _from_block(block: Block, fmt: str):
    if fmt == "pyarrow":
        return block
    if fmt == "pandas":
        return BlockAccessor(block).to_pandas()
    return BlockAccessor(block).to_numpy()


def _to_block(batch) -> Block:
    if isinstance(batch, pa.Table):
        return batch
    if isinstance(batch, dict):
        return block_mod.from_numpy(batch)
    try:
        import pandas as pd

        if isinstance(batch, pd.DataFrame):
            return block_mod.from_pandas(batch)
    except ImportError:
        pass
    raise TypeError(
        f"map_batches fn must return dict/pyarrow.Table/DataFrame, got "
        f"{type(batch)}"
    )


def _kill_actor_pool(pool):
    import ray_tpu_torch as _rt

    for a in pool:
        try:
            _rt.kill(a)
        except Exception:
            pass


def _apply_ops(block: Block, ops: List[_Op]) -> Block:
    for op in ops:
        block = op.apply(block)
    return block


# -- device ingest ---------------------------------------------------------


def _shard(batch, sharding):
    if sharding is None:
        return batch
    from ray_tpu_torch.parallel.spmd import shard_batch

    return shard_batch(sharding, batch)


def _host_batches(batches, dev, sharding, dtypes):
    """iter_device_batches off the card: tensors made on the host."""
    import torch

    for batch in batches:
        out = {}
        for k, v in batch.items():
            t = torch.from_numpy(np.array(v, copy=True))
            if dtypes and k in dtypes:
                t = t.to(dtypes[k])
            out[k] = t.to(dev)
        yield _shard(out, sharding)


def _cuda_batches(batches, dev, sharding, dtypes):
    """iter_device_batches on the card: each batch is staged in pinned
    host memory and copied on a side stream while the caller runs the
    step on the batch before it."""
    import collections

    import torch

    copy_stream = torch.cuda.Stream(device=dev)
    # (event, pinned buffers) of copies that may still be reading them
    staged: Any = collections.deque()

    def issue(batch):
        pinned = {}
        for k, v in batch.items():
            dtype = torch.from_numpy(np.empty(0, v.dtype)).dtype
            h = torch.empty(v.shape, dtype=dtype, pin_memory=True)
            h.numpy()[...] = v
            pinned[k] = h
        with torch.cuda.stream(copy_stream):
            out = {k: h.to(dev, non_blocking=True) for k, h in pinned.items()}
            if dtypes:
                out = {k: t.to(dtypes[k]) if k in dtypes else t
                       for k, t in out.items()}
            done = torch.cuda.Event()
            done.record(copy_stream)
        staged.append((done, pinned))
        return out, done

    def consume(entry):
        out, done = entry
        stream = torch.cuda.current_stream(dev)
        stream.wait_event(done)
        for t in out.values():
            # made on the side stream, used on the caller's: the caching
            # allocator must not hand the memory out again before the
            # caller's stream is past its last use
            t.record_stream(stream)
        while staged and staged[0][0].query():
            staged.popleft()
        return _shard(out, sharding)

    prev = None
    try:
        for batch in batches:
            cur = issue(batch)  # the copy starts now
            if prev is not None:
                yield consume(prev)
            prev = cur
        if prev is not None:
            yield consume(prev)
    finally:
        for done, _ in staged:
            done.synchronize()
        staged.clear()


# -- the dataset -----------------------------------------------------------


class Dataset:
    def __init__(self, block_refs: List[Any], ops: Optional[List[_Op]] = None,
                 exec_opts: Optional[dict] = None,
                 stats_lineage: Optional[tuple] = None):
        import uuid

        self._input_refs = block_refs
        self._ops: List[_Op] = ops or []
        self._materialized: Optional[List[Any]] = None  # refs post-ops
        # per-operator execution budget (ray: backpressure_policy/ +
        # per-op resource requests): {"num_cpus", "memory", "window"};
        # carried through map chains, reset at shuffle boundaries (each
        # operator configures its own stage)
        self._exec_opts: dict = dict(exec_opts or {})
        # execution-stats identity: this plan's stage tasks report under
        # _stats_run_id; _stats_lineage carries ancestor run ids across
        # shuffle/actor-pool boundaries so stats() shows the whole plan
        # (ray: Dataset.stats(), python/ray/data/dataset.py:4573)
        self._stats_run_id = uuid.uuid4().hex[:16]
        self._stats_lineage: tuple = stats_lineage or ()

    # -- plan building ---------------------------------------------------
    def _chain(self, op: _Op) -> "Dataset":
        return Dataset(self._input_refs, self._ops + [op], self._exec_opts,
                       self._stats_lineage)

    def with_resources(
        self,
        *,
        num_cpus: Optional[float] = None,
        memory: Optional[float] = None,
        window: Optional[int] = None,
    ) -> "Dataset":
        """Per-operator resource budget for this dataset's fused stage
        (reference role: per-op resource requests + the pluggable
        backpressure policies of data/_internal/execution/
        backpressure_policy/).  ``num_cpus``/``memory`` shape each stage
        task's scheduling demand; ``window`` caps this operator's
        in-flight block production independently of the global
        RT_DATA_STREAMING_WINDOW — a heavy stage (model inference) can
        be throttled to 2 blocks while light stages stream wide.
        Budgets carry through chained maps and reset at shuffle
        boundaries."""
        opts = dict(self._exec_opts)
        if num_cpus is not None:
            opts["num_cpus"] = num_cpus
        if memory is not None:
            opts["memory"] = memory
        if window is not None:
            if window < 1:
                raise ValueError("window must be >= 1")
            opts["window"] = window
        return Dataset(self._input_refs, list(self._ops), opts,
                       self._stats_lineage)

    def map_batches(
        self,
        fn: Callable,
        *,
        batch_format: str = "numpy",
        fn_kwargs: Optional[dict] = None,
        compute: Any = None,
        concurrency: Optional[int] = None,
        fn_constructor_args: tuple = (),
        **_ignored,
    ) -> "Dataset":
        """Batch transform.  Plain functions fuse into per-block tasks
        (lazy).  A CLASS — or compute=ActorPoolStrategy(...) — runs on a
        pool of stateful actors instead (ray: actor_pool_map_operator
        role): the callable is constructed ONCE per actor (load a model
        there), blocks round-robin across the pool (each serial actor
        executes one block at a time), and the stage is an async plan
        boundary like the shuffles — the pool lives until the resulting
        Dataset is garbage-collected."""
        wants_actors = (
            isinstance(compute, ActorPoolStrategy)
            or compute == "actors"
            or isinstance(fn, type)
        )
        if wants_actors:
            if concurrency:
                lo = hi = concurrency
            elif isinstance(compute, ActorPoolStrategy):
                lo, hi = compute.min_size, compute.max_size
            else:
                lo = hi = 2
            return self._map_batches_actors(
                fn, lo, hi, batch_format, fn_kwargs or {},
                fn_constructor_args,
            )
        return self._chain(_MapBatches(fn, batch_format, fn_kwargs))

    def _map_batches_actors(
        self, fn, min_size: int, max_size: int, batch_format: str,
        fn_kwargs: dict, ctor_args: tuple,
    ) -> "Dataset":
        refs = self._execute()
        if not refs:
            return Dataset([])
        size = max(1, max(min_size, min(max_size, len(refs))))
        import uuid

        out_run_id = uuid.uuid4().hex[:16]
        stage_name = (
            f"MapBatches(actors:{getattr(fn, '__name__', type(fn).__name__)})"
        )

        @ray_tpu_torch.remote
        class _MapWorker:
            def __init__(self, fn, ctor_args):
                self._callable = (
                    fn(*ctor_args) if isinstance(fn, type) else fn
                )

            def apply(self, block):
                import time as _time

                from ray_tpu_torch.data import stats as stats_mod

                t0 = _time.perf_counter()
                batch = _from_block(block, batch_format)
                out = _to_block(self._callable(batch, **fn_kwargs))
                stats_mod.record_stage(out_run_id, stage_name, t0, out)
                return out

        pool = [
            _MapWorker.options(num_cpus=0.5).remote(fn, ctor_args)
            for _ in range(size)
        ]
        out = [pool[i % size].apply.remote(r) for i, r in enumerate(refs)]
        out_lineage = self._stats_lineage + ((self._stats_run_id, "Input"),)
        # The pool dies when the LAST output ref does — not with the
        # Dataset object, which a chained stage may drop while its refs
        # live on.  Finalizers hold the handles; consumption proceeds
        # asynchronously.  (Inline results ride replies; stored results
        # live in node shm independent of the producing actor, so actor
        # teardown after the refs die never strands data.)
        import weakref

        remaining = {"n": len(out)}

        def _one_ref_dead():
            remaining["n"] -= 1
            if remaining["n"] == 0:
                _kill_actor_pool(pool)

        for r in out:
            weakref.finalize(r, _one_ref_dead)
        ds = Dataset(out, stats_lineage=out_lineage)
        ds._stats_run_id = out_run_id
        return ds

    def map(self, fn: Callable[[dict], dict]) -> "Dataset":
        return self._chain(_MapRows(fn))

    def flat_map(self, fn: Callable[[dict], List[dict]]) -> "Dataset":
        return self._chain(_FlatMap(fn))

    def filter(self, fn: Callable[[dict], bool]) -> "Dataset":
        return self._chain(_Filter(fn))

    def select_columns(self, cols: List[str]) -> "Dataset":
        # logical-optimizer rule: projection pushdown (ray: data/_internal/
        # logical/rules — Project into Read).  A select directly over
        # column-capable read tasks (parquet) rewrites the readers to
        # fetch ONLY those columns instead of filtering post-read.
        if not self._ops and all(
            isinstance(s, ReadTask)
            and getattr(s.fn, "__rt_projectable__", False)
            for s in self._input_refs
        ):
            import functools

            pushed = [
                ReadTask(
                    functools.partial(s.fn, columns=list(cols)), *s.args
                )
                for s in self._input_refs
            ]
            return Dataset(pushed, exec_opts=self._exec_opts)
        return self.map_batches(
            lambda t: t.select(cols), batch_format="pyarrow"
        )

    def drop_columns(self, cols: List[str]) -> "Dataset":
        return self.map_batches(
            lambda t: t.drop_columns(cols), batch_format="pyarrow"
        )

    def add_column(self, name: str, fn: Callable) -> "Dataset":
        def add(t: pa.Table) -> pa.Table:
            return t.append_column(name, pa.array(fn(t)))

        return self.map_batches(add, batch_format="pyarrow")

    def rename_columns(self, mapping: Dict[str, str]) -> "Dataset":
        def rename(t: pa.Table) -> pa.Table:
            return t.rename_columns(
                [mapping.get(c, c) for c in t.column_names]
            )

        return self.map_batches(rename, batch_format="pyarrow")

    # -- execution -------------------------------------------------------
    def _stage_label(self, src) -> str:
        head = "Read" if isinstance(src, ReadTask) else "Input"
        return "->".join([head] + [op.label() for op in self._ops])

    def _submit_stage(self, src) -> Any:
        """One fused read+transform task for one source → block ref."""
        ops = self._ops
        if not ops and not isinstance(src, ReadTask):
            return src  # already-materialized block, nothing to run
        run_id, stage = self._stats_run_id, self._stage_label(src)

        @ray_tpu_torch.remote
        def run_stage(ops, src, run_id, stage):
            import time as _time

            from ray_tpu_torch.data import stats as stats_mod

            t0 = _time.perf_counter()
            block = src() if isinstance(src, ReadTask) else src
            block = _apply_ops(block, ops)
            stats_mod.record_stage(run_id, stage, t0, block)
            return block

        kw = {
            k: self._exec_opts[k]
            for k in ("num_cpus", "memory")
            if self._exec_opts.get(k) is not None
        }
        if kw:
            run_stage = run_stage.options(**kw)
        return run_stage.remote(ops, src, run_id, stage)

    def iter_block_refs(self) -> Iterator[Any]:
        """Streaming execution: yield block refs in order with a bounded
        in-flight production window.  The consumer's pull rate is the
        backpressure (ray: streaming_executor_state.py:497 analogue,
        collapsed to a sliding window over the fused single-stage plan);
        dropping each yielded ref frees the block cluster-wide via the
        distributed refcounter."""
        if self._materialized is not None:
            yield from self._materialized
            return
        from collections import deque

        from ray_tpu_torch.common.config import cfg

        window = max(
            1, self._exec_opts.get("window") or cfg.data_streaming_window
        )
        pending: Any = deque()
        srcs = iter(self._input_refs)
        for src in srcs:
            pending.append(self._submit_stage(src))
            if len(pending) >= window:
                break
        while pending:
            ref = pending.popleft()
            nxt = next(srcs, None)
            if nxt is not None:
                pending.append(self._submit_stage(nxt))
            yield ref

    def _execute(self) -> List[Any]:
        """Materialize the whole plan: every stage task in flight at once
        (used by shuffle boundaries and materialize(); streaming paths use
        iter_block_refs)."""
        if self._materialized is not None:
            return self._materialized
        self._materialized = [
            self._submit_stage(src) for src in self._input_refs
        ]
        return self._materialized

    def _blocks(self) -> List[Block]:
        return ray_tpu_torch.get(self._execute(), timeout=600)

    def materialize(self) -> "Dataset":
        """Execute and pin the result (ray: Dataset.materialize)."""
        refs = self._execute()
        ray_tpu_torch.wait(refs, num_returns=len(refs), timeout=600,
                     fetch_local=False)
        return Dataset(refs, stats_lineage=self._stats_lineage + (
            (self._stats_run_id, "Input"),
        ))

    def stats(self) -> str:
        """Per-stage execution statistics for everything this plan has
        RUN so far (ray: Dataset.stats, python/ray/data/dataset.py:4573):
        wall time min/max/mean/total, blocks, output rows and bytes per
        fused stage and shuffle map/reduce stage, plus cluster object
        store spill counters.  Stats are recorded as stage tasks execute;
        consume or materialize first for a complete picture."""
        from ray_tpu_torch.core.runtime import get_runtime
        from ray_tpu_torch.data import stats as stats_mod

        runs = list(self._stats_lineage) + [(self._stats_run_id, "Stage")]
        # stage tasks report fire-and-forget: poll until the record set
        # stabilizes (bounded) so a stats() right after consumption sees
        # the last stragglers
        import time as _time

        h = stats_mod.stats_handle()
        ids = [r[0] for r in runs]
        collected = ray_tpu_torch.get(h.get.remote(ids), timeout=60)
        deadline = _time.monotonic() + 3.0
        while _time.monotonic() < deadline:
            _time.sleep(0.15)
            again = ray_tpu_torch.get(h.get.remote(ids), timeout=60)
            if again == collected:
                break
            collected = again
        store_stats = None
        try:
            rt = get_runtime()
            store_stats = rt._run(rt.gcs.call("cluster_store_stats", {}))
        except Exception:
            pass
        return stats_mod.format_stats(runs, collected, store_stats)

    # -- shuffle-boundary ops -------------------------------------------
    # -- distributed shuffle core ---------------------------------------
    # Two-stage map/reduce exchange (ray: data/_internal/planner/exchange
    # push-based shuffle role): a map task splits every input block into
    # n_out partitions (num_returns=n_out), a reduce task per output
    # partition merges its pieces.  All block-sized work happens in
    # worker tasks — the driver never concatenates the dataset, so these
    # ops scale to datasets far beyond driver memory (blocks spill as
    # needed).

    def _block_counts(self, refs) -> List[int]:
        @ray_tpu_torch.remote
        def _rows(b):
            return b.num_rows

        return ray_tpu_torch.get([_rows.remote(r) for r in refs], timeout=600)

    @staticmethod
    def _exchange(refs, n_out: int, map_fn, reduce_fn,
                  map_args=None, stats_from: Optional["Dataset"] = None,
                  stage: str = "Shuffle") -> "Dataset":
        """map_fn(block, j_args...) -> tuple of n_out blocks;
        reduce_fn(*pieces) -> block.  map_args: per-input extra args."""
        if not refs:
            return Dataset([])
        import uuid

        out_run_id = uuid.uuid4().hex[:16]
        map_stage, reduce_stage = f"{stage}Map", f"{stage}Reduce"

        @ray_tpu_torch.remote
        def shuffle_map(block, *args):
            import time as _time

            from ray_tpu_torch.data import stats as stats_mod

            t0 = _time.perf_counter()
            pieces = tuple(map_fn(block, *args))
            stats_mod.record_stage(out_run_id, map_stage, t0, block)
            # num_returns=1 stores the RETURN VALUE as the single object:
            # unwrap, or the reduce would receive a 1-tuple
            return pieces if n_out > 1 else pieces[0]

        @ray_tpu_torch.remote
        def shuffle_reduce(*parts):
            import time as _time

            from ray_tpu_torch.data import stats as stats_mod

            t0 = _time.perf_counter()
            block = reduce_fn(list(parts))
            stats_mod.record_stage(out_run_id, reduce_stage, t0, block)
            return block

        map_outs = []
        for i, r in enumerate(refs):
            args = map_args[i] if map_args is not None else ()
            out = shuffle_map.options(num_returns=n_out).remote(r, *args)
            map_outs.append(out if n_out > 1 else [out])
        lineage = ()
        if stats_from is not None:
            lineage = stats_from._stats_lineage + (
                (stats_from._stats_run_id, "Input"),
            )
        ds = Dataset([
            shuffle_reduce.remote(*[mo[j] for mo in map_outs])
            for j in range(n_out)
        ], stats_lineage=lineage)
        ds._stats_run_id = out_run_id
        return ds

    def repartition(self, num_blocks: int) -> "Dataset":
        """Order-preserving rebalance into num_blocks equal-ish blocks."""
        refs = self._execute()
        if not refs:
            return Dataset([])
        counts = self._block_counts(refs)
        total = builtins.sum(counts)
        step = (total + num_blocks - 1) // num_blocks if total else 0
        offsets = np.concatenate([[0], np.cumsum(counts)])

        def cut(block, off):
            pieces = []
            for j in range(num_blocks):
                glo = min(j * step, total)
                ghi = min((j + 1) * step, total)
                lo = min(max(glo - off, 0), block.num_rows)
                hi = min(max(ghi - off, 0), block.num_rows)
                pieces.append(block.slice(lo, hi - lo))
            return pieces

        return self._exchange(
            refs, num_blocks, cut, concat_blocks,
            map_args=[(int(offsets[i]),) for i in range(len(refs))],
            stats_from=self, stage="Repartition",
        )

    def random_shuffle(self, *, seed: Optional[int] = None) -> "Dataset":
        """Distributed uniform shuffle: rows scatter to random output
        partitions, each reduce locally permutes its merged rows."""
        refs = self._execute()
        if not refs:
            return Dataset([])
        n = len(refs)
        base = seed if seed is not None else int.from_bytes(
            os.urandom(4), "little"
        )

        def scatter(block, block_idx):
            rng = np.random.default_rng((base, 1, block_idx))
            shard = rng.integers(0, n, block.num_rows)
            return [
                block.take(pa.array(np.nonzero(shard == j)[0]))
                for j in range(n)
            ]

        def merge_permute(parts):
            whole = concat_blocks(parts)
            # deterministic per-partition permutation: partition identity
            # comes from the pieces' total, block_idx is unavailable — a
            # content-independent stream per reduce is enough for
            # uniformity given the random scatter
            rng = np.random.default_rng((base, 2, whole.num_rows))
            return whole.take(pa.array(rng.permutation(whole.num_rows)))

        return self._exchange(
            refs, n, scatter, merge_permute,
            map_args=[(i,) for i in range(n)],
            stats_from=self, stage="RandomShuffle",
        )

    def sort(self, key: str, descending: bool = False) -> "Dataset":
        """Distributed range-partitioned sort: sample keys → quantile
        boundaries → scatter by range → per-partition local sort.  The
        output blocks are globally ordered."""
        refs = self._execute()
        if not refs:
            return Dataset([])
        n = len(refs)
        order = "descending" if descending else "ascending"

        if n == 1:
            @ray_tpu_torch.remote
            def sort_one(block):
                return block.sort_by([(key, order)])

            return Dataset([sort_one.remote(refs[0])])

        @ray_tpu_torch.remote
        def sample_keys(block, cap=128):
            vals = block.column(key).to_numpy(zero_copy_only=False)
            if len(vals) > cap:
                idx = np.linspace(0, len(vals) - 1, cap).astype(np.int64)
                vals = vals[idx]
            return np.sort(vals)

        samples = np.concatenate(
            ray_tpu_torch.get([sample_keys.remote(r) for r in refs], timeout=600)
        )
        samples = np.sort(samples)
        # n-1 quantile boundaries over the sampled key distribution
        bounds = samples[np.linspace(
            0, len(samples) - 1, n + 1
        ).astype(np.int64)][1:-1] if len(samples) else np.array([])

        def scatter(block):
            vals = block.column(key).to_numpy(zero_copy_only=False)
            part = np.searchsorted(bounds, vals, side="right")
            if descending:
                part = (n - 1) - part
            return [
                block.take(pa.array(np.nonzero(part == j)[0]))
                for j in range(n)
            ]

        def merge_sort(parts):
            return concat_blocks(parts).sort_by([(key, order)])

        return self._exchange(
            refs, n, scatter, merge_sort, stats_from=self, stage="Sort"
        )

    def union(self, *others: "Dataset") -> "Dataset":
        refs = list(self._execute())
        for o in others:
            refs.extend(o._execute())
        return Dataset(refs)

    def zip(self, other: "Dataset") -> "Dataset":
        """Row-aligned column concatenation of two equal-length datasets
        (ray: python/ray/data/dataset.py:2215 Dataset.zip).  The right
        side's blocks are re-sliced to the left side's block boundaries,
        so each output block is produced by ONE task reading its left
        block plus the covering right-side ranges — no driver
        concatenation.  Colliding column names get a "_1" suffix, like
        the reference."""
        refs_a = self._execute()
        refs_b = other._execute()
        counts_a = self._block_counts(refs_a)
        counts_b = self._block_counts(refs_b)
        if builtins.sum(counts_a) != builtins.sum(counts_b):
            raise ValueError(
                f"zip requires equal row counts: "
                f"{builtins.sum(counts_a)} vs {builtins.sum(counts_b)}"
            )
        off_b = np.concatenate([[0], np.cumsum(counts_b)])

        @ray_tpu_torch.remote
        def zip_blocks(a_block, spans, *b_blocks):
            pieces = [
                b.slice(start, stop - start)
                for b, (start, stop) in zip(b_blocks, spans)
            ]
            right = concat_blocks(pieces)
            out = a_block
            taken = set(a_block.column_names)
            for name, col in zip(right.column_names, right.columns):
                out_name = name if name not in taken else f"{name}_1"
                taken.add(out_name)
                out = out.append_column(out_name, col)
            return out

        out_refs = []
        row = 0
        for a_ref, n_rows in zip(refs_a, counts_a):
            lo, hi = row, row + n_rows
            spans, parts = [], []
            # right-side blocks overlapping [lo, hi)
            j0 = int(np.searchsorted(off_b, lo, side="right")) - 1
            j = max(0, j0)
            while j < len(refs_b) and off_b[j] < hi:
                s = max(lo, int(off_b[j])) - int(off_b[j])
                e = min(hi, int(off_b[j + 1])) - int(off_b[j])
                if e > s:
                    spans.append((s, e))
                    parts.append(refs_b[j])
                j += 1
            if not spans:
                # zero-row left block: a 0-row right slice keeps the
                # right SCHEMA in the output (a schemaless empty would
                # make sibling blocks inconsistent downstream)
                spans, parts = [(0, 0)], [refs_b[0]]
            out_refs.append(zip_blocks.remote(a_ref, spans, *parts))
            row = hi
        return Dataset(out_refs)

    def join(
        self,
        other: "Dataset",
        on: Union[str, List[str]],
        how: str = "inner",
        *,
        num_partitions: Optional[int] = None,
    ) -> "Dataset":
        """Distributed hash join (ray: Dataset.join).  Both sides
        hash-partition on the key (process-stable crc32, the groupby
        scatter), then each partition joins via pyarrow's native
        Table.join — n independent tasks, no driver concatenation."""
        join_type = {
            "inner": "inner",
            "left": "left outer",
            "right": "right outer",
            "outer": "full outer",
            "semi": "left semi",
            "anti": "left anti",
        }.get(how)
        if join_type is None:
            raise ValueError(
                f"unknown join how={how!r}; one of inner/left/right/"
                f"outer/semi/anti"
            )
        keys = [on] if isinstance(on, str) else list(on)
        refs_a = self._execute()
        refs_b = other._execute()
        if not refs_a:
            if join_type in (
                "inner", "left semi", "left anti", "left outer",
            ):
                return Dataset([])
            raise ValueError(
                f"{how} join with an empty left side is not supported "
                "(the output needs the left schema)"
            )
        if not refs_b:
            if join_type in ("inner", "left semi"):
                return Dataset([])
            if join_type == "left anti":
                return Dataset(list(refs_a))  # nothing to subtract
            raise ValueError(
                f"{how} join with an empty right side is not supported "
                "(the output needs the right schema)"
            )
        n = num_partitions or max(len(refs_a), len(refs_b), 1)
        key0 = keys[0]

        @ray_tpu_torch.remote
        def scatter(block):
            pieces = GroupedData._hash_scatter(block, key0, n)
            return tuple(pieces) if n > 1 else pieces[0]

        @ray_tpu_torch.remote
        def join_part(n_left, *parts):
            left = concat_blocks(list(parts[:n_left]))
            right = concat_blocks(list(parts[n_left:]))
            return left.join(right, keys=keys, join_type=join_type)

        def scatter_side(refs):
            outs = []
            for r in refs:
                o = scatter.options(num_returns=n).remote(r)
                outs.append(o if n > 1 else [o])
            return outs

        parts_a = scatter_side(refs_a)
        parts_b = scatter_side(refs_b)
        return Dataset([
            join_part.remote(
                len(parts_a),
                *[pa_[j] for pa_ in parts_a],
                *[pb_[j] for pb_ in parts_b],
            )
            for j in range(n)
        ])

    def limit(self, n: int) -> "Dataset":
        taken, out = 0, []
        for ref in self.iter_block_refs():
            if taken >= n:
                break
            b = ray_tpu_torch.get(ref, timeout=600)
            keep = min(b.num_rows, n - taken)
            out.append(ray_tpu_torch.put(b.slice(0, keep)))
            taken += keep
        return Dataset(out)

    def split(self, n: int, *, equal: bool = False) -> List["Dataset"]:
        """Split into n datasets (per-worker ingest).

        equal=False stays LAZY: sources round-robin into the splits with
        the pending ops carried along, so each worker's shard streams
        independently.

        equal=True gives every shard EXACTLY total_rows // n rows
        (extras dropped) — the invariant SPMD train gangs need so all
        workers see the same batch count.  The plan executes into the
        OBJECT STORE (distributed, spill-backed) and shards carry lazy
        row-range slices over those blocks; nothing is concatenated in
        this process."""
        if equal:
            refs = self._execute()

            @ray_tpu_torch.remote
            def _rows(b):
                return b.num_rows

            counts = ray_tpu_torch.get(
                [_rows.remote(r) for r in refs], timeout=600
            )
            total = builtins.sum(counts)
            per = total // n

            def _slice_block(ref, lo, hi):
                return ray_tpu_torch.get(ref, timeout=600).slice(lo, hi - lo)

            # walk blocks once, assigning contiguous [lo, hi) row ranges
            shards: List[List[Any]] = [[] for _ in range(n)]
            block_i, block_off = 0, 0
            for w in range(n):
                need = per
                while need > 0 and block_i < len(refs):
                    avail = counts[block_i] - block_off
                    take = min(avail, need)
                    if take > 0:
                        shards[w].append(ReadTask(
                            _slice_block, refs[block_i], block_off,
                            block_off + take,
                        ))
                    need -= take
                    block_off += take
                    if block_off >= counts[block_i]:
                        block_i += 1
                        block_off = 0
            return [Dataset(srcs) for srcs in shards]
        out: List[List[Any]] = [[] for _ in range(n)]
        for i, src in enumerate(self._input_refs):
            out[i % n].append(src)
        return [
            Dataset(srcs, ops=list(self._ops), exec_opts=self._exec_opts)
            for srcs in out
        ]

    def streaming_split(
        self, n: int, *, equal: bool = False, locality_hints=None
    ) -> List["DataIterator"]:
        """n per-worker streaming iterators (ray: Dataset.streaming_split,
        python/ray/data/dataset.py:1141) — the Train ingest surface.

        Each split streams its shard of source blocks through the pending
        lazy ops independently on the consuming worker, so ingest is
        worker-local with no central coordinator; `equal=True`
        materializes to balance rows exactly (needed when the consumers
        run in SPMD lockstep and must see the same batch count).
        locality_hints is accepted for API parity; block placement is
        store-driven here."""
        return [DataIterator(ds) for ds in self.split(n, equal=equal)]

    def groupby(self, key: str) -> "GroupedData":
        return GroupedData(self, key)

    # -- consumption -----------------------------------------------------
    def count(self) -> int:
        @ray_tpu_torch.remote
        def count_block(b):
            return b.num_rows

        # per-block counts consume each block promptly, so the stage
        # outputs free as fast as they are counted
        refs = [count_block.remote(r) for r in self.iter_block_refs()]
        return sum(ray_tpu_torch.get(refs, timeout=600))

    def num_blocks(self) -> int:
        return len(self._input_refs)

    def schema(self):
        for ref in self.iter_block_refs():
            b = ray_tpu_torch.get(ref, timeout=600)
            if b.num_rows or b.column_names:
                return b.schema
        return None

    def columns(self) -> List[str]:
        s = self.schema()
        return list(s.names) if s else []

    def take(self, n: int = 20) -> List[dict]:
        rows: List[dict] = []
        for ref in self.iter_block_refs():
            b = ray_tpu_torch.get(ref, timeout=600)
            for r in BlockAccessor(b).iter_rows():
                rows.append(r)
                if len(rows) >= n:
                    return rows
        return rows

    def take_all(self) -> List[dict]:
        return [
            r
            for b in self._blocks()
            for r in BlockAccessor(b).iter_rows()
        ]

    def show(self, n: int = 20) -> None:
        for r in self.take(n):
            print(r)

    def iter_rows(self) -> Iterator[dict]:
        for ref in self.iter_block_refs():
            b = ray_tpu_torch.get(ref, timeout=600)
            yield from BlockAccessor(b).iter_rows()

    def iter_batches(
        self,
        *,
        batch_size: Optional[int] = 256,
        batch_format: str = "numpy",
        drop_last: bool = False,
    ) -> Iterator[Any]:
        """Stream batches, re-chunking across block boundaries; pulls one
        block at a time through the bounded streaming window."""
        carry: Optional[Block] = None
        for ref in self.iter_block_refs():
            b = ray_tpu_torch.get(ref, timeout=600)
            if carry is not None and carry.num_rows:
                b = concat_blocks([carry, b])
                carry = None
            if batch_size is None:
                if b.num_rows:
                    yield _from_block(b, batch_format)
                continue
            off = 0
            while b.num_rows - off >= batch_size:
                yield _from_block(
                    b.slice(off, batch_size), batch_format
                )
                off += batch_size
            if off < b.num_rows:
                carry = b.slice(off)
        if carry is not None and carry.num_rows and not drop_last:
            yield _from_block(carry, batch_format)

    def iter_torch_batches(
        self,
        *,
        batch_size: int = 256,
        drop_last: bool = False,
        dtypes: Optional[Dict[str, Any]] = None,
        device: Optional[str] = None,
    ) -> Iterator[Dict[str, Any]]:
        """Batches as torch tensors (ray: Dataset.iter_torch_batches).

        CPU tensors unless ``device`` places them (a plain synchronous
        ``.to``); a training loop on the card reads iter_device_batches,
        which overlaps the copy with the step."""
        import torch

        for batch in self.iter_batches(
            batch_size=batch_size, batch_format="numpy",
            drop_last=drop_last,
        ):
            out = {}
            for k, v in batch.items():
                v = np.ascontiguousarray(v)
                if not v.flags.writeable:
                    # pyarrow's zero-copy to_numpy is read-only; torch
                    # mutation of such memory is undefined behavior
                    v = v.copy()
                t = torch.from_numpy(v)
                if dtypes and k in dtypes:
                    t = t.to(dtypes[k])
                if device:
                    t = t.to(device)
                out[k] = t
            yield out

    def iter_device_batches(
        self,
        *,
        batch_size: int = 256,
        device: Any = "cuda",
        sharding=None,
        drop_last: bool = True,
        dtypes: Optional[Dict[str, Any]] = None,
    ) -> Iterator[Dict[str, Any]]:
        """Batches as tensors on ``device`` — the card by default — the
        counterpart of the reference's ``iter_jax_batches``
        (``ray_tpu/data/dataset.py``), the training loop's ingest path.

        ``sharding`` (a ``parallel.mesh.Mesh``) hands each batch to
        ``parallel.spmd.shard_batch``, which lays it out over the mesh for
        an SPMD step; ``dtypes`` maps columns to torch dtypes, converted on
        the device.  Static shapes keep the step's kernels and buffers the
        same every step, so drop_last defaults True.

        Double-buffered: batch N+1's host-to-device copy is issued before
        batch N is yielded, so the transfer overlaps the caller's step N.
        On the card each column is first copied into pinned host memory
        (pyarrow's zero-copy arrays are read-only and pageable), then
        copied ``non_blocking`` on a side stream; the consumer's stream
        waits on the copy's event before it uses the batch, and the pinned
        buffer is held until that event completes.  A CUDA device with no
        card present raises here, at the call: it never falls back to the
        CPU (``device="cpu"`` gives CPU tensors, laid out the same way).
        """
        from ray_tpu_torch.device import resolve_device

        dev = resolve_device(device)
        batches = self.iter_batches(
            batch_size=batch_size, batch_format="numpy", drop_last=drop_last
        )
        if dev.type == "cuda":
            return _cuda_batches(batches, dev, sharding, dtypes)
        return _host_batches(batches, dev, sharding, dtypes)

    def to_pandas(self):
        return concat_blocks(self._blocks()).to_pandas()

    # -- stats / misc ----------------------------------------------------
    def sum(self, col: str):
        return self._agg(col, "sum")

    def min(self, col: str):
        return self._agg(col, "min")

    def max(self, col: str):
        return self._agg(col, "max")

    def mean(self, col: str):
        import pyarrow.compute as pc

        total, count = 0.0, 0
        for b in self._blocks():
            if b.num_rows:
                total += pc.sum(b.column(col)).as_py() or 0
                count += b.num_rows
        return total / count if count else None

    def _agg(self, col: str, kind: str):
        import pyarrow.compute as pc

        vals = []
        for b in self._blocks():
            if b.num_rows:
                vals.append(getattr(pc, kind)(b.column(col)).as_py())
        if not vals:
            return None
        return getattr(builtins, kind)(vals)

    def __repr__(self):
        lazy = sum(1 for s in self._input_refs if isinstance(s, ReadTask))
        return (
            f"Dataset(num_blocks={len(self._input_refs)}, "
            f"lazy_sources={lazy}, pending_ops={len(self._ops)})"
        )


class GroupedData:
    """Hash-partitioned groupby (ray: data/grouped_data.py analogue)."""

    def __init__(self, ds: Dataset, key: str):
        self._ds = ds
        self._key = key

    @staticmethod
    def _hash_scatter(block, key: str, n: int):
        """Rows → n partitions by a process-stable hash of the group key
        (python hash() is salted per process, so crc32 instead)."""
        from zlib import crc32

        vals = block.column(key).to_pylist()
        part = np.fromiter(
            (crc32(repr(v).encode()) % n for v in vals),
            np.int64, count=len(vals),
        )
        return [
            block.take(pa.array(np.nonzero(part == j)[0]))
            for j in range(n)
        ]

    def _aggregate(self, aggs: Dict[str, str]) -> Dataset:
        """aggs: {column: 'sum'|'mean'|'min'|'max'|'count'}

        Distributed: hash-partition by the group key (every key lands
        whole in exactly one partition, so per-partition aggregates are
        exact), aggregate per partition, no driver concatenation."""
        key = self._key
        refs = self._ds._execute()
        if not refs:
            return Dataset([])
        n = len(refs)
        agg_list = [(c, k) for c, k in aggs.items()]

        def scatter(block):
            return GroupedData._hash_scatter(block, key, n)

        def merge_agg(parts):
            return concat_blocks(parts).group_by(key).aggregate(agg_list)

        return Dataset._exchange(
            refs, n, scatter, merge_agg, stats_from=self._ds,
            stage="GroupByAgg",
        )

    def sum(self, col: str) -> Dataset:
        return self._aggregate({col: "sum"})

    def mean(self, col: str) -> Dataset:
        return self._aggregate({col: "mean"})

    def min(self, col: str) -> Dataset:
        return self._aggregate({col: "min"})

    def max(self, col: str) -> Dataset:
        return self._aggregate({col: "max"})

    def count(self) -> Dataset:
        return self._aggregate({self._key: "count"})


class DataIterator:
    """Per-worker streaming view of a Dataset split.

    Role-equivalent of ray: python/ray/data/iterator.py (DataIterator,
    returned by Dataset.streaming_split / passed to Train workers via
    get_dataset_shard).  Serializable: ships the shard's source refs and
    pending lazy ops to the consuming worker, which streams blocks from
    the object store through the ops locally."""

    def __init__(self, dataset: Dataset):
        self._ds = dataset

    def iter_batches(self, **kwargs) -> Iterator[Dict[str, Any]]:
        return self._ds.iter_batches(**kwargs)

    def iter_device_batches(self, **kwargs) -> Iterator[Dict[str, Any]]:
        """Card-resident batches with double-buffered transfer — the
        train-loop ingest path (see Dataset.iter_device_batches, the
        counterpart of the reference's iter_jax_batches)."""
        return self._ds.iter_device_batches(**kwargs)

    def iter_torch_batches(self, **kwargs) -> Iterator[Dict[str, Any]]:
        return self._ds.iter_torch_batches(**kwargs)

    def iter_rows(self):
        return self._ds.iter_rows()

    def materialize(self) -> Dataset:
        return self._ds.materialize()

    def count(self) -> int:
        return self._ds.count()

    def __repr__(self):
        return f"DataIterator({self._ds!r})"
