"""Durable, resumable task graphs (ray: python/ray/workflow/api.py).

`run(dag)` executes a `fn.bind(...)` graph as normal remote tasks in
dependency waves; every completed step's output is checkpointed to
`WorkflowStorage` before its children launch, so a crash at any point
resumes from the last completed frontier with `resume(workflow_id)`.

Deliberate simplifications vs the reference (documented descopes):
- Static DAGs only — no in-step continuations (`workflow.continuation`)
  and no virtual actors (deprecated upstream).
- Checkpointing is per-step and driver-side; the reference's
  storage-backed ObjectRef dedup is subsumed by this repo's distributed
  refcounting for in-flight values.

A step made with ``.options(num_gpus=1)`` leases a card like any task;
two such steps in one wave queue on one card.  Its CUDA tensors reach the
driver, and its checkpoint, as CPU tensors.
"""

from __future__ import annotations

import threading
import time
import uuid
from typing import Any, Dict, List, Optional

from ray_tpu_torch.workflow import storage as _st
from ray_tpu_torch.workflow.dag import FunctionNode, step_ids


class WorkflowError(RuntimeError):
    pass


class WorkflowNotFoundError(WorkflowError):
    pass


def _execute(store: _st.WorkflowStorage, root: FunctionNode) -> Any:
    """Run the DAG in dependency waves, skipping checkpointed steps."""
    import ray_tpu_torch

    steps = step_ids(root)
    sid_of = {id(n): sid for sid, n in steps}
    done: Dict[str, Any] = {}
    for sid, _ in steps:
        if store.has_step(sid):
            done[sid] = store.load_step(sid)

    pending = {sid: n for sid, n in steps if sid not in done}
    inflight: Dict[Any, str] = {}  # ref -> step_id

    def ready(n: FunctionNode) -> bool:
        deps = [
            a for a in list(n.args) + list(n.kwargs.values())
            if isinstance(a, FunctionNode)
        ]
        return all(sid_of[id(d)] in done for d in deps)

    def resolve(v):
        return done[sid_of[id(v)]] if isinstance(v, FunctionNode) else v

    while pending or inflight:
        launched = []
        for sid, n in pending.items():
            if ready(n):
                args = [resolve(a) for a in n.args]
                kwargs = {k: resolve(v) for k, v in n.kwargs.items()}
                ref = n.remote_fn.remote(*args, **kwargs)
                inflight[ref] = sid
                launched.append(sid)
        for sid in launched:
            del pending[sid]
        if not inflight:
            raise WorkflowError(
                "workflow deadlocked: no step ready and none in flight"
            )
        ready_refs, _ = ray_tpu_torch.wait(
            list(inflight), num_returns=1, timeout=None
        )
        for ref in ready_refs:
            sid = inflight.pop(ref)
            value = ray_tpu_torch.get(ref)
            store.save_step(sid, value)  # checkpoint before children launch
            done[sid] = value

    return done[sid_of[id(root)]]


def run(
    dag: FunctionNode,
    *,
    workflow_id: Optional[str] = None,
    storage: Optional[str] = None,
) -> Any:
    """Execute a DAG durably; returns the root node's output."""
    if not isinstance(dag, FunctionNode):
        raise TypeError("workflow.run takes a FunctionNode from fn.bind(...)")
    wid = workflow_id or f"wf-{uuid.uuid4().hex[:12]}"
    store = _st.WorkflowStorage(wid, storage)
    if store.load_meta() is not None:
        # a fresh run must never inherit another DAG's step checkpoints
        # (step ids are topo-index+name and would collide silently);
        # the reference raises on duplicate ids the same way.
        raise WorkflowError(
            f"workflow id {wid!r} already exists; use workflow.resume() "
            "to continue it or workflow.delete() first"
        )
    store.save_dag(dag)
    store.save_meta(status=_st.RUNNING, error=None)
    try:
        out = _execute(store, dag)
    except Exception as e:  # noqa: BLE001 - recorded then re-raised
        store.save_meta(status=_st.FAILED, error=repr(e),
                        finished_at=time.time())
        raise
    store.save_meta(status=_st.SUCCEEDED, finished_at=time.time())
    return out


def run_async(dag: FunctionNode, *, workflow_id: Optional[str] = None,
              storage: Optional[str] = None):
    """Run in a background thread; returns a concurrent.futures.Future."""
    import concurrent.futures

    wid = workflow_id or f"wf-{uuid.uuid4().hex[:12]}"
    fut: concurrent.futures.Future = concurrent.futures.Future()

    def go():
        try:
            fut.set_result(run(dag, workflow_id=wid, storage=storage))
        except BaseException as e:  # noqa: BLE001
            fut.set_exception(e)

    t = threading.Thread(target=go, name=f"workflow-{wid}", daemon=True)
    t.start()
    fut.workflow_id = wid  # type: ignore[attr-defined]
    return fut


def resume(workflow_id: str, *, storage: Optional[str] = None) -> Any:
    """Re-run a FAILED/RUNNING-at-crash workflow from its checkpoints."""
    store = _st.WorkflowStorage(workflow_id, storage)
    meta = store.load_meta()
    if meta is None:
        raise WorkflowNotFoundError(workflow_id)
    dag = store.load_dag()
    store.save_meta(status=_st.RUNNING, error=None)
    try:
        out = _execute(store, dag)
    except Exception as e:  # noqa: BLE001
        store.save_meta(status=_st.FAILED, error=repr(e),
                        finished_at=time.time())
        raise
    store.save_meta(status=_st.SUCCEEDED, finished_at=time.time())
    return out


def get_status(workflow_id: str, *, storage: Optional[str] = None) -> str:
    meta = _st.WorkflowStorage(workflow_id, storage).load_meta()
    if meta is None:
        raise WorkflowNotFoundError(workflow_id)
    return meta["status"]


def get_output(workflow_id: str, *, storage: Optional[str] = None) -> Any:
    """Output of a SUCCEEDED workflow (its root step's checkpoint)."""
    store = _st.WorkflowStorage(workflow_id, storage)
    meta = store.load_meta()
    if meta is None:
        raise WorkflowNotFoundError(workflow_id)
    if meta["status"] != _st.SUCCEEDED:
        raise WorkflowError(
            f"workflow {workflow_id} is {meta['status']}, not SUCCEEDED"
        )
    dag = store.load_dag()
    root_sid = step_ids(dag)[-1][0]
    return store.load_step(root_sid)


def list_all(*, storage: Optional[str] = None) -> List[dict]:
    out = []
    for wid in _st.list_workflow_ids(storage):
        meta = _st.WorkflowStorage(wid, storage).load_meta()
        if meta:
            out.append(meta)
    return out


def delete(workflow_id: str, *, storage: Optional[str] = None) -> None:
    _st.WorkflowStorage(workflow_id, storage).delete()
