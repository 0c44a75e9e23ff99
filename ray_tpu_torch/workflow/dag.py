"""Task DAG nodes for workflows (ray: python/ray/dag/function_node.py).

`fn.bind(*args)` produces a FunctionNode whose args may themselves be
FunctionNodes; `ray_tpu_torch.workflow.run` walks the graph, executes every
node as a normal remote task in dependency waves, and checkpoints each
completed step.
"""

from __future__ import annotations

from typing import Dict, List, Tuple


class FunctionNode:
    def __init__(self, remote_fn, args: tuple, kwargs: dict):
        self.remote_fn = remote_fn
        self.args = args
        self.kwargs = kwargs

    @property
    def name(self) -> str:
        fn = self.remote_fn._fn
        return getattr(fn, "__name__", "step")

    def __repr__(self):
        return f"FunctionNode({self.name})"


def topo_sort(root: FunctionNode) -> List[FunctionNode]:
    """Deterministic topological order (parents before children)."""
    order: List[FunctionNode] = []
    state: Dict[int, int] = {}

    def visit(n):
        if not isinstance(n, FunctionNode):
            return
        s = state.get(id(n))
        if s == 1:
            return
        if s == 0:
            raise ValueError("cycle detected in workflow DAG")
        state[id(n)] = 0
        for a in n.args:
            visit(a)
        for a in n.kwargs.values():
            visit(a)
        state[id(n)] = 1
        order.append(n)

    visit(root)
    return order


def step_ids(root: FunctionNode) -> List[Tuple[str, FunctionNode]]:
    """Stable step ids: topo index + function name.  Re-running the same
    DAG shape yields the same ids, which is what makes resume skip
    completed steps."""
    return [
        (f"{i:04d}_{n.name}", n) for i, n in enumerate(topo_sort(root))
    ]
