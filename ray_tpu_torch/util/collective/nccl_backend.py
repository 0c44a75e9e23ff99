"""Runtime collectives over a ``torch.distributed`` gang (port of the
reference's ``JaxGangBackend``, ``util/collective/jax_backend.py``).

When every rank of a group is a process of one ``torch.distributed`` gang
(the trainer's shape: one process per card, all in one default process
group), the runtime op surface rides the gang's own collectives instead of
the RPC ring: NCCL on the card where the members' leases hold cards (the
Train backend forms NCCL there), gloo on the host where they do not.  The
name is ``"nccl"`` either way; the op runs on the group's device and hands
numpy back.

Constraints (checked at setup): ``world_size`` must equal the gang's and
``rank`` this process's rank in it: group membership is gang membership;
arbitrary sub-groups need the ``"rpc"`` backend.  The per-op and per-group
``wire_dtype``/``algorithm`` overrides belong to the RPC ring and raise here,
and so does point-to-point send/recv, as on the reference's gang backend.

Unlike the rest of ``util/collective``, this module imports torch: it is
loaded only when a group asks for ``"nccl"``, in a process whose gang
already holds torch.
"""

from __future__ import annotations

import asyncio

from ray_tpu_torch.util.collective.backend import RuntimeBackend
from ray_tpu_torch.util.collective.types import CollectiveError, ReduceOp


class NcclGangBackend(RuntimeBackend):
    kind = "runtime"

    async def setup(self):
        import torch
        import torch.distributed as dist

        if not dist.is_initialized():
            raise CollectiveError(
                "the nccl backend rides this process's torch.distributed gang: call "
                "torch.distributed.init_process_group across the member processes first "
                "(the Train backend forms one), or use backend='rpc'"
            )
        n, me = dist.get_world_size(), dist.get_rank()
        if self.spec.world_size != n or self.spec.rank != me:
            raise CollectiveError(
                f"nccl backend requires group membership == gang "
                f"membership: world_size {self.spec.world_size} / rank "
                f"{self.spec.rank} vs the gang's world size {n} / rank "
                f"{me}.  Form the gang across exactly the members, or "
                f"use backend='rpc' for arbitrary actor sub-groups."
            )
        opt = self.spec.options
        if opt.wire_dtype not in (None, "fp32") or opt.algorithm is not None:
            raise CollectiveError(
                "the nccl gang backend rides torch.distributed's own "
                "collectives; wire_dtype / algorithm group options apply "
                "to the 'rpc' backend only"
            )
        self._dist = dist
        self._torch = torch
        self._device = (torch.device("cuda", torch.cuda.current_device())
                        if dist.get_backend() == "nccl" else torch.device("cpu"))

    def _refuse_v2(self, wire_dtype, algorithm=None):
        if wire_dtype not in (None, "fp32") or algorithm is not None:
            raise CollectiveError(
                "wire_dtype / algorithm overrides are not supported on "
                "the nccl gang backend; use backend='rpc'"
            )

    def _tensor(self, arr):
        import numpy as np

        return self._torch.from_numpy(np.array(arr, copy=True)).to(self._device)

    @staticmethod
    def _numpy(t):
        return t.cpu().numpy()

    async def _run(self, fn, *args, **kw):
        # gang ops block until every member arrives: off the io loop
        return await asyncio.to_thread(fn, *args, **kw)

    async def allreduce(self, arr, op: ReduceOp, *, wire_dtype=None, algorithm=None):
        self._refuse_v2(wire_dtype, algorithm)
        ops = {ReduceOp.SUM: "SUM", ReduceOp.MEAN: "SUM", ReduceOp.PRODUCT: "PRODUCT",
               ReduceOp.MIN: "MIN", ReduceOp.MAX: "MAX"}
        if op not in ops:
            raise CollectiveError(f"unsupported reduce op {op!r}")
        t = self._tensor(arr)
        await self._run(self._dist.all_reduce, t, op=getattr(self._dist.ReduceOp, ops[op]))
        out = self._numpy(t)
        if op is ReduceOp.MEAN:
            import numpy as np

            np.divide(out, self.spec.world_size, out=out, casting="unsafe")
        return out

    async def allgather(self, arr):
        t = self._tensor(arr)
        parts = [self._torch.empty_like(t) for _ in range(self.spec.world_size)]
        await self._run(self._dist.all_gather, parts, t)
        return [self._numpy(p) for p in parts]

    async def reducescatter(self, arr, op: ReduceOp, *, wire_dtype=None):
        import numpy as np

        self._refuse_v2(wire_dtype)
        reduced = (await self.allreduce(arr, op)).reshape(-1)
        return np.array_split(reduced, self.spec.world_size)[self.spec.rank].copy()

    async def broadcast(self, arr, root: int, *, wire_dtype=None, algorithm=None):
        self._refuse_v2(wire_dtype, algorithm)
        t = self._tensor(arr)
        await self._run(self._dist.broadcast, t, src=root)
        return self._numpy(t)

    async def broadcast_object(self, obj, root: int):
        box = [obj if self.spec.rank == root else None]
        await self._run(self._dist.broadcast_object_list, box, src=root, device=self._device)
        return box[0]

    async def barrier(self):
        # a one-element sum is a barrier on every backend
        await self._run(self._dist.all_reduce, self._torch.zeros(1, device=self._device))
        return True

    async def send(self, arr, dst: int):
        raise CollectiveError(
            "point-to-point send/recv is not offered over the nccl "
            "gang surface; use backend='rpc' for p2p patterns"
        )

    async def recv(self, arr, src: int):
        raise CollectiveError(
            "point-to-point send/recv is not offered over the nccl "
            "gang surface; use backend='rpc' for p2p patterns"
        )
