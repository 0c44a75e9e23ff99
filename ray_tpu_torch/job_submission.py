"""Job submission: run driver entrypoints on the cluster head.

Role-equivalent of ray: dashboard/modules/job/job_manager.py:529
(JobManager) + python/ray/dashboard/modules/job/sdk.py
(JobSubmissionClient) without the HTTP dashboard in between: the job
manager lives inside the GCS process (rpc_submit_job & co.), spawns the
entrypoint as a subprocess with RT_ADDRESS pointing back at the cluster,
applies the job-level runtime_env (env_vars; working_dir extracted from
the content-addressed KV package), and tracks status + captured logs
under the session dir.

The entrypoint sees the head's cards: the GCS gives it the card set
recorded in ``RT_GPU_VISIBLE_DEVICES`` as ``CUDA_VISIBLE_DEVICES``
(``core/gcs.py`` ``rpc_submit_job``), where the control plane itself sees
none.  A head started by ``python -m ray_tpu_torch start --head
--num-gpus N`` records its first N cards there (``scripts.py``).

    client = JobSubmissionClient("127.0.0.1:6379")
    job_id = client.submit_job(entrypoint="python my_driver.py",
                               runtime_env={"working_dir": "./app"})
    client.get_job_status(job_id)   # PENDING/RUNNING/SUCCEEDED/FAILED/...
    client.get_job_logs(job_id)
"""

from __future__ import annotations

import asyncio
import time
from typing import Any, Dict, List, Optional

from ray_tpu_torch.core import rpc

PENDING = "PENDING"
RUNNING = "RUNNING"
SUCCEEDED = "SUCCEEDED"
FAILED = "FAILED"
STOPPED = "STOPPED"


class JobSubmissionClient:
    """Synchronous client against the head's GCS (ray: sdk.py:88)."""

    def __init__(self, address: str):
        self.address = address

    def _call(self, method: str, payload: dict) -> Any:
        async def go():
            conn = await rpc.connect(self.address)
            try:
                return await conn.call(method, payload, timeout=60.0)
            finally:
                await conn.close()

        return asyncio.run(go())

    def submit_job(
        self,
        *,
        entrypoint: str,
        runtime_env: Optional[dict] = None,
        metadata: Optional[Dict[str, str]] = None,
        submission_id: Optional[str] = None,
    ) -> str:
        desc = None
        if runtime_env:
            from ray_tpu_torch.core import runtime_env as rtenv_mod

            desc = rtenv_mod.normalize(
                runtime_env,
                kv_put=lambda sha, v: self._call(
                    "put_blob", {"sha": sha, "data": v}
                ),
                scope=self.address,
            )
        reply = self._call(
            "submit_job",
            {
                "entrypoint": entrypoint,
                "runtime_env": desc,
                "metadata": metadata or {},
                "submission_id": submission_id,
            },
        )
        return reply["submission_id"]

    def get_job_status(self, submission_id: str) -> str:
        return self._call("get_job_info", {"submission_id": submission_id})[
            "status"
        ]

    def get_job_info(self, submission_id: str) -> dict:
        return self._call("get_job_info", {"submission_id": submission_id})

    def get_job_logs(self, submission_id: str) -> str:
        return self._call("get_job_logs", {"submission_id": submission_id})

    def stop_job(self, submission_id: str) -> bool:
        return self._call("stop_job", {"submission_id": submission_id})

    def list_jobs(self) -> List[dict]:
        return self._call("list_jobs", {})

    def wait_until_finished(
        self, submission_id: str, timeout: float = 300.0
    ) -> str:
        deadline = time.monotonic() + timeout
        status = self.get_job_status(submission_id)
        while True:
            if status in (SUCCEEDED, FAILED, STOPPED):
                return status
            if time.monotonic() >= deadline:
                break
            time.sleep(0.5)
            status = self.get_job_status(submission_id)
        raise TimeoutError(
            f"job {submission_id} still {status!r} after {timeout}s"
        )
