"""The port's object spilling end to end on the CPU: an object that fills
most of a small store is spilled by the raylet and restored for a task.

Marked slow: the raylet spills on its 5 s reaper pass, so the test waits
for it.  Run with ``python -m pytest tests/test_zz_torch_runtime.py -m slow``.
"""

import sys
import time

import cloudpickle
import numpy as np
import pytest

import ray_tpu_torch as rt
from ray_tpu_torch.core.runtime import get_runtime

pytestmark = pytest.mark.slow


def _checksum(refs):
    return int(rt.get(refs[0]).sum(dtype=np.uint64))


def test_spilled_object_is_restored_for_a_task():
    cloudpickle.register_pickle_by_value(sys.modules[__name__])
    rt.init(num_cpus=1, object_store_bytes=48 << 20, log_to_driver=False)
    try:
        r = get_runtime()
        data = np.random.default_rng(0).integers(0, 256, 40 << 20, dtype=np.uint8)
        ref = rt.put(data)
        deadline = time.monotonic() + 60
        while r._run(r.raylet.call("store_stats", {}), timeout=30)["spill_count"] < 1:
            assert time.monotonic() < deadline, "the raylet did not spill the object"
            time.sleep(0.2)
        got = rt.get(rt.remote(num_cpus=1)(_checksum).remote([ref]), timeout=120)
        assert got == int(data.sum(dtype=np.uint64))
        assert r._run(r.raylet.call("store_stats", {}), timeout=30)["restore_count"] == 1
        assert np.array_equal(rt.get(ref, timeout=60), data)
    finally:
        rt.shutdown()
        cloudpickle.unregister_pickle_by_value(sys.modules[__name__])
