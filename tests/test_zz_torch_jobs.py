"""Job submission and the CLI on the port, on the CPU: the six cases of
the JAX package's ``tests/test_job_submission.py`` against the port's
``Cluster``, then a head started by ``python -m ray_tpu_torch start --head
--num-gpus 1`` (one declared card, ``RT_GPU_COUNT_OVERRIDE=1``): the
status and node list through the CLI (``tests/test_observability.py:138``),
a job's driver given the head's card, one that needs a real card failing
loudly, and ``stop`` leaving no process of the session.

Marked ``slow`` (``test_zz_*``): every case starts processes.
"""

import json
import os
import signal
import subprocess
import sys
import textwrap
import time

import pytest

import ray_tpu_torch
from ray_tpu_torch.cluster_utils import Cluster
from ray_tpu_torch.job_submission import FAILED, STOPPED, SUCCEEDED, JobSubmissionClient
from test_torch_runtime import runtime_defaults

pytestmark = pytest.mark.slow

REPO = os.path.dirname(os.path.dirname(os.path.abspath(ray_tpu_torch.__file__)))


@pytest.fixture(scope="module")
def job_cluster():
    with runtime_defaults():
        cluster = Cluster(initialize_head=True, connect=False, head_node_args={"num_cpus": 4})
        try:
            yield cluster
        finally:
            cluster.shutdown()


class TestJobSubmission:
    def test_submit_and_succeed(self, job_cluster):
        client = JobSubmissionClient(job_cluster.gcs_address)
        job_id = client.submit_job(entrypoint=f"{sys.executable} -c \"print('job ran ok')\"")
        assert client.wait_until_finished(job_id, timeout=120) == SUCCEEDED
        assert "job ran ok" in client.get_job_logs(job_id)

    def test_driver_connects_to_cluster(self, job_cluster, tmp_path):
        """The job's driver attaches to the cluster it was submitted to
        and runs a task there; it loads neither JAX nor the JAX package."""
        script = tmp_path / "driver.py"
        script.write_text(textwrap.dedent("""
            import os, sys
            sys.path.insert(0, os.environ["RT_REPO"])
            import ray_tpu_torch
            ray_tpu_torch.init(address=os.environ["RT_ADDRESS"])

            @ray_tpu_torch.remote
            def f(x):
                return x * 2

            print("cluster result:", ray_tpu_torch.get(f.remote(21), timeout=60))
            print("foreign:", sorted(m for m in sys.modules if m.split(".")[0] in ("jax", "ray_tpu")))
            ray_tpu_torch.shutdown()
        """))
        client = JobSubmissionClient(job_cluster.gcs_address)
        job_id = client.submit_job(entrypoint=f"{sys.executable} {script}",
                                   runtime_env={"env_vars": {"RT_REPO": REPO}})
        status = client.wait_until_finished(job_id, timeout=180)
        logs = client.get_job_logs(job_id)
        assert status == SUCCEEDED, logs
        assert "cluster result: 42" in logs and "foreign: []" in logs

    def test_failed_job_reports_failed(self, job_cluster):
        client = JobSubmissionClient(job_cluster.gcs_address)
        job_id = client.submit_job(entrypoint=f"{sys.executable} -c 'raise SystemExit(3)'")
        assert client.wait_until_finished(job_id, timeout=120) == FAILED
        assert client.get_job_info(job_id)["returncode"] == 3

    def test_stop_job(self, job_cluster):
        client = JobSubmissionClient(job_cluster.gcs_address)
        job_id = client.submit_job(entrypoint=f"{sys.executable} -c 'import time; time.sleep(600)'")
        assert client.stop_job(job_id)
        assert client.wait_until_finished(job_id, timeout=60) == STOPPED

    def test_working_dir_job(self, job_cluster, tmp_path):
        app = tmp_path / "app"
        app.mkdir()
        (app / "main.py").write_text("print(open('cfg.txt').read())")
        (app / "cfg.txt").write_text("from-working-dir")
        client = JobSubmissionClient(job_cluster.gcs_address)
        job_id = client.submit_job(entrypoint=f"{sys.executable} main.py",
                                   runtime_env={"working_dir": str(app)})
        assert client.wait_until_finished(job_id, timeout=120) == SUCCEEDED
        assert "from-working-dir" in client.get_job_logs(job_id)

    def test_list_jobs(self, job_cluster):
        client = JobSubmissionClient(job_cluster.gcs_address)
        jobs = client.list_jobs()
        assert len(jobs) >= 4
        assert all("status" in j and "entrypoint" in j for j in jobs)


def _cli(args, env, timeout=120):
    return subprocess.run([sys.executable, "-m", "ray_tpu_torch", *args], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=timeout)


def _alive(pid):
    try:
        with open(f"/proc/{pid}/stat") as f:
            return f.read().rsplit(") ", 1)[1].split()[0] != "Z"
    except (FileNotFoundError, IndexError):
        return False


def _session_pids(session_dir):
    """Processes of a CLI session: the GCS, the raylet and their workers
    (each names the session dir on its command line or in its env)."""
    pids = []
    for d in os.listdir("/proc"):
        if not d.isdigit() or int(d) == os.getpid():
            continue
        try:
            with open(f"/proc/{d}/cmdline", "rb") as f:
                cmd = f.read()
            with open(f"/proc/{d}/environ", "rb") as f:
                env = f.read()
        except OSError:
            continue
        if session_dir.encode() in cmd or f"RT_SESSION_DIR={session_dir}".encode() in env:
            pids.append(int(d))
    return [p for p in pids if _alive(p)]


@pytest.fixture(scope="module")
def cli_head(tmp_path_factory):
    """A head started by the CLI with one declared card, in a temp dir of
    its own (so its session file is this module's); stopped at the end."""
    with runtime_defaults():
        env = {k: v for k, v in os.environ.items() if k not in ("PYTHONPATH", "CUDA_VISIBLE_DEVICES")}
        env["TMPDIR"] = str(tmp_path_factory.mktemp("cli"))
        env["RT_GPU_COUNT_OVERRIDE"] = "1"
        out = _cli(["start", "--head", "--num-cpus", "2", "--num-gpus", "1"], env)
        assert out.returncode == 0, out.stderr
        with open(os.path.join(env["TMPDIR"], "ray_tpu_torch", "latest_cli_session.json")) as f:
            session = json.load(f)
        try:
            yield env, session, out.stdout
        finally:
            for pid in [session["gcs_pid"], *session["raylet_pids"]]:
                if _alive(pid):
                    os.kill(pid, signal.SIGKILL)


class TestCli:
    def test_status_and_list_nodes(self, cli_head):
        """``status`` and ``list nodes`` through the CLI show the head's
        card; neither loads torch."""
        env, session, started = cli_head
        assert "ray_tpu_torch head started" in started and "GPUs:        1 (cards: 0)" in started
        addr = session["gcs_address"]
        code = ("import runpy, sys; sys.argv = ['ray_tpu_torch', 'status', '--address', %r]; "
                "runpy.run_module('ray_tpu_torch', run_name='__main__'); "
                "print('loaded:', sorted(m for m in ('torch', 'jax') if m in sys.modules))" % addr)
        out = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env, capture_output=True,
                             text=True, timeout=120)
        assert out.returncode == 0, out.stderr
        assert "cluster status" in out.stdout and "0/1 GPU" in out.stdout and "0/2 CPU" in out.stdout
        assert "loaded: []" in out.stdout
        out = _cli(["list", "nodes"], env)  # the address from the session file
        assert out.returncode == 0, out.stderr
        rows = json.loads(out.stdout)
        assert len(rows) == 1 and rows[0]["alive"] and rows[0]["resources_total"]["GPU"] == 1.0

    def test_job_driver_sees_the_heads_card(self, cli_head):
        """The head's card reaches a job's driver (the control plane sees
        none); a driver that needs a real card fails, loudly, in its log."""
        env, session, _ = cli_head
        client = JobSubmissionClient(session["gcs_address"])
        job = client.submit_job(entrypoint=f"{sys.executable} -c \"import os; "
                                           f"print('visible', os.environ['CUDA_VISIBLE_DEVICES'])\"")
        assert client.wait_until_finished(job, timeout=120) == SUCCEEDED
        assert "visible 0" in client.get_job_logs(job)
        needs_card = ("import torch; assert torch.cuda.is_available(), "
                      "'no CUDA device for the job driver'; print('ran on', torch.cuda.get_device_name(0))")
        job = client.submit_job(entrypoint=f"{sys.executable} -c \"{needs_card}\"")
        status = client.wait_until_finished(job, timeout=120)
        logs = client.get_job_logs(job)
        if status == SUCCEEDED:  # a host with a card
            assert "ran on" in logs
        else:
            assert status == FAILED and "no CUDA device for the job driver" in logs

    def test_stop_leaves_no_process(self, cli_head):
        env, session, _ = cli_head
        assert _session_pids(session["session_dir"])
        out = _cli(["stop"], env)
        assert out.returncode == 0, out.stderr
        assert "stopped 2 control-plane processes" in out.stdout
        deadline = time.monotonic() + 30
        while _session_pids(session["session_dir"]) and time.monotonic() < deadline:
            time.sleep(0.2)
        assert not _session_pids(session["session_dir"])
        assert not os.path.exists(os.path.join(env["TMPDIR"], "ray_tpu_torch", "latest_cli_session.json"))
        assert _cli(["stop"], env).returncode != 0  # no session left to stop
