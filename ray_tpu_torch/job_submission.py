"""Job submission: run shell entrypoints supervised by an actor.

Reference: JobSubmissionClient (python/ray/dashboard/modules/job/
sdk.py:35), the driver run by a JobSupervisor actor
(job_supervisor.py:53) managed by JobManager (job_manager.py:58). Same
shape here: ``submit_job`` creates a detached zero-CPU supervisor actor
that forks the entrypoint, tails its output to a log buffer, and
reports terminal status.

The supervisor asks for no CPU and no GPU, so its process and the
entrypoint it forks see no card (``CUDA_VISIBLE_DEVICES=""``, as every
worker that holds no GPU). The entrypoint joins the session with
``init(address="auto")`` — the session whose head is its ancestor —
and reaches the card through ``num_gpus`` tasks and actors of that
session, as a Ray job does without ``entrypoint_num_gpus``.
"""

from __future__ import annotations

import time
import uuid
from dataclasses import dataclass, field


class JobStatus:
    PENDING = "PENDING"
    RUNNING = "RUNNING"
    SUCCEEDED = "SUCCEEDED"
    FAILED = "FAILED"
    STOPPED = "STOPPED"

    TERMINAL = (SUCCEEDED, FAILED, STOPPED)


@dataclass
class JobInfo:
    submission_id: str
    entrypoint: str
    status: str
    start_time: float
    end_time: float | None = None
    return_code: int | None = None
    metadata: dict = field(default_factory=dict)


class JobType:
    """(reference: ray.job_submission.JobType) Every job here is a
    SUBMISSION job (driver-discovered jobs are a dashboard-crawler
    concept in the reference)."""

    SUBMISSION = "SUBMISSION"
    DRIVER = "DRIVER"


@dataclass
class DriverInfo:
    """(reference: ray.job_submission.DriverInfo)"""

    id: str
    node_ip_address: str
    pid: str


@dataclass
class JobDetails:
    """The REST-schema view of a job (reference:
    ray.job_submission.JobDetails) — JobInfo plus type/driver info.
    Built via :meth:`JobSubmissionClient.get_job_details`."""

    job_id: str
    submission_id: str
    type: str
    entrypoint: str
    status: str
    start_time: float
    end_time: float | None = None
    metadata: dict = field(default_factory=dict)
    driver_info: DriverInfo | None = None


class _JobSupervisor:
    """Runs IN an actor process; forks the entrypoint and tails it."""

    def __init__(self, entrypoint: str, env_vars: dict | None,
                 working_dir: str | None):
        import os
        import subprocess
        import threading
        self.entrypoint = entrypoint
        self.start_time = time.time()
        self.end_time = None
        self.return_code = None
        self._stopped = False
        self._log_chunks: list[str] = []
        self._log_lock = threading.Lock()
        env = dict(os.environ)
        env.update(env_vars or {})
        # A runtime_env PYTHONPATH (staged working_dir/py_modules)
        # must extend — not replace — the inherited one, or the job
        # loses modules resolvable in the driver's environment.
        staged_pp = (env_vars or {}).get("PYTHONPATH")
        inherited_pp = os.environ.get("PYTHONPATH")
        if staged_pp and inherited_pp:
            env["PYTHONPATH"] = os.pathsep.join(
                [staged_pp, inherited_pp])
        # A session of its own: the shell's children are the job too,
        # and stop() signals them all (the shell alone would leave them
        # running).
        self._proc = subprocess.Popen(
            entrypoint, shell=True, env=env, cwd=working_dir,
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True, start_new_session=True)
        self._tail = threading.Thread(target=self._tail_loop,
                                      daemon=True)
        self._tail.start()

    def _tail_loop(self):
        for line in self._proc.stdout:
            with self._log_lock:
                self._log_chunks.append(line)
        self._proc.wait()
        self.return_code = self._proc.returncode
        self.end_time = time.time()

    def status(self) -> str:
        if self._stopped:
            return JobStatus.STOPPED
        rc = self._proc.poll()
        if rc is None:
            return JobStatus.RUNNING
        # let the tail thread publish return_code
        return JobStatus.SUCCEEDED if rc == 0 else JobStatus.FAILED

    def info(self) -> dict:
        return {
            "status": self.status(),
            "start_time": self.start_time,
            "end_time": self.end_time,
            "return_code": self._proc.poll(),
        }

    def logs(self) -> str:
        with self._log_lock:
            return "".join(self._log_chunks)

    def stop(self) -> None:
        import os
        import signal
        self._stopped = True
        if self._proc.poll() is None:
            self._signal_group(signal.SIGTERM)
            try:
                self._proc.wait(5)
            except Exception:  # noqa: BLE001
                pass
        # The shell may be gone while a child of it runs on.
        self._signal_group(signal.SIGKILL)

    def _signal_group(self, sig) -> None:
        import os
        try:
            os.killpg(self._proc.pid, sig)
        except (ProcessLookupError, PermissionError):
            pass            # the group is gone


_JOBS_NS = "jobs"


class JobSubmissionClient:
    """Submit/inspect/stop jobs against the local runtime.

    The job table lives in internal KV and supervisors are NAMED
    actors, so EVERY client instance — other processes, the
    dashboard's REST endpoints — sees every job (reference: the job
    table lives in the GCS, dashboard/modules/job)."""

    def __init__(self, address: str | None = None):
        import ray_tpu_torch
        if not ray_tpu_torch.is_initialized():
            ray_tpu_torch.init(ignore_reinit_error=True)
        self._ray = ray_tpu_torch
        self._handles: dict[str, object] = {}   # sid -> actor handle

    def _kv(self):
        from ray_tpu_torch.experimental import internal_kv
        return internal_kv

    def _put_info(self, info: "JobInfo") -> None:
        import pickle
        self._kv()._kv_put(b"job:" + info.submission_id.encode(),
                           pickle.dumps(info), namespace=_JOBS_NS)

    def _put_info_if_present(self, info: "JobInfo") -> None:
        """Persist ONLY when the table entry still exists and was not
        tombstoned — a concurrent delete_job must win. The get/put
        pair is not atomic, so delete_job ALSO writes a tombstone:
        even a racing re-put leaves the job invisible (readers filter
        tombstoned ids)."""
        sid = info.submission_id
        key = b"job:" + sid.encode()
        if self._tombstoned(sid):
            return
        if self._kv()._kv_get(key, namespace=_JOBS_NS) is not None:
            self._put_info(info)

    def _tombstoned(self, sid: str) -> bool:
        return self._kv()._kv_get(b"job_deleted:" + sid.encode(),
                                  namespace=_JOBS_NS) is not None

    def _get_info(self, sid: str) -> "JobInfo":
        import pickle
        raw = self._kv()._kv_get(b"job:" + sid.encode(),
                                 namespace=_JOBS_NS)
        if raw is None or self._tombstoned(sid):
            raise ValueError(f"unknown job {sid!r}")
        return pickle.loads(raw)

    def submit_job(self, *, entrypoint: str,
                   submission_id: str | None = None,
                   runtime_env: dict | None = None,
                   metadata: dict | None = None) -> str:
        import ray_tpu_torch
        sid = submission_id or f"raysubmit_{uuid.uuid4().hex[:12]}"
        if self._kv()._kv_get(b"job:" + sid.encode(),
                              namespace=_JOBS_NS) is not None:
            raise ValueError(f"submission_id {sid!r} already exists")
        # Full runtime_env build (staging, plugins, pip gating) —
        # failures surface here at submission time.
        from ray_tpu_torch.runtime_env import build_runtime_env
        ctx = build_runtime_env(runtime_env)
        env_vars = ctx.to_env_vars() or None
        working_dir = ctx.working_dir
        supervisor_cls = ray_tpu_torch.remote(num_cpus=0)(_JobSupervisor)
        handle = supervisor_cls.options(
            name=f"_job_supervisor_{sid}").remote(
                entrypoint, env_vars, working_dir)
        info = JobInfo(submission_id=sid, entrypoint=entrypoint,
                       status=JobStatus.PENDING,
                       start_time=time.time(),
                       metadata=dict(metadata or {}))
        self._handles[sid] = handle
        self._put_info(info)
        return sid

    def _handle(self, sid: str):
        h = self._handles.get(sid)
        if h is None:
            if self._kv()._kv_get(b"job:" + sid.encode(),
                                  namespace=_JOBS_NS) is None:
                raise ValueError(f"unknown job {sid!r}")
            # Another client submitted it: reconnect through the
            # supervisor's well-known actor name.
            h = self._ray.get_actor(f"_job_supervisor_{sid}")
            self._handles[sid] = h
        return h

    def get_job_status(self, submission_id: str) -> str:
        # Through get_job_info: shares its KV fallback, so a job
        # whose supervisor is gone still reports its persisted
        # terminal state instead of raising.
        return self.get_job_info(submission_id).status

    def get_job_info(self, submission_id: str) -> JobInfo:
        info = self._get_info(submission_id)
        if info.status in JobStatus.TERMINAL:
            # KV is authoritative for finished jobs: no supervisor
            # RPC, no redundant rewrite.
            return info
        try:
            handle = self._handle(submission_id)
            d = self._ray.get(handle.info.remote(), timeout=60)
            info.status = d["status"]
            info.end_time = d["end_time"]
            info.return_code = d["return_code"]
            if info.status in JobStatus.TERMINAL:
                self._put_info_if_present(info)
        except Exception as e:  # noqa: BLE001
            from ray_tpu_torch.core.exceptions import ActorDiedError
            if isinstance(e, (ValueError, ActorDiedError)):
                # Supervisor actor permanently gone while the table
                # says non-terminal: the job can never report again —
                # mark it failed (reference: jobs whose supervisor
                # dies are FAILED).
                info.status = JobStatus.FAILED
                info.end_time = info.end_time or time.time()
                self._put_info_if_present(info)
                self._handles.pop(submission_id, None)
            # Transient errors (RPC timeout on a loaded box): return
            # the last known state unchanged — never poison the
            # table over a hiccup.
        return info

    def get_job_details(self, submission_id: str) -> JobDetails:
        """(reference: JobSubmissionClient.get_job_info returning the
        JobDetails REST schema)"""
        info = self.get_job_info(submission_id)
        driver = None
        handle = self._handles.get(submission_id)
        if handle is not None:
            try:
                from ray_tpu_torch.util import get_node_ip_address
                driver = DriverInfo(
                    id=submission_id,
                    node_ip_address=get_node_ip_address(),
                    pid="")
            except Exception:  # noqa: BLE001
                pass
        return JobDetails(
            job_id=submission_id, submission_id=submission_id,
            type=JobType.SUBMISSION, entrypoint=info.entrypoint,
            status=info.status, start_time=info.start_time,
            end_time=info.end_time, metadata=info.metadata,
            driver_info=driver)

    def get_job_logs(self, submission_id: str) -> str:
        try:
            logs = self._ray.get(
                self._handle(submission_id).logs.remote(), timeout=60)
            # Best-effort persistence for after the supervisor dies.
            if self._get_info(submission_id).status in \
                    JobStatus.TERMINAL:
                self._kv()._kv_put(
                    b"job_logs:" + submission_id.encode(),
                    logs[-(1 << 20):].encode("utf-8", "replace"),
                    namespace=_JOBS_NS)
            return logs
        except ValueError:
            # Supervisor gone (or never known here): fall back to the
            # persisted tail — but only for jobs the table knows.
            self._get_info(submission_id)     # raises if unknown
            raw = self._kv()._kv_get(
                b"job_logs:" + submission_id.encode(),
                namespace=_JOBS_NS)
            return (raw or b"").decode("utf-8", "replace")

    def stop_job(self, submission_id: str) -> bool:
        """(reference: JobSubmissionClient.stop_job returns whether a
        stop was actually delivered — False for already-terminal
        jobs)."""
        if self.get_job_status(submission_id) in JobStatus.TERMINAL:
            return False
        self._ray.get(self._handle(submission_id).stop.remote(),
                      timeout=60)
        return True

    def list_jobs(self) -> list[JobInfo]:
        keys = self._kv()._kv_list(b"job:", namespace=_JOBS_NS)
        sids = sorted(k.decode()[len("job:"):] for k in keys)
        out = []
        for sid in sids:
            try:
                out.append(self.get_job_info(sid))
            except ValueError:
                pass            # tombstoned/deleted mid-listing
        return out

    def wait_until_finished(self, submission_id: str,
                            timeout: float = 600,
                            poll_s: float = 0.5) -> str:
        deadline = time.time() + timeout
        while time.time() < deadline:
            st = self.get_job_status(submission_id)
            if st in JobStatus.TERMINAL:
                return st
            time.sleep(poll_s)
        raise TimeoutError(
            f"job {submission_id} not finished after {timeout}s")

    def delete_job(self, submission_id: str) -> bool:
        try:
            handle = self._handle(submission_id)
            self._ray.kill(handle)
        except Exception:  # noqa: BLE001
            pass
        self._handles.pop(submission_id, None)
        # Tombstone FIRST: a reader racing the delete may re-put the
        # info entry, but tombstoned ids stay invisible forever.
        self._kv()._kv_put(b"job_deleted:" + submission_id.encode(),
                           b"1", namespace=_JOBS_NS)
        self._kv()._kv_del(b"job:" + submission_id.encode(),
                           namespace=_JOBS_NS)
        self._kv()._kv_del(b"job_logs:" + submission_id.encode(),
                           namespace=_JOBS_NS)
        return True


__all__ = ["JobSubmissionClient", "JobStatus", "JobInfo"]
