"""Command-line programs, each run once on ``ray_tpu`` and once on
``ray_tpu_torch`` (tests/test_torch_cli.py).

Every program takes the package module (``rt``) and drives that
package's CLI, ``python -m <package>.scripts.cli``, as the JAX package's
tests do (tests/test_cli_start.py, the CLI tests of test_ops_shell.py
and test_dashboard_logs.py), so the same code runs on both. A program
returns what a user reads off the CLI: exit codes, whether a line names
what it should. Nothing here imports either package at module level.
"""

from __future__ import annotations

import importlib
import json
import os
import socket
import subprocess
import sys
import tempfile
import time

from torch_ops_programs import _until

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TESTS = os.path.join(REPO, "tests")


def env(**extra) -> dict:
    """This process's environment with the repo and the tests on the
    import path; the JAX package's CLI on the CPU."""
    out = dict(os.environ, JAX_PLATFORMS="cpu", **extra)
    out["PYTHONPATH"] = os.pathsep.join(
        [REPO, TESTS] + [p for p in os.environ.get("PYTHONPATH", "")
                         .split(os.pathsep) if p])
    return out


def cli(rt, *args, timeout: float = 120.0, **extra_env
        ) -> subprocess.CompletedProcess:
    """``python -m <package>.scripts.cli ARGS``."""
    return subprocess.run(
        [sys.executable, "-m", f"{rt.__name__}.scripts.cli", *args],
        env=env(**extra_env), capture_output=True, text=True,
        timeout=timeout, cwd=REPO)


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _end(*procs) -> None:
    for p in procs:
        if p is not None and p.poll() is None:
            p.terminate()
            try:
                p.wait(timeout=15)
            except subprocess.TimeoutExpired:
                p.kill()
                p.wait()


def start_head(rt, info: str, *args, **extra_env) -> subprocess.Popen:
    """``cli start --head`` on a free port, its info file at ``info``;
    returns once the file is there."""
    head = subprocess.Popen(
        [sys.executable, "-m", f"{rt.__name__}.scripts.cli", "start",
         "--head", "--num-cpus", "2", "--port", str(free_port()),
         "--host", "127.0.0.1", "--head-info-file", info, *args],
        env=env(**extra_env), stdout=subprocess.DEVNULL,
        stderr=subprocess.DEVNULL, cwd=REPO)
    try:
        _until(lambda: os.path.exists(info) or head.poll() is not None,
               90, "the head's info file")
    except BaseException:
        _end(head)
        raise
    if head.poll() is not None:
        raise RuntimeError(f"the head exited {head.returncode}")
    return head


_CLIENT = """\
import importlib, sys, time
rt = importlib.import_module(sys.argv[1])
rt.init(address=sys.argv[2], cluster_token=sys.argv[3])
deadline = time.monotonic() + 60
while time.monotonic() < deadline:
    if rt.cluster_resources().get("CPU", 0) >= 5:
        break
    time.sleep(0.3)
assert rt.cluster_resources()["CPU"] >= 5


@rt.remote
def f():
    return 7


assert rt.get(f.remote(), timeout=60) == 7
rt.shutdown()
print("CLIENT_OK")
"""


def start_join_stop(rt):
    """tests/test_cli_start.py: a head started by ``cli start --head``
    writes its info file 0600; a node joins with ``cli start --address``;
    a client sees both nodes' CPUs and runs a task; the targeted ``cli
    stop --head-info-file`` ends the head and removes its file."""
    with tempfile.TemporaryDirectory() as d:
        info = os.path.join(d, "head_info.json")
        head = start_head(rt, info)
        node = None
        try:
            with open(info) as f:
                hi = json.load(f)
            mode = os.stat(info).st_mode & 0o777
            node = subprocess.Popen(
                [sys.executable, "-m", f"{rt.__name__}.scripts.cli",
                 "start", "--address", hi["tcp_address"], "--num-cpus",
                 "3", "--head-info-file", info],
                env=env(), stdout=subprocess.DEVNULL,
                stderr=subprocess.DEVNULL, cwd=REPO)
            client = subprocess.run(
                [sys.executable, "-c", _CLIENT, rt.__name__,
                 hi["client_address"], hi["token"]],
                env=env(), capture_output=True, text=True, timeout=240,
                cwd=REPO)
            stop = cli(rt, "stop", "--head-info-file", info, timeout=60)
            head_rc = head.wait(timeout=60)
            gone = _until(lambda: not os.path.exists(info), 30,
                          "the info file removed")
        finally:
            _end(node, head)
    return [oct(mode), client.returncode, "CLIENT_OK" in client.stdout,
            "1 session(s) signaled" in stop.stdout, head_rc, gone]


def status_and_list(rt):
    """tests/test_ops_shell.py:129: ``cli status`` and ``cli list tasks``
    against a live session."""
    rt.init(num_cpus=2)

    @rt.remote
    def touch():
        return 1

    rt.get(touch.remote())
    addr = rt.client_address()
    status = cli(rt, "status", "--address", addr)
    listed = cli(rt, "list", "tasks", "--address", addr)
    rows = json.loads(listed.stdout) if listed.returncode == 0 else []
    return [status.returncode, "nodes: 1 alive" in status.stdout,
            listed.returncode, any(r["name"] == "touch" for r in rows)]


def doctor(rt):
    """tests/test_ops_shell.py:155: ``cli doctor`` runs and names the
    package (it fails nothing without a card)."""
    out = cli(rt, "doctor", timeout=180)
    return [out.returncode, f"{rt.__name__} " in out.stdout]


def job_subcommands(rt):
    """tests/test_ops_shell.py:326: ``job list|status|logs|stop``
    against a live session."""
    rt.init(num_cpus=2)
    js = __import__(f"{rt.__name__}.job_submission",
                    fromlist=["JobSubmissionClient"])
    c = js.JobSubmissionClient()
    sid = c.submit_job(entrypoint="python -c 'print(6*7)'")
    status = c.wait_until_finished(sid, timeout=120)
    addr = rt.client_address()
    outs = [cli(rt, "job", "list", "--address", addr),
            cli(rt, "job", "status", "--address", addr, sid),
            cli(rt, "job", "logs", "--address", addr, sid),
            cli(rt, "job", "stop", "--address", addr, sid)]
    return [str(status), [o.returncode for o in outs],
            sid in outs[0].stdout, "SUCCEEDED" in outs[1].stdout,
            "42" in outs[2].stdout, "not running" in outs[3].stdout]


def job_submit_attaches(rt):
    """tests/test_ops_shell.py:355: ``job submit --no-wait`` attaches to
    the live session, whose client then sees the job and its logs."""
    rt.init(num_cpus=2)
    out = cli(rt, "job", "submit", "--address", rt.client_address(),
              "--no-wait", "--", "echo", "attached")
    sid = out.stdout.split("submitted job ")[1].split(":")[0]
    js = __import__(f"{rt.__name__}.job_submission",
                    fromlist=["JobSubmissionClient"])
    c = js.JobSubmissionClient()
    status = c.wait_until_finished(sid, timeout=120)
    return [out.returncode, str(status), "attached" in c.get_job_logs(sid)]


def logs_subcommand(rt):
    """tests/test_dashboard_logs.py:131: ``cli logs`` lists the session's
    worker logs and ``cli logs <file>`` prints one; the file of the task
    that printed carries its line."""
    rt.init(num_cpus=2)

    @rt.remote
    def noisy2():
        print("cli logs marker", flush=True)
        return 1

    assert rt.get(noisy2.remote(), timeout=60) == 1
    addr = rt.client_address()
    listed = cli(rt, "logs", "--address", addr)
    names = [ln.split()[0] for ln in listed.stdout.splitlines()
             if ".log" in ln]

    def marked():
        return any("cli logs marker" in cli(rt, "logs", n, "--address",
                                            addr).stdout for n in names)
    first = cli(rt, "logs", names[0], "--address", addr) if names else None
    return [listed.returncode, bool(names),
            first.returncode if first else None,
            bool(_until(marked, 30, "the marker in a worker log", 0.5))]


def read_only_subcommands(rt):
    """``alerts``, ``memory``, ``stack``, ``profile``, ``summary``,
    ``traces``, ``trace`` (an unknown id), ``timeline``, ``metrics`` and
    ``usage`` against a live session: their exit codes and what they
    write."""
    rt.init(num_cpus=2)

    @rt.remote
    def work(x):
        return x

    assert rt.get([work.remote(i) for i in range(3)]) == [0, 1, 2]
    addr = rt.client_address()
    with tempfile.TemporaryDirectory() as d:
        tl, prof = os.path.join(d, "tl.json"), os.path.join(d, "p.json")
        outs = {
            "alerts": cli(rt, "alerts", "--address", addr),
            "memory": cli(rt, "memory", "--address", addr, "--json"),
            "stack": cli(rt, "stack", "head", "--address", addr),
            "profile": cli(rt, "profile", "head", "--address", addr,
                           "--duration", "0.5", "-o", prof),
            "summary": cli(rt, "summary", "--address", addr),
            "traces": cli(rt, "traces", "--address", addr, "--json"),
            "trace": cli(rt, "trace", "0" * 16, "--address", addr),
            "timeline": cli(rt, "timeline", "--address", addr, "-o", tl),
            "metrics": cli(rt, "metrics", "--address", addr),
            "usage": cli(rt, "usage", "--address", addr)}
        with open(tl) as f:
            timeline = json.load(f)
        with open(prof) as f:
            speedscope = json.load(f)
    summary = json.loads(outs["summary"].stdout)
    return [{k: v.returncode for k, v in outs.items()},
            sorted(json.loads(outs["memory"].stdout)),
            "==== head" in outs["stack"].stdout,
            speedscope["$schema"].startswith("https://www.speedscope.app"),
            summary["tasks"]["work"]["FINISHED"],
            json.loads(outs["traces"].stdout) == [],
            "unknown trace" in outs["trace"].stderr,
            isinstance(timeline, list) and len(timeline) > 0,
            "# TYPE" in outs["metrics"].stdout]


def serve_deploy_status_and_up(rt):
    """``serve deploy`` of a YAML config and ``serve status`` against a
    live session; ``up --validate`` of a cluster config (the fake
    provider, a card-less head on a free port) brought up and down."""
    rt.init(num_cpus=4)
    addr = rt.client_address()
    with tempfile.TemporaryDirectory() as d:
        cfg = os.path.join(d, "serve.yaml")
        with open(cfg, "w") as f:
            f.write("applications:\n"
                    "  - name: echo\n"
                    "    route_prefix: /echo\n"
                    f"    import_path: torch_cli_serve_apps:echo_"
                    f"{rt.__name__}\n")
        deploy = cli(rt, "serve", "deploy", cfg, "--address", addr,
                     timeout=240)
        status = cli(rt, "serve", "status", "--address", addr)
        handle = importlib.import_module(
            f"{rt.__name__}.serve").get_deployment_handle("Echo")
        answer = handle.remote(5).result(timeout_s=60)
        cluster = os.path.join(d, "cluster.json")
        with open(cluster, "w") as f:
            json.dump({"cluster_name": "cli-test",
                       "provider": {"type": "fake"},
                       "head": {"port": free_port(), "num_cpus": 1},
                       "node_types": {"cpu": {"resources": {"CPU": 1},
                                              "min_workers": 0,
                                              "max_workers": 1}}}, f)
        up = cli(rt, "up", cluster, "--validate", timeout=180)
    deployments = json.loads(status.stdout).get("deployments", {}) \
        if status.returncode == 0 else {}
    return [deploy.returncode, "deployed 1 application(s): echo"
            in deploy.stdout, status.returncode,
            {k: v["status"] for k, v in deployments.items()},
            answer, up.returncode, "validated" in up.stdout]


TABLE = {f.__name__: f for f in (
    start_join_stop, status_and_list, doctor, job_subcommands,
    job_submit_attaches, logs_subcommand, read_only_subcommands,
    serve_deploy_status_and_up)}

# What each program must give (the same on both packages, and right).
EXPECTED = {
    "start_join_stop": ["0o600", 0, True, True, 0, True],
    "status_and_list": [0, True, 0, True],
    "doctor": [0, True],
    "job_subcommands": ["SUCCEEDED", [0, 0, 0, 0], True, True, True, True],
    "job_submit_attaches": [0, "SUCCEEDED", True],
    "logs_subcommand": [0, True, 0, True],
    "read_only_subcommands": [
        {"alerts": 0, "memory": 0, "stack": 0, "profile": 0, "summary": 0,
         "traces": 0, "trace": 1, "timeline": 0, "metrics": 0, "usage": 1},
        ["nodes", "top_objects", "totals", "ts"], True, True, 3, True, True,
        True, True],
    "serve_deploy_status_and_up": [0, True, 0, {"Echo": "HEALTHY"},
                                   {"echo": 5}, 0, True],
}


def run(program, rt, *args) -> tuple:
    """("ok", result) or ("raised", class name, message)."""
    try:
        return ("ok", program(rt, *args))
    except Exception as e:  # noqa: BLE001 — compared across packages
        return ("raised", type(e).__name__, str(e))
    finally:
        if rt.is_initialized():
            rt.shutdown()


SESSIONS = "ray_tpu_torch_sessions"
SOCKET_TAIL = "/4194304/runtime.sock"


def short_tmp_parent() -> str:
    """The temporary directory, or /tmp where a directory made in it
    would be too long for the port's session root there (AF_UNIX's
    108 bytes)."""
    base = tempfile.gettempdir()
    probe = os.path.join(base, "rttXXXXXXXX", SESSIONS)
    return base if len(probe) + len(SOCKET_TAIL) < 108 else "/tmp"


def both_packages_stop(tmp: str) -> dict:
    """One head of each package on this host; the port's bare ``cli
    stop`` (every session it finds) signals its own head only. The
    port's sessions live under ``tmp`` (its ``TMPDIR``), so the bare
    stop reaches no other test's session; the JAX package's head is
    stopped by its own CLI, targeted."""
    import ray_tpu
    import ray_tpu_torch
    if len(os.path.join(tmp, SESSIONS)) + len(SOCKET_TAIL) >= 108:
        # The port would keep these sessions in the shared /tmp root
        # (core/runtime.py session_root), where a bare stop reaches
        # every session of the host.
        raise ValueError(f"{tmp} is too long for a private session root")
    jax_info = os.path.join(tmp, "jax_head.json")
    port_info = os.path.join(tmp, "port_head.json")
    jax_head = start_head(ray_tpu, jax_info)
    port_head = None
    try:
        port_head = start_head(ray_tpu_torch, port_info, TMPDIR=tmp)
        stop = cli(ray_tpu_torch, "stop", timeout=60, TMPDIR=tmp)
        port_rc = port_head.wait(timeout=60)
        time.sleep(1.0)
        jax_alive = jax_head.poll() is None
        jax_stop = cli(ray_tpu, "stop", "--head-info-file", jax_info,
                       timeout=60)
        jax_rc = jax_head.wait(timeout=60)
    finally:
        _end(port_head, jax_head)
    return {"stop": stop.stdout, "port_rc": port_rc,
            "jax_alive": jax_alive, "jax_stop": jax_stop.stdout,
            "jax_rc": jax_rc}


def gpt2_cli_job(rt, init: str) -> dict:
    """tests/test_torch_jobs.py's GPT-2 job (tests/torch_ops_programs.py
    ``gpt2_job_task``: GPT-2 tiny, float32, two AdamW steps from the JAX
    package's initialisation), submitted with ``cli job submit`` to a
    live session; its line read off the CLI's output."""
    from torch_ops_programs import _GPT2_ENTRY
    rt.init(num_cpus=2)
    with tempfile.TemporaryDirectory() as d:
        entry = os.path.join(d, "entry.py")
        with open(entry, "w") as f:
            f.write(_GPT2_ENTRY)
        out = cli(rt, "job", "submit", "--address", rt.client_address(),
                  "--", sys.executable, entry, rt.__name__, init,
                  timeout=600)
    line = [x for x in out.stdout.splitlines() if x.startswith("JOB")]
    return {"rc": out.returncode,
            "finished": " finished: SUCCEEDED" in out.stdout,
            "out": json.loads(line[-1][3:]) if line else None,
            "logs": out.stdout[-3000:] + out.stderr[-3000:]}
