"""The port's job submission (``ray_tpu_torch.job_submission`` and the
dashboard's job REST API) against the JAX package's.

The ``JOBS`` table of tests/torch_ops_programs.py runs once on
``ray_tpu`` and once on ``ray_tpu_torch``, all programs of a package in
one runtime of 4 CPUs: a job that succeeds, one that exits 3 (FAILED,
return code 3), one stopped while it sleeps (STOPPED), the REST API
(``POST /api/jobs`` submits, ``GET`` lists, inspects and tails, ``POST
.../stop`` stops, a body with no entrypoint is a 400, an unknown id a
404), the ``JobDetails`` schema, and an entrypoint that joins its
session with ``init(address="auto")``. Outcomes are compared exactly.
On the port the entrypoint sees no card (``CUDA_VISIBLE_DEVICES=""``):
the supervisor holds no GPU, so the job reaches a card only through
``num_gpus`` tasks of its session.

The slice as a whole: a job submitted over the REST API whose
entrypoint joins the session and runs one task that trains GPT-2 tiny
(float32, AdamW) for two steps from the JAX package's own
initialisation, on each package. The losses it prints are held within
``LOSS_ATOL = 2e-5`` of each other: tests/test_torch_dag_gpt2.py's bound
on a position's log-probability (twice its ``LOGIT_ATOL``, 1e-5), so on
their mean, the first loss; the second, after one AdamW step, is held to
the same bound.
"""

from __future__ import annotations

import os

import numpy as np
import pytest
import torch

import torch_ops_programs as programs

PACKAGES = ("ray_tpu", "ray_tpu_torch")
PROGRAMS = list(programs.JOBS)
LOGIT_ATOL = 1e-5                   # tests/test_torch_dag_gpt2.py's
LOSS_ATOL = 2 * LOGIT_ATOL


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One torch thread for the module, as every test_torch_* file."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(autouse=True, scope="module")
def _no_process_left():
    """Torn down after the module's runtimes: none leaves a worker
    behind."""
    yield
    assert programs.processes_left() == []


@pytest.fixture(scope="module")
def table() -> dict:
    """{package: {program: outcome}}, the JAX package's run first."""
    return {name: programs.run_table(name, programs.JOBS, {"num_cpus": 4})
            for name in PACKAGES}


@pytest.mark.parametrize("program", PROGRAMS)
def test_program_gives_the_same_result_on_both_packages(table, program):
    jax_out, port_out = (table[name][program] for name in PACKAGES)
    assert jax_out[0] == "ok", jax_out
    if program == "job_finds_its_session":
        port_out = ("ok", port_out[1][:2] + [None])
    assert port_out == jax_out


@pytest.mark.parametrize("program", sorted(
    set(PROGRAMS) & set(programs.EXPECTED)))
def test_program_outcome_is_the_expected_one(table, program):
    assert table["ray_tpu_torch"][program] == \
        ("ok", programs.EXPECTED[program])


def test_a_job_succeeds_and_its_logs_carry_its_output(table):
    status, printed, rc, keys = table["ray_tpu_torch"]["job_success"][1]
    assert [status, printed, rc] == ["SUCCEEDED", True, 0]
    assert keys == ["end_time", "entrypoint", "metadata", "return_code",
                    "start_time", "status", "submission_id"]


def test_rest_api_submits_lists_inspects_tails_and_stops(table):
    out = table["ray_tpu_torch"]["jobs_rest_api"][1]
    assert out[:4] == [200, True, "SUCCEEDED", {"k": "v"}]
    assert out[5:8] == [True, [200, {"stopped": True}], "STOPPED"]


def test_rest_api_refuses_a_body_without_entrypoint_and_an_unknown_id(table):
    out = table["ray_tpu_torch"]["jobs_rest_api"][1]
    assert out[8:] == [400, True, 404, True, 404]


def test_job_details_schema(table):
    status, cls, submission, same_id, ended, fields = \
        table["ray_tpu_torch"]["job_details_schema"][1]
    assert [status, cls, submission, same_id, ended] == \
        ["SUCCEEDED", "JobDetails", True, True, True]
    assert "driver_info" in fields and "type" in fields


def test_the_entrypoint_joins_its_session_and_sees_no_card(table):
    assert table["ray_tpu_torch"]["job_finds_its_session"] == \
        ("ok", ["SUCCEEDED", 42, ""])


def _gone(pid: int) -> bool:
    try:
        with open(f"/proc/{pid}/stat") as f:
            return f.read().rsplit(")", 1)[1].split()[0] == "Z"
    except OSError:
        return True


def test_a_stopped_job_leaves_no_process_of_its_own():
    """The entrypoint runs under a shell; stopping the job ends the
    shell's children too, not the shell alone."""
    import sys
    import time

    import ray_tpu_torch as rt
    from ray_tpu_torch.job_submission import JobSubmissionClient
    rt.init(num_cpus=2)
    try:
        c = JobSubmissionClient()
        sid = c.submit_job(entrypoint=(
            f"{sys.executable} -c 'import os, time; "
            f"print(\"PID\", os.getpid(), flush=True); time.sleep(600)'"))
        deadline = time.monotonic() + 60
        pid = None
        while pid is None and time.monotonic() < deadline:
            line = [x for x in c.get_job_logs(sid).splitlines()
                    if x.startswith("PID ")]
            pid = int(line[0].split()[1]) if line else None
            time.sleep(0.1)
        assert pid is not None and not _gone(pid)
        assert c.stop_job(sid)
        assert c.wait_until_finished(sid, timeout=60) == "STOPPED"
        deadline = time.monotonic() + 15
        while not _gone(pid) and time.monotonic() < deadline:
            time.sleep(0.1)
        assert _gone(pid)
    finally:
        rt.shutdown()


def test_init_with_the_dashboard_starts_it_and_shutdown_stops_it():
    import urllib.error
    import urllib.request

    import ray_tpu_torch as rt
    from ray_tpu_torch.core.api import get_runtime
    rt.init(num_cpus=1, include_dashboard=True, dashboard_port=0)
    try:
        dash = get_runtime()._dashboard
        with urllib.request.urlopen(dash.url + "/api/jobs", timeout=30) as r:
            assert r.status == 200
        url = dash.url
    finally:
        rt.shutdown()
    with pytest.raises(urllib.error.URLError):
        urllib.request.urlopen(url + "/api/jobs", timeout=5)


def test_a_dashboard_that_cannot_bind_fails_init():
    import socket

    import ray_tpu_torch as rt
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        s.listen(1)
        port = s.getsockname()[1]
        with pytest.raises(OSError):
            rt.init(num_cpus=1, include_dashboard=True,
                    dashboard_port=port)
    assert not rt.is_initialized()
    assert programs.processes_left() == []


def test_include_dashboard_with_an_address_is_refused():
    import ray_tpu_torch as rt
    with pytest.raises(ValueError, match="include_dashboard"):
        rt.init(address="127.0.0.1:1", include_dashboard=True)


# ----------------------------------------------------------------------
# The slice as a whole
# ----------------------------------------------------------------------

@pytest.fixture(scope="module")
def gpt2_jobs(tmp_path_factory) -> dict:
    """{package: the GPT-2 job's outcome}, both from one saved
    initialisation of the JAX GPT-2 tiny and one batch."""
    jax = pytest.importorskip("jax")
    pytest.importorskip("optax")
    import jax.numpy as jnp

    from ray_tpu.models import GPT2, GPT2Config
    params = GPT2(GPT2Config.tiny(dtype=jnp.float32)).init_params(
        jax.random.key(0))
    flat = {"params/" + "/".join(str(getattr(k, "key", k)) for k in path):
            np.asarray(v)
            for path, v in jax.tree_util.tree_flatten_with_path(params)[0]}
    rng = np.random.default_rng(0)
    toks = rng.integers(0, GPT2Config.tiny().vocab_size, (4, 64)
                        ).astype(np.int32)
    init = str(tmp_path_factory.mktemp("gpt2_job") / "init.npz")
    np.savez(init, tokens=toks, targets=np.roll(toks, -1, 1), **flat)
    out = {}
    for name in PACKAGES:
        rt = __import__(name)
        outcome = programs.run(programs.gpt2_job, rt, init)
        assert outcome[0] == "ok", outcome
        out[name] = outcome[1]
    return out


def test_gpt2_job_succeeds_on_both_packages(gpt2_jobs):
    for name, job in gpt2_jobs.items():
        assert [job["status"], job["return_code"]] == ["SUCCEEDED", 0], \
            (name, job["logs"])
        assert len(job["out"]["losses"]) == programs.GPT2_STEPS
        assert job["out"]["pid"] != os.getpid()


def test_gpt2_job_losses_match_the_jax_package(gpt2_jobs):
    want = gpt2_jobs["ray_tpu"]["out"]["losses"]
    got = gpt2_jobs["ray_tpu_torch"]["out"]["losses"]
    np.testing.assert_allclose(got, want, rtol=0, atol=LOSS_ATOL)
    assert got[1] < got[0]
