"""The container runtime_env (``runtime_env/plugins.py``
``ContainerPlugin``) against the JAX package's.

The four tests of tests/test_runtime_env_container.py run as programs on
both packages, through the same fake runner (it records its argv and
execs the wrapped worker command), and their outcomes are compared
exactly: validation errors, a missing runner refused with
``RuntimeEnvSetupError``, the context's argv prefix, and a worker booted
through the runner with its environment forwarded (a plain task not).

Beyond the JAX package: a worker that holds a (logical) card gets the
runner's flag that exposes the host's cards and its
``CUDA_VISIBLE_DEVICES`` forwarded, with the host's id; a CPU worker's
forwarded ``CUDA_VISIBLE_DEVICES`` is empty and it gets no flag; docker
gets ``--gpus=all``, any other runner a CDI device.
"""

from __future__ import annotations

import importlib
import json
import os
import stat
import sys

import pytest
import torch

import torch_ops_programs
from torch_parity import table_run

PACKAGES = ("ray_tpu", "ray_tpu_torch")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(autouse=True, scope="module")
def _no_process_left():
    yield
    assert torch_ops_programs.processes_left() == []


def fake_runner(tmp_path, name: str = "fake_podman"):
    """tests/test_runtime_env_container.py's runner, recording the whole
    argv as well."""
    marker = tmp_path / "containers_ran.jsonl"
    script = tmp_path / name
    script.write_text(f"""#!{sys.executable}
import json, os, sys
args = sys.argv[1:]
assert args[0] == "run", args
i = 1
while i < len(args):
    a = args[i]
    if a in ("-v", "--env", "-e"):
        i += 2
        continue
    if a.startswith("-"):
        i += 1
        continue
    break
image, cmd = args[i], args[i + 1:]
env_fwd = [a for a in args[:i] if a.startswith("--env=")]
with open({str(marker)!r}, "a") as f:
    f.write(json.dumps({{"image": image, "pid": os.getpid(),
                         "env_fwd": env_fwd, "argv": args}}) + "\\n")
os.execvp(cmd[0], cmd)
""")
    script.chmod(script.stat().st_mode | stat.S_IXUSR)
    return str(script), marker


def validation_errors(rt, tmp_path):
    plugins = importlib.import_module(f"{rt.__name__}.runtime_env.plugins")
    p = plugins.ContainerPlugin()
    out = []
    for bad in ("just-an-image-string", {"run_options": []},
                {"image": "x", "run_options": [1, 2]}):
        try:
            p.validate(bad)
            out.append("accepted")
        except ValueError:
            out.append("ValueError")
    p.validate({"image": "x", "run_options": ["--cpus=2"]})
    return out


def missing_runner_fails_fast(rt, tmp_path):
    plugins = importlib.import_module(f"{rt.__name__}.runtime_env.plugins")
    exc = importlib.import_module(f"{rt.__name__}.core.exceptions")
    os.environ.pop("RAY_TPU_CONTAINER_RUNNER", None)
    try:
        plugins.build_runtime_env({"container": {"image": "busybox"}})
    except exc.RuntimeEnvSetupError as e:
        return ["RuntimeEnvSetupError", "podman" in str(e)]
    return ["built"]


def context_prefix_env_var(rt, tmp_path):
    plugins = importlib.import_module(f"{rt.__name__}.runtime_env.plugins")
    runner, _ = fake_runner(tmp_path)
    os.environ["RAY_TPU_CONTAINER_RUNNER"] = runner
    ctx = plugins.build_runtime_env({"container": {
        "image": "img:1", "run_options": ["--cpus=2"]}})
    prefix = json.loads(ctx.to_env_vars()["RAY_TPU_CONTAINER_PREFIX"])
    return [prefix[0] == runner, prefix[-1], "--cpus=2" in prefix,
            "--network=host" in prefix]


def worker_boots_through_runner(rt, tmp_path):
    runner, marker = fake_runner(tmp_path)
    os.environ["RAY_TPU_CONTAINER_RUNNER"] = runner
    rt.init(num_cpus=2)

    @rt.remote(runtime_env={"container": {"image": "img:e2e"}})
    def who():
        return os.getpid()

    pid = rt.get(who.remote(), timeout=60)
    ran = [json.loads(ln) for ln in marker.read_text().splitlines()]
    rec = next(r for r in ran if r["image"] == "img:e2e")
    fwd_keys = {a.split("=", 2)[1] for a in rec["env_fwd"]}
    before = len(ran)

    @rt.remote
    def plain():
        return "ok"

    plain_ok = rt.get(plain.remote(), timeout=60) == "ok"
    after = len(marker.read_text().splitlines())
    return [isinstance(pid, int), rec["pid"] == pid,
            "PYTHONPATH" in fwd_keys, "RAY_TPU_WORKER" in fwd_keys,
            plain_ok, after == before]


PROGRAMS = {f.__name__: f for f in (
    validation_errors, missing_runner_fails_fast, context_prefix_env_var,
    worker_boots_through_runner)}
EXPECTED = {
    "validation_errors": ["ValueError"] * 3,
    "missing_runner_fails_fast": ["RuntimeEnvSetupError", True],
    "context_prefix_env_var": [True, "img:1", True, True],
    "worker_boots_through_runner": [True] * 6,
}


def _run(program, rt, tmp_path):
    old = os.environ.get("RAY_TPU_CONTAINER_RUNNER")
    try:
        return ("ok", program(rt, tmp_path))
    except Exception as e:  # noqa: BLE001 — compared across packages
        return ("raised", type(e).__name__, str(e))
    finally:
        if rt.is_initialized():
            rt.shutdown()
        if old is None:
            os.environ.pop("RAY_TPU_CONTAINER_RUNNER", None)
        else:
            os.environ["RAY_TPU_CONTAINER_RUNNER"] = old


@pytest.fixture(scope="module")
def table(tmp_path_factory) -> dict:
    out = {}
    for name in PACKAGES:
        rt = importlib.import_module(name)
        with table_run(name):
            out[name] = {prog: _run(fn, rt, tmp_path_factory.mktemp(
                f"{name}_{prog}")) for prog, fn in PROGRAMS.items()}
    return out


@pytest.mark.parametrize("program", list(PROGRAMS))
def test_program_gives_the_same_result_on_both_packages(table, program):
    jax_out, port_out = (table[name][program] for name in PACKAGES)
    assert jax_out == ("ok", EXPECTED[program]), jax_out
    assert port_out == jax_out


def _card_run(tmp_path, runner_name: str) -> tuple[list, dict, dict]:
    import ray_tpu_torch as rt
    runner, marker = fake_runner(tmp_path, runner_name)
    old = os.environ.get("RAY_TPU_CONTAINER_RUNNER")
    os.environ["RAY_TPU_CONTAINER_RUNNER"] = runner

    def where():
        return {"visible": os.environ.get("CUDA_VISIBLE_DEVICES"),
                "pid": os.getpid()}

    rt.init(num_cpus=2, num_gpus=1)
    try:
        env = {"container": {"image": "img:card"}}
        card = rt.get(rt.remote(num_gpus=1, runtime_env=env)(where).remote(),
                      timeout=120)
        cpu = rt.get(rt.remote(num_cpus=1, runtime_env=env)(where).remote(),
                     timeout=120)
    finally:
        rt.shutdown()
        if old is None:
            os.environ.pop("RAY_TPU_CONTAINER_RUNNER", None)
        else:
            os.environ["RAY_TPU_CONTAINER_RUNNER"] = old
    ran = [json.loads(ln) for ln in marker.read_text().splitlines()]
    return ran, card, cpu


def test_a_card_holders_device_flag_and_ids_reach_the_runner(tmp_path):
    ran, card, cpu = _card_run(tmp_path, "fake_podman")
    by_pid = {r["pid"]: r for r in ran}
    card_argv, cpu_argv = by_pid[card["pid"]]["argv"], by_pid[cpu["pid"]][
        "argv"]
    assert card["visible"] == "0" and cpu["visible"] == ""
    assert "--device=nvidia.com/gpu=all" in card_argv
    assert "--env=CUDA_VISIBLE_DEVICES=0" in card_argv
    assert by_pid[card["pid"]]["image"] == "img:card"
    # The flag sits with the forwards, before the image.
    assert card_argv.index("--device=nvidia.com/gpu=all") < \
        card_argv.index("img:card")
    assert not any(a.startswith(("--device", "--gpus")) for a in cpu_argv)
    assert "--env=CUDA_VISIBLE_DEVICES=" in cpu_argv


def test_docker_gets_its_gpus_flag(tmp_path):
    from ray_tpu_torch.runtime_env.plugins import card_flags
    assert card_flags("/usr/bin/docker") == ["--gpus=all"]
    assert card_flags("podman") == ["--device=nvidia.com/gpu=all"]
    ran, card, _ = _card_run(tmp_path, "docker")
    argv = next(r["argv"] for r in ran if r["pid"] == card["pid"])
    assert "--gpus=all" in argv and "--env=CUDA_VISIBLE_DEVICES=0" in argv


def test_the_spawn_forwards_the_cards_variables():
    from ray_tpu_torch.core.runtime import CONTAINER_ENV_PREFIXES
    assert {"RAY_TPU_", "PYTHON", "CUDA_VISIBLE_DEVICES",
            "NVIDIA_"} <= set(CONTAINER_ENV_PREFIXES)
    assert not {"JAX_", "XLA_", "TPU_"} & set(CONTAINER_ENV_PREFIXES)
