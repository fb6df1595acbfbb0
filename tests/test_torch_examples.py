"""The port's examples (``ray_tpu_torch/examples/``, the counterparts of
the repo's ``examples/``) run on the CPU and exit 0.

Each runs as ``python -m ray_tpu_torch.examples.<name>`` in a process of
its own, as a user runs it; those that put a model on the card by
default (``train_gpt2_mesh`` and the RLlib learners) are given
``--device cpu``, ``serve_compose`` a free port. Without a card and
without ``--device cpu``, ``train_gpt2_mesh`` raises rather than fall
back to the CPU.
"""

from __future__ import annotations

import os
import re
import socket
import subprocess
import sys

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _free_port() -> str:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return str(s.getsockname()[1])


# name: (arguments, a line its output must carry)
EXAMPLES = {
    "core_tasks_actors": ([], r"^count: 10$"),
    "data_pipeline": ([], r"^count: 50$"),
    "cpp_tasks": ([], r"^running mean = 2\.0$"),
    "serve_compose": (["--http-port", "PORT"], r"'dims': 2"),
    "tune_asha": ([], r"^best lr: 0\.3 "),
    "tune_classic": ([], r"^best lr: 0\.4 "),
    "workflow_events": ([], r"^resumed = 34$"),
    "rllib_ppo": (["--device", "cpu"], r"^iter 9: reward_mean="),
    "rllib_dreamer": (["--device", "cpu"], r"^iter 5: wm_loss="),
    "train_gpt2_mesh": (["--device", "cpu"], r"^step 4: loss=\d"),
}


def _run(name: str, args: list[str]) -> subprocess.CompletedProcess:
    args = [_free_port() if a == "PORT" else a for a in args]
    env = dict(os.environ, PYTHONPATH=REPO, CUDA_VISIBLE_DEVICES="",
               OMP_NUM_THREADS="1")
    return subprocess.run(
        [sys.executable, "-m", f"ray_tpu_torch.examples.{name}", *args],
        cwd=REPO, env=env, capture_output=True, text=True, timeout=300)


def test_every_example_of_the_repo_is_ported():
    ours = {f[:-3] for f in os.listdir(os.path.join(
        REPO, "ray_tpu_torch", "examples")) if f.endswith(".py")}
    theirs = {f[:-3] for f in os.listdir(os.path.join(REPO, "examples"))
              if f.endswith(".py")}
    assert theirs == set(EXAMPLES) == ours - {"__init__"}


@pytest.mark.parametrize("name", sorted(EXAMPLES))
def test_example_runs_on_the_cpu(name):
    args, marker = EXAMPLES[name]
    out = _run(name, args)
    assert out.returncode == 0, out.stderr[-3000:]
    assert re.search(marker, out.stdout, re.M), out.stdout[-3000:]


def test_the_gpt2_example_needs_a_card_unless_asked_for_the_cpu():
    out = _run("train_gpt2_mesh", [])
    assert out.returncode != 0
    assert "no CUDA device" in out.stderr
    assert "step 0" not in out.stdout
