"""Card-only tests of phase 22 at a small depth: a job submitted over
the dashboard's REST API whose entrypoint trains GPT-2 on the card in a
``num_gpus=1`` task, and a node that the autoscaler brings up for a
pending ``num_gpus=1`` task, holding the card.

GPT-2 at GPT-2 small's width with 4 blocks. Marked ``cuda``: run on the
card with

    python -m pytest --noconftest -m cuda tests/test_torch_cuda_jobs.py

It skips, from inside each test, where no card is visible.
"""

from __future__ import annotations

import json
import os
import sys
import tempfile
import time

import numpy as np
import pytest
import torch

pytestmark = pytest.mark.cuda

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
N_LAYER = 4
ENTRY = """\
import json, os, sys
import ray_tpu_torch as rt


def train(steps):
    import chip_smoke
    from ray_tpu_torch.models import GPT2, GPT2Config
    cfg = GPT2Config.small(n_layer=%d)
    model = GPT2(cfg, seed=0)
    run = chip_smoke.gpt2_steps(model, chip_smoke.train_batch(
        cfg.vocab_size, 8, 1024), steps, 0, True)
    return {"losses": run["losses"], "counts": run["counts"],
            "compile_count": run["compile_count"],
            "uuid": chip_smoke.card_uuid(model.wte.weight.device),
            "visible": os.environ.get("CUDA_VISIBLE_DEVICES")}


rt.init(address="auto")
out = rt.get(rt.remote(num_gpus=1)(train).remote(2), timeout=600)
out["entry_visible"] = os.environ.get("CUDA_VISIBLE_DEVICES")
print("JOB" + json.dumps(out), flush=True)
""" % N_LAYER


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: run with -m cuda on the card")


def test_a_jobs_gpu_task_trains_on_the_card():
    _card()
    import chip_smoke
    import ray_tpu_torch as rt
    from ray_tpu_torch.core.api import get_runtime
    from ray_tpu_torch.models import GPT2, GPT2Config
    from ray_tpu_torch.ops.cuda import build

    build.ensure_built()
    cfg = GPT2Config.small(n_layer=N_LAYER)
    want = chip_smoke.gpt2_steps(
        GPT2(cfg, seed=0), chip_smoke.train_batch(cfg.vocab_size, 8, 1024),
        2, 0, True)["losses"]
    uuid = chip_smoke.card_uuid(torch.device("cuda", 0))
    torch.cuda.empty_cache()
    rt.init(include_dashboard=True, dashboard_port=0)
    try:
        url = get_runtime()._dashboard.url
        with tempfile.TemporaryDirectory() as d:
            entry = os.path.join(d, "entry.py")
            with open(entry, "w") as f:
                f.write(ENTRY)
            code, sub = chip_smoke.http_json(f"{url}/api/jobs", {
                "entrypoint": f"{sys.executable} {entry}",
                "runtime_env": {"env_vars": {"PYTHONPATH": ROOT}}})
            assert code == 200
            info = chip_smoke.job_status(url, sub["submission_id"], 600)
            logs = chip_smoke.http_json(
                f"{url}/api/jobs/{sub['submission_id']}/logs")[1]["logs"]
        assert [info["status"], info["return_code"]] == ["SUCCEEDED", 0], \
            logs[-3000:]
        out = json.loads([x for x in logs.splitlines()
                          if x.startswith("JOB")][-1][3:])
    finally:
        rt.shutdown()
    assert out["entry_visible"] == ""
    assert out["uuid"] == uuid
    np.testing.assert_allclose(out["losses"], want,
                               rtol=chip_smoke.CAPTURE_LOSS_RTOL)
    assert out["compile_count"] == 1
    for name in chip_smoke.SQUARE:
        assert out["counts"][name] == 2 * N_LAYER


def test_the_autoscaler_brings_up_a_node_holding_the_card():
    _card()
    import chip_smoke
    import ray_tpu_torch as rt
    from ray_tpu_torch.autoscaler import (
        Autoscaler,
        AutoscalerConfig,
        NodeTypeConfig,
    )
    from ray_tpu_torch.autoscaler.fake_provider import FakeMultiNodeProvider
    from ray_tpu_torch.cluster_utils import Cluster
    from ray_tpu_torch.core.accelerator import node_gpu_ids
    from ray_tpu_torch.core.api import get_runtime
    from ray_tpu_torch.core.config import env_overrides
    from ray_tpu_torch.models import GPT2, GPT2Config
    from ray_tpu_torch.ops.cuda import build

    build.ensure_built()
    cfg = GPT2Config.small(n_layer=N_LAYER)
    tokens = np.random.default_rng(0).integers(
        0, cfg.vocab_size, (2, 1024)).astype(np.int32)
    ref = chip_smoke.gpt2_reduction(GPT2(cfg, seed=0), tokens)
    torch.cuda.empty_cache()

    def forward(tokens):
        import chip_smoke
        from ray_tpu_torch.models import GPT2, GPT2Config
        from ray_tpu_torch.ops.cuda import flash_attention as fa
        model = GPT2(GPT2Config.small(n_layer=N_LAYER), seed=0)
        fa.reset_launch_counts()
        out = chip_smoke.gpt2_reduction(model, tokens)
        return {**out, "counts": fa.launch_counts(),
                "visible": os.environ.get("CUDA_VISIBLE_DEVICES")}

    gpu_id = node_gpu_ids(1)[0]
    with env_overrides(idle_worker_ttl_s=1.0):
        c = Cluster(head_node_args={"num_cpus": 1, "num_gpus": 0})
        try:
            provider = FakeMultiNodeProvider(c)
            asc = Autoscaler(AutoscalerConfig(
                node_types=[NodeTypeConfig("h100", {"CPU": 1, "GPU": 1},
                                           0, 1)],
                idle_timeout_s=1.0, update_interval_s=0.2), provider,
                get_runtime())
            asc.start()
            try:
                out = rt.get(rt.remote(num_gpus=1)(forward).remote(tokens),
                             timeout=600)
                node = provider.non_terminated_nodes()[0].node_id
                daemon = chip_smoke.daemon_pid(c, node)
                assert sorted(get_runtime()._nodes[node].cards) == [gpu_id]
                assert chip_smoke.process_env(
                    daemon, "CUDA_VISIBLE_DEVICES") == gpu_id
                # (The provider forgets a node before its daemon exits.)
                deadline = time.monotonic() + 120
                while (provider.non_terminated_nodes()
                       or not asc.terminated_total) and \
                        time.monotonic() < deadline:
                    time.sleep(0.2)
                assert not provider.non_terminated_nodes()
                assert asc.launched_total == asc.terminated_total == 1
            finally:
                asc.stop()
        finally:
            c.shutdown()
    assert chip_smoke.node_processes_left({daemon}) == []
    assert out["visible"] == gpu_id
    assert chip_smoke.reduction_rel(out, ref) == 0.0
    assert out["counts"]["flash_fwd"] == N_LAYER
    assert not {k for k, v in out["counts"].items()
                if k != "flash_fwd" and v}
