"""Card-only tests of phase 21 (a) at a small depth and of the rule that
a CUDA tensor crosses a channel as host bits.

GPT-2 at GPT-2 small's width with 4 blocks as chip_smoke's two-stage
compiled DAG (stages at ``num_gpus=0.5`` on one card), every check of
phase 21 (a); and a bf16 tensor on the card written to a channel and
read back a CPU tensor of the same dtype, shape and bits. Marked
``cuda``: run on the card with

    python -m pytest --noconftest -m cuda tests/test_torch_cuda_dag.py

It skips, from inside each test, where no card is visible.
"""

from __future__ import annotations

import pytest
import torch

pytestmark = pytest.mark.cuda


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: run with -m cuda on the card")


def test_a_cuda_tensor_crosses_a_channel_as_host_bits():
    _card()
    from ray_tpu_torch.experimental.channel import Channel
    sent = torch.randn(8, 1024, 768, device="cuda").to(torch.bfloat16)
    ch = Channel()
    try:
        ch.register_reader()
        ch.write({"x": sent})
        for copy in (True, False):
            got, is_err = ch.begin_read(timeout=60, copy=copy)
            ch.end_read()
            got = got["x"]
            assert not is_err and got.device.type == "cpu"
            assert got.dtype == torch.bfloat16 and got.shape == sent.shape
            assert torch.equal(got.view(torch.int16),
                               sent.cpu().view(torch.int16))
            if not copy:
                break
            ch.write({"x": sent})
    finally:
        ch.close()
        ch.detach()


def test_two_stage_dag_of_four_blocks_on_the_card():
    _card()
    import chip_smoke
    import ray_tpu_torch as rt
    from ray_tpu_torch.models import GPT2, GPT2Config
    from ray_tpu_torch.ops.cuda import build

    build.ensure_built()
    cfg = GPT2Config.small(n_layer=4)
    model = GPT2(cfg, seed=0)
    rt.init()
    try:
        readings, checks = chip_smoke.dag_leg(
            rt, chip_smoke.card_line(), rt.put(chip_smoke.numpy_weights(
                model)), model, cfg=cfg, executes=4)
    finally:
        rt.shutdown()
    failed = [(what, reading) for what, ok, reading in checks if not ok]
    assert not failed, failed
    assert readings["launches"] == 4 * cfg.n_layer
