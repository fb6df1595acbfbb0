"""Card-only tests of the Data library's device feed
(``DataIterator.iter_device_batches``) and of ``TorchTrainer(datasets=)``
on the card.

- ``iter_device_batches`` on its default device yields CUDA tensors
  equal to the numpy batches, each array copied into pinned host memory
  (``train.prefetch._pinned``, counted here) and from there to the card
  on the prefetcher's side stream; the object store's read-only arrays
  are copied, never wrapped.
- A one-rank ``TorchTrainer(datasets={"train": ds})`` on one card reads
  ``get_dataset_shard("train").iter_device_batches`` and reports the
  int64 sums of each batch's tokens and targets, computed on the card:
  equal to the numpy batches'; the block tasks it submits run in
  workers that see no card.

Marked ``cuda``: run on an H100 with

    python -m pytest --noconftest -m cuda tests/test_torch_cuda_data.py

They skip, from inside the test, where no GPU is visible.
"""

from __future__ import annotations

import os

import numpy as np
import pytest
import torch

pytestmark = pytest.mark.cuda

BATCH = 8
SEQ = 128
VOCAB = 50257


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: run with -m cuda on the card")
    return torch.device("cuda", 0)


def _rows(n: int = 4 * BATCH) -> np.ndarray:
    return np.random.default_rng(0).integers(0, VOCAB, (n, SEQ + 1))


def _lm(batch):
    toks = np.stack(batch["tokens"]).astype(np.int32)
    return {"tokens": toks[:, :-1], "targets": toks[:, 1:]}


def _dataset(tmp_path):
    from ray_tpu_torch import data
    from ray_tpu_torch.data import tfrecord
    tmp_path.mkdir(parents=True, exist_ok=True)
    rows = _rows()
    for f, part in enumerate(np.array_split(rows, 4)):
        tfrecord.write_records(
            str(tmp_path / f"part-{f}.tfrecord"),
            [tfrecord.build_example({"tokens": r.tolist()}) for r in part])
    want = [{"tokens": rows[i:i + BATCH, :-1].astype(np.int32),
             "targets": rows[i:i + BATCH, 1:].astype(np.int32)}
            for i in range(0, len(rows), BATCH)]
    return data.read_tfrecords(str(tmp_path)).map_batches(_lm), want


def test_iter_device_batches_from_pinned_memory(cuda, tmp_path,
                                                monkeypatch):
    import ray_tpu_torch as rt
    from ray_tpu_torch.train import prefetch

    staged = []
    pinned = prefetch._pinned

    def spy(arr):
        host = pinned(arr)
        staged.append((arr.flags.writeable, host.is_pinned()))
        return host
    monkeypatch.setattr(prefetch, "_pinned", spy)
    ds, want = _dataset(tmp_path)
    rt.init(num_cpus=2)
    try:
        got = list(ds.iterator().iter_device_batches(BATCH))
    finally:
        rt.shutdown()
    assert len(got) == len(want)
    for g, w in zip(got, want):
        for k in ("tokens", "targets"):
            assert g[k].device == cuda and g[k].dtype == torch.int32
            assert np.array_equal(g[k].cpu().numpy(), w[k])
    assert len(staged) == 2 * len(want)
    assert all(is_pinned for _, is_pinned in staged)


def test_one_rank_trainer_checksums_each_batch(cuda, tmp_path):
    import ray_tpu_torch as rt
    from ray_tpu_torch.train import RunConfig, ScalingConfig, TorchTrainer

    def loop():
        from ray_tpu_torch import data, train
        from ray_tpu_torch.parallel import initialize
        dev = initialize()
        for batch in train.get_dataset_shard("train").iter_device_batches(
                BATCH):
            train.report({
                "sums": [int(batch[k].to(torch.int64).sum())
                         for k in ("tokens", "targets")],
                "devices": sorted({str(v.device) for v in batch.values()}),
                "rank_device": str(dev),
                "block_worker_cuda": data.range(1).map_batches(
                    lambda b: {"cuda": np.asarray(
                        [os.environ.get("CUDA_VISIBLE_DEVICES", "unset")])}
                ).take_all()[0]["cuda"]})

    ds, want = _dataset(tmp_path / "files")
    rt.init(num_cpus=4)
    try:
        result = TorchTrainer(
            loop, datasets={"train": ds},
            scaling_config=ScalingConfig(num_workers=1, gpus_per_worker=1),
            run_config=RunConfig(name="data", storage_path=str(tmp_path))
        ).fit()
    finally:
        rt.shutdown()
    assert result.error is None, result.error
    history = result.metrics_history
    assert [m["sums"] for m in history] == [
        [int(w["tokens"].astype(np.int64).sum()),
         int(w["targets"].astype(np.int64).sum())] for w in want]
    for m in history:
        assert m["devices"] == ["cuda:0"] and m["rank_device"] == "cuda:0"
        assert m["block_worker_cuda"] == ""
