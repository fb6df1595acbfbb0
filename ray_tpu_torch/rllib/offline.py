"""Offline RL API: experience writers/readers + off-policy estimators.

Reference analogs: rllib/offline/{json_writer,json_reader,
dataset_reader,dataset_writer}.py and the IS/WIS estimators under
rllib/offline/estimators/. Counterpart of ``ray_tpu/rllib/offline.py``,
copied onto the port's ``data``: offline data flows through
ray_tpu_torch.data Datasets (batch dicts of numpy arrays), so offline
training shares the streaming/backpressure machinery with every other
pipeline, and learners consume host batches exactly like on-policy
ones.
"""

from __future__ import annotations

import json
import os
from typing import Iterator

import numpy as np

from ray_tpu_torch.rllib.env_runner import Episode


# -- writers ----------------------------------------------------------------


class JsonWriter:
    """Append episodes as JSONL rows, one row per episode (reference:
    JsonWriter's SampleBatch rows). Files rotate at max_file_size."""

    def __init__(self, path: str, max_file_size: int = 64 << 20):
        self.dir = path
        os.makedirs(path, exist_ok=True)
        self._max = max_file_size
        self._idx = 0
        self._fh = None

    def _file(self):
        if self._fh is None or self._fh.tell() > self._max:
            if self._fh is not None:
                self._fh.close()
            self._fh = open(os.path.join(
                self.dir, f"episodes-{os.getpid()}-{self._idx:05d}"
                          f".jsonl"), "a")
            self._idx += 1
        return self._fh

    def write(self, episodes: list[Episode]) -> int:
        f = self._file()
        for e in episodes:
            row = {
                "obs": np.asarray(e.obs, np.float32).tolist(),
                "actions": np.asarray(e.actions).tolist(),
                "rewards": np.asarray(e.rewards,
                                      np.float32).tolist(),
                "logps": np.asarray(e.logps, np.float32).tolist(),
                "terminated": bool(e.terminated),
                "truncated": bool(e.truncated),
            }
            f.write(json.dumps(row) + "\n")
        f.flush()
        return len(episodes)

    def close(self) -> None:
        if self._fh is not None:
            self._fh.close()
            self._fh = None


# -- readers ----------------------------------------------------------------


class JsonReader:
    """Read episodes back from a JsonWriter directory."""

    def __init__(self, path: str):
        self.dir = path

    def _files(self) -> list[str]:
        return sorted(
            os.path.join(self.dir, n) for n in os.listdir(self.dir)
            if n.endswith(".jsonl"))

    def read_episodes(self) -> list[Episode]:
        out = []
        for fp in self._files():
            with open(fp) as f:
                for line in f:
                    line = line.strip()
                    if not line:
                        continue
                    row = json.loads(line)
                    e = Episode(
                        obs=[np.asarray(o, np.float32)
                             for o in row["obs"]],
                        actions=list(row["actions"]),
                        rewards=list(row["rewards"]),
                        logps=list(row["logps"]),
                        terminated=row.get("terminated", False),
                        truncated=row.get("truncated", False))
                    out.append(e)
        return out

    def as_dataset(self):
        """Transitions as a ray_tpu_torch.data Dataset: columns obs /
        actions / rewards / logps / dones (the DatasetReader input
        for BC/MARWIL/CQL)."""
        from ray_tpu_torch import data as rdata
        eps = self.read_episodes()
        if not eps:
            return rdata.from_items([])
        obs = np.concatenate(
            [np.asarray(e.obs, np.float32) for e in eps])
        acts = np.concatenate([np.asarray(e.actions) for e in eps])
        rews = np.concatenate(
            [np.asarray(e.rewards, np.float32) for e in eps])
        logps = np.concatenate(
            [np.asarray(e.logps, np.float32) for e in eps])
        dones = np.concatenate([
            np.asarray([False] * (e.length - 1)
                       + [bool(e.terminated)]) for e in eps])
        # "action" (singular) aliases "actions" so the dataset plugs
        # straight into BC/MARWIL/CQL's offline_data contract.
        return rdata.from_numpy({"obs": obs, "actions": acts,
                                 "action": acts, "rewards": rews,
                                 "logps": logps, "dones": dones})


class DatasetReader:
    """Bounded-memory batch iterator over an offline Dataset
    (reference: dataset_reader.py)."""

    def __init__(self, ds, batch_size: int = 256,
                 shuffle_seed: int | None = 0):
        self._ds = ds
        self._bs = batch_size
        self._seed = shuffle_seed

    def iter_batches(self) -> Iterator[dict]:
        ds = self._ds
        if self._seed is not None:
            ds = ds.random_shuffle(self._seed)
        yield from ds.iter_batches(self._bs, drop_last=False)


# -- off-policy estimators --------------------------------------------------


class OffPolicyEstimator:
    """Estimate a target policy's value from behavior-policy data
    (reference: rllib/offline/estimators/)."""

    def __init__(self, gamma: float = 0.99):
        self.gamma = gamma

    def _weights(self, episodes: list[Episode], target_logp_fn):
        """Per-episode (discounted_return, importance_ratio)."""
        out = []
        for e in episodes:
            obs = np.asarray(e.obs, np.float32)
            acts = np.asarray(e.actions)
            behavior = np.asarray(e.logps, np.float32)
            target = np.asarray(target_logp_fn(obs, acts),
                                np.float32)
            ratio = float(np.exp(
                np.clip(np.sum(target - behavior), -20.0, 20.0)))
            disc = float(sum(
                r * self.gamma ** t
                for t, r in enumerate(e.rewards)))
            out.append((disc, ratio))
        return out

    def estimate(self, episodes, target_logp_fn) -> dict:
        raise NotImplementedError


class ImportanceSampling(OffPolicyEstimator):
    def estimate(self, episodes, target_logp_fn) -> dict:
        pairs = self._weights(episodes, target_logp_fn)
        vals = [g * w for g, w in pairs]
        behavior = [g for g, _ in pairs]
        return {"v_target": float(np.mean(vals)),
                "v_behavior": float(np.mean(behavior)),
                "v_gain": (float(np.mean(vals))
                           / (float(np.mean(behavior)) + 1e-9))}


class WeightedImportanceSampling(OffPolicyEstimator):
    def estimate(self, episodes, target_logp_fn) -> dict:
        pairs = self._weights(episodes, target_logp_fn)
        wsum = sum(w for _g, w in pairs) + 1e-9
        v = sum(g * w for g, w in pairs) / wsum
        behavior = float(np.mean([g for g, _ in pairs]))
        return {"v_target": float(v), "v_behavior": behavior,
                "v_gain": float(v) / (behavior + 1e-9)}
