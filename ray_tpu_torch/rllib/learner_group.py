"""Multi-learner scaling: a LearnerGroup of learner ACTORS doing
data-parallel SGD with gradient allreduce between them.

Counterpart of ``ray_tpu/rllib/learner_group.py``. Reference analog:
rllib/core/learner/learner_group.py:80 + the DDP-across-learners path of
torch_learner.py:508-522. Each learner actor computes gradients on its
shard on its own card share, flattens them into ONE float32 host vector
(one device-to-host copy), ring-allreduces it with its peers over the
host collective plane (``ray_tpu_torch.collective``, rank-to-rank TCP),
divides by the world size, copies the mean back to its card as one
tensor and applies the SAME clip-then-Adam update — so all replicas
stay bit-identical without a parameter server.

The card share: a worker sees a card only if it asks for one (workers
without GPUs run with ``CUDA_VISIBLE_DEVICES=""``), so each learner actor
asks for ``{"GPU": min(1, cards / num_learners)}`` of the runtime's
cards: 0.5 each for two learners on one card, 1 each for four learners
on four cards. It is the counterpart of the JAX learner sitting on its
process's default device. With no card in the runtime it raises, unless
``device="cpu"``, where the learners ask for none.
"""

from __future__ import annotations

import numpy as np

import ray_tpu_torch


@ray_tpu_torch.remote
class _LearnerActor:
    def __init__(self, rank: int, world: int, group: str,
                 policy_config: dict, hparams_blob: bytes,
                 seed: int, device):
        import pickle

        from ray_tpu_torch.collective import init_collective_group
        from ray_tpu_torch.rllib.learner import TorchLearner

        self.rank, self.world, self.group = rank, world, group
        self.learner = TorchLearner(
            policy_config, pickle.loads(hparams_blob),
            seed=seed, device=device)   # same seed => identical init
        if world > 1:
            init_collective_group(world, rank, group)

    def _allreduce_grads(self, grads: dict) -> dict:
        """Flatten -> one host copy -> ring allreduce -> mean -> one copy
        back -> unflatten."""
        import torch

        from ray_tpu_torch.collective import allreduce
        flat = torch.cat([g.reshape(-1).float() for g in grads.values()])
        summed = allreduce(flat, self.group)     # one .cpu() copy inside
        mean = torch.from_numpy(summed / self.world).to(flat.device)
        out, pos = {}, 0
        for name, g in grads.items():
            n = g.numel()
            out[name] = mean[pos:pos + n].view(g.shape)
            pos += n
        return out

    def update(self, batch_shard: dict) -> dict:
        """One SGD step on this learner's shard with cross-learner
        gradient averaging."""
        ln = self.learner
        grads, metrics = ln.compute_grads(ln.params, batch_shard)
        if self.world > 1:
            grads = self._allreduce_grads(grads)
        ln.apply_grads(grads)
        return {k: float(v) for k, v in metrics.items()}

    def get_weights(self):
        return self.learner.get_weights()

    def weights_digest(self) -> str:
        import hashlib

        h = hashlib.sha256()
        for p in self.learner.params.values():
            h.update(p.detach().float().cpu().numpy().tobytes())
        return h.hexdigest()


class LearnerGroup:
    """N learner actors; update() shards the batch and steps them in
    lockstep (reference: LearnerGroup.update_from_batch). ``device`` is
    the learners' device: the card share above by default, ``"cpu"``
    when asked."""

    _seq = 0
    _actor_class = _LearnerActor

    def __init__(self, policy_config: dict, hparams=None,
                 num_learners: int = 1, seed: int = 0, device=None):
        import pickle
        LearnerGroup._seq += 1
        self.group = f"learner_group_{LearnerGroup._seq}"
        self.num_learners = num_learners
        if device is None:
            cards = ray_tpu_torch.cluster_resources().get("GPU", 0)
            if cards <= 0:
                raise RuntimeError(
                    "no CUDA device is visible to the runtime; "
                    "ray_tpu_torch runs on the GPU by default (pass "
                    "device='cpu' to run on the CPU)")
            options = {"num_gpus": min(1.0, cards / num_learners)}
        else:
            options = {}
        blob = pickle.dumps(hparams)
        self.learners = [
            self._actor_class.options(**options).remote(
                i, num_learners, self.group, policy_config, blob, seed,
                device)
            for i in range(num_learners)
        ]
        # Constructors (incl. collective rendezvous) complete here.
        ray_tpu_torch.get([ln.get_weights.remote()
                           for ln in self.learners], timeout=120)

    def update(self, batch: dict) -> list[dict]:
        n = self.num_learners
        size = len(next(iter(batch.values())))
        if size < n:
            # An empty shard means NaN means over zero rows, and the
            # allreduce would poison EVERY replica with them.
            raise ValueError(
                f"batch of {size} rows cannot shard across {n} "
                f"learners")
        per = size // n
        shards = []
        for i in range(n):
            lo = i * per
            hi = size if i == n - 1 else (i + 1) * per
            shards.append({k: np.asarray(v[lo:hi])
                           for k, v in batch.items()})
        return ray_tpu_torch.get(
            [ln.update.remote(s)
             for ln, s in zip(self.learners, shards)], timeout=300)

    def get_weights(self):
        return ray_tpu_torch.get(self.learners[0].get_weights.remote(),
                                 timeout=120)

    def weights_digests(self) -> list[str]:
        return ray_tpu_torch.get(
            [ln.weights_digest.remote() for ln in self.learners],
            timeout=120)

    def shutdown(self) -> None:
        for ln in self.learners:
            try:
                ray_tpu_torch.kill(ln)
            except Exception:  # noqa: BLE001
                pass
        # The rendezvous store actor is named per group: kill it so
        # repeated group construction (e.g. Tune trials) doesn't
        # accumulate actors for the life of the runtime.
        try:
            from ray_tpu_torch.collective.host import _GROUP_PREFIX
            ray_tpu_torch.kill(
                ray_tpu_torch.get_actor(_GROUP_PREFIX + self.group))
        except Exception:  # noqa: BLE001
            pass
