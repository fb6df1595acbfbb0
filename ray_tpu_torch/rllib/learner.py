"""TorchLearner: the PPO update on the card, one captured step.

Counterpart of ``ray_tpu/rllib/learner.py``. Reference analog:
Learner/TorchLearner (learner.py:117, torch_learner.py:62). GAE is
computed on the host (numpy, copied from the JAX learner); each
minibatch goes to the card as ONE pinned host-to-device copy of all its
arrays, and the update — forward, clipped-surrogate loss, backward,
``clip_by_global_norm(max_grad_norm)`` and Adam — is one step of
``train.step.make_train_step``: captured as one CUDA graph for each
minibatch shape and replayed for every update after it, the port's
counterpart of ``jax.jit(update, donate_argnums=(0, 1))``. RL updates
are small, so the card would otherwise wait on the launches of each.

The optimizer is ``optax.chain(clip_by_global_norm(max_grad_norm),
adam(lr))`` in the port's optax-exact form (``train.optim``: ``chain``,
``clip_by_global_norm``, ``adamw(lr, weight_decay=0)`` with float32
moments); the clip's norm stays on the card. The minibatch order comes
from ``np.random.default_rng(0)``, the same on every call, as in the JAX
learner.

The learner's products and convolutions run at full float32: TF32 is
off inside its calls (:func:`full_float32`), and only there, so other
work in the process keeps its own settings. A float32 update on the card
then differs from the CPU's by float32 rounding alone.

``TorchLearner(policy_config, hparams, seed=0, device=None)`` runs on the
card by default and raises where none is visible; ``device="cpu"`` runs
it on the CPU. ``JaxLearner`` and ``RecurrentJaxLearner`` are aliases,
so that a program written for the JAX package runs here unchanged.
"""

from __future__ import annotations

import contextlib
from dataclasses import dataclass

import numpy as np
import torch
import torch.nn.functional as F

from ray_tpu_torch.core.accelerator import resolve_device
from ray_tpu_torch.rllib.catalog import build_actor_critic
from ray_tpu_torch.train.optim import adamw, chain, clip_by_global_norm
from ray_tpu_torch.train.step import (
    compile_count,
    init_train_state,
    make_train_step,
)


@dataclass
class PPOHyperparams:
    lr: float = 3e-4
    gamma: float = 0.99
    gae_lambda: float = 0.95
    clip_eps: float = 0.2
    vf_coeff: float = 0.5
    entropy_coeff: float = 0.01
    num_epochs: int = 4
    minibatch_size: int = 128
    max_grad_norm: float = 0.5


@contextlib.contextmanager
def full_float32():
    """TF32 off for matrix products and cuDNN convolutions inside the
    block, restored after it: PyTorch lets cuDNN convolutions use TF32 by
    default, which rounds each product's inputs to 10 mantissa bits
    (~5e-4 relative) and would take a float32 CNN update that far from
    the CPU's. A captured step keeps the kernels chosen at its
    capture."""
    matmul = torch.backends.cuda.matmul.allow_tf32
    conv = torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = matmul
        torch.backends.cudnn.allow_tf32 = conv


def batch_to_device(arrays: dict[str, np.ndarray], device) -> dict:
    """``{key: numpy array}`` as tensors on ``device``: on the card, one
    pinned host buffer holding every array (each at a 16-byte offset) and
    one copy of it, which the tensors view; on the CPU, the arrays
    themselves."""
    if device.type != "cuda":
        return {k: torch.from_numpy(np.ascontiguousarray(v))
                for k, v in arrays.items()}
    arrays = {k: np.ascontiguousarray(v) for k, v in arrays.items()}
    offsets, total = {}, 0
    for k, v in arrays.items():
        offsets[k] = total
        total += -(-v.nbytes // 16) * 16
    host = torch.empty(max(total, 16), dtype=torch.uint8, pin_memory=True)
    flat = host.numpy()
    for k, v in arrays.items():
        flat[offsets[k]:offsets[k] + v.nbytes] = v.reshape(-1).view(np.uint8)
    dev = host.to(device, non_blocking=True)
    out = {}
    for k, v in arrays.items():
        dtype = torch.from_numpy(np.empty(0, v.dtype)).dtype
        out[k] = (dev[offsets[k]:offsets[k] + v.nbytes].view(dtype)
                  .view(v.shape))
    return out


def as_tensor(x) -> torch.Tensor:
    """A tensor as it is; a numpy array (read-only ones from the object
    store too) or a number copied into a CPU tensor."""
    if isinstance(x, torch.Tensor):
        return x
    return torch.from_numpy(np.array(x))


def load_weights(module: torch.nn.Module, weights) -> None:
    """Copy ``weights`` (by parameter name; tensors or numpy) into the
    parameters of ``module``, in place."""
    with torch.no_grad():
        for name, p in module.named_parameters():
            p.copy_(as_tensor(weights[name]))


def adam_view(adam) -> dict:
    """An Adam state (``optim.AdamWState``) as ``{"count", "mu": [...],
    "nu": [...]}`` of its live tensors (what a checkpoint holds)."""
    return {"count": adam.count, "mu": list(adam.mu), "nu": list(adam.nu)}


def adam_load(adam, st: dict) -> None:
    """Copy ``st`` (:func:`adam_view`'s layout; tensors or numpy) into the
    Adam state's tensors, in place, so that a captured step goes on
    updating the same tensors."""
    with torch.no_grad():
        adam.count.copy_(as_tensor(st["count"]))
        for key in ("mu", "nu"):
            for dst, src in zip(getattr(adam, key), st[key]):
                dst.copy_(as_tensor(src))


class ModelLearner:
    """What a learner of one model shares (PPO's and IMPALA's, DQN's,
    BC's, MARWIL's, Dreamer's): ``self.model`` on ``self.device``, its
    parameters by name, weights for the runners, the capture count of its
    update ``self._update`` and a flax tree carried in."""

    model: torch.nn.Module

    @property
    def params(self) -> dict[str, torch.Tensor]:
        """The live parameters by name, on the learner's device (the JAX
        learner's ``params`` tree); assigning a dict copies it in."""
        return dict(self.model.named_parameters())

    @params.setter
    def params(self, weights) -> None:
        self.set_weights(weights)

    @property
    def compile_count(self) -> int | None:
        """Captures of the update so far: one for each batch shape; None
        where it has only run eagerly (on the CPU)."""
        return compile_count(self._update)

    def get_weights(self) -> dict[str, torch.Tensor]:
        """The parameters by name as CPU tensors (one device-to-host copy
        each, a copy on the CPU too): what the env runners load."""
        return {k: p.detach().to("cpu", copy=True)
                for k, p in self.params.items()}

    def set_weights(self, weights) -> None:
        """Copy ``weights`` (by name; tensors or numpy) into the
        parameters in place."""
        load_weights(self.model, weights)

    def load_jax_params(self, params: dict) -> None:
        """Copy the JAX learner's flax tree (numpy leaves) into the
        model (``catalog.load_flax_tree``)."""
        self.model.load_jax_params(params)


def gumbel(shape, generator: torch.Generator, device) -> torch.Tensor:
    """Standard Gumbel noise, ``-log(-log(u))`` with ``u`` uniform in
    [tiny, 1) as ``jax.random.gumbel`` draws it: ``argmax(logits +
    gumbel)`` is ``jax.random.categorical``'s sample."""
    u = torch.rand(shape, generator=generator, device=device)
    return -torch.log(-torch.log(u.clamp_min_(
        torch.finfo(torch.float32).tiny)))


class TorchLearner(ModelLearner):
    #: model factory hook — subclasses (recurrent) override.
    _build_model = staticmethod(build_actor_critic)

    def __init__(self, policy_config: dict,
                 hparams: PPOHyperparams | None = None,
                 mesh=None, seed: int = 0, device=None):
        self.hp = hparams or PPOHyperparams()
        self.device = resolve_device(device)
        self.model = self._build_model(policy_config, device=self.device,
                                       seed=seed)
        self.opt = chain(clip_by_global_norm(self.hp.max_grad_norm),
                         adamw(self.hp.lr, weight_decay=0.0))
        self.state = init_train_state(self.model, self.opt)
        self.mesh = mesh
        self._update = make_train_step(self._loss, self.opt,
                                       grad_norm=False, has_aux=True)

    # -- state --

    @property
    def opt_state(self) -> dict:
        """Adam's state as ``{"count", "mu": [...], "nu": [...]}`` of live
        tensors (the clip keeps none); assigning one copies it in, in
        place, so that a captured step goes on updating the same
        tensors."""
        return adam_view(self.state.opt_state[-1])

    @opt_state.setter
    def opt_state(self, st: dict) -> None:
        adam_load(self.state.opt_state[-1], st)

    # -- losses --

    def _loss(self, model, batch):
        hp = self.hp
        logits, values = model(batch["obs"])
        logp_all = F.log_softmax(logits, dim=-1)
        logp = logp_all.gather(
            -1, batch["actions"].long()[:, None])[:, 0]
        ratio = torch.exp(logp - batch["logp_old"])
        adv = batch["advantages"]
        surr = torch.minimum(
            ratio * adv,
            torch.clamp(ratio, 1 - hp.clip_eps, 1 + hp.clip_eps) * adv)
        pi_loss = -surr.mean()
        vf_loss = torch.mean((values - batch["returns"]) ** 2)
        entropy = -torch.mean(
            torch.sum(torch.exp(logp_all) * logp_all, dim=-1))
        total = (pi_loss + hp.vf_coeff * vf_loss
                 - hp.entropy_coeff * entropy)
        return total, {"policy_loss": pi_loss, "vf_loss": vf_loss,
                       "entropy": entropy}

    def compute_grads(self, params, batch: dict):
        """(grads, metrics) without applying — the seam the multi-learner
        group uses to allreduce gradients between learner processes
        before the update (reference: torch_learner.py:508-522 DDP hook).
        The gradient is taken at the model's parameters: ``params`` is the
        learner's own ``params``, which the JAX group passes (the JAX
        learner's are a separate tree). ``batch`` holds numpy arrays or
        tensors. Returns the gradients by parameter name and the metrics,
        as tensors on the learner's device."""
        named = self.params
        if isinstance(next(iter(batch.values())), np.ndarray):
            batch = batch_to_device(batch, self.device)
        with full_float32():
            for p in named.values():
                p.grad = None
            total, aux = self._loss(self.model, batch)
            total.backward()
        grads = {k: p.grad for k, p in named.items()}
        for p in named.values():
            p.grad = None
        return grads, {k: v.detach() for k, v in aux.items()}

    def apply_grads(self, grads: dict) -> None:
        """The optimizer's update (clip, then Adam) with ``grads`` by
        parameter name, in place."""
        named = self.params
        with full_float32():
            self.opt.update([grads[k] for k in named], self.state.opt_state,
                            list(named.values()))

    # -- GAE --

    def _gae(self, ep) -> np.ndarray:
        """Per-episode unnormalized GAE (shared by the flat and the
        recurrent learners)."""
        hp = self.hp
        r = np.asarray(ep.rewards, np.float32)
        v = np.asarray(ep.values + [ep.last_value], np.float32)
        deltas = r + hp.gamma * v[1:] - v[:-1]
        adv = np.zeros_like(deltas)
        acc = 0.0
        for t in range(len(deltas) - 1, -1, -1):
            acc = deltas[t] + hp.gamma * hp.gae_lambda * acc
            adv[t] = acc
        return adv

    def compute_advantages(self, episodes) -> dict[str, np.ndarray]:
        obs, actions, logps, advs, rets = [], [], [], [], []
        for ep in episodes:
            v = np.asarray(ep.values + [ep.last_value], np.float32)
            adv = self._gae(ep)
            ret = adv + v[:-1]
            obs.append(np.stack(ep.obs))
            actions.append(np.asarray(ep.actions, np.int32))
            logps.append(np.asarray(ep.logps, np.float32))
            advs.append(adv)
            rets.append(ret)
        advantages = np.concatenate(advs)
        advantages = (advantages - advantages.mean()) / (
            advantages.std() + 1e-8)
        return {
            "obs": np.concatenate(obs),
            "actions": np.concatenate(actions),
            "logp_old": np.concatenate(logps),
            "advantages": advantages.astype(np.float32),
            "returns": np.concatenate(rets).astype(np.float32),
        }

    # -- public --

    def update_from_episodes(self, episodes) -> dict[str, float]:
        hp = self.hp
        batch = self.compute_advantages(episodes)
        n = len(batch["obs"])
        # Clamp: a rollout smaller than one minibatch must still
        # produce an update, not silently skip every epoch.
        mb_size = max(1, min(hp.minibatch_size, n))
        rng = np.random.default_rng(0)
        metrics = {}
        with full_float32():
            for _ in range(hp.num_epochs):
                perm = rng.permutation(n)
                for s in range(0, n - mb_size + 1, mb_size):
                    idx = perm[s:s + mb_size]
                    mb = batch_to_device(
                        {k: v[idx] for k, v in batch.items()}, self.device)
                    self.state, metrics = self._update(self.state, mb)
        if not metrics:
            return {}
        return {"total_loss": float(metrics["loss"]),
                **{k: float(metrics[k])
                   for k in ("policy_loss", "vf_loss", "entropy")}}


class RecurrentTorchLearner(TorchLearner):
    """Sequence-BPTT PPO for recurrent modules (reference: the
    Learner's recurrent/stateful-module path — DreamerV3-class models
    train through sequences, not flat rows). Episodes become padded
    [B, T] segments; each segment replays from its TRUE rollout carry
    (the episode's recorded ``state_in`` advanced through the module
    once per rollout batch), so logp_old stays consistent with the
    replayed logits at epoch 0 — gradients are truncated at segment
    boundaries (truncated BPTT) but the PPO ratio is not corrupted by
    a zero-state restart. The loss runs the module's ``seq`` method
    with mask-weighted PPO terms, so padding contributes nothing.

    The number of segments changes with the episodes, and so does the
    minibatch's shape when it is below ``minibatch_size``: each shape is
    captured once (``compile_count`` counts them)."""

    @staticmethod
    def _build_model(policy_config: dict, device=None, seed: int = 0):
        from ray_tpu_torch.rllib.catalog import (
            build_recurrent_actor_critic,
        )
        return build_recurrent_actor_critic(policy_config, device, seed)

    def __init__(self, policy_config: dict,
                 hparams: PPOHyperparams | None = None,
                 mesh=None, seed: int = 0, max_seq_len: int = 32,
                 device=None):
        self.max_seq_len = max_seq_len
        super().__init__(policy_config, hparams, mesh, seed, device)

    def _loss(self, model, batch):
        hp = self.hp
        logits, values = model.seq(batch["obs"], batch["carry0"])
        logp_all = F.log_softmax(logits, dim=-1)           # [B, T, A]
        logp = logp_all.gather(
            -1, batch["actions"].long()[..., None])[..., 0]
        mask = batch["mask"]
        msum = mask.sum() + 1e-8
        ratio = torch.exp(logp - batch["logp_old"])
        adv = batch["advantages"]
        surr = torch.minimum(
            ratio * adv,
            torch.clamp(ratio, 1 - hp.clip_eps, 1 + hp.clip_eps) * adv)
        pi_loss = -(surr * mask).sum() / msum
        vf_loss = (((values - batch["returns"]) ** 2) * mask).sum() / msum
        ent_t = -torch.sum(torch.exp(logp_all) * logp_all, dim=-1)
        entropy = (ent_t * mask).sum() / msum
        total = (pi_loss + hp.vf_coeff * vf_loss
                 - hp.entropy_coeff * entropy)
        return total, {"policy_loss": pi_loss, "vf_loss": vf_loss,
                       "entropy": entropy}

    def _segment_carries(self, ep, obs: np.ndarray) -> list:
        """Carry at each max_seq_len boundary, replayed ONCE from the
        episode's rollout state_in with the current (= rollout-time)
        params."""
        T = self.max_seq_len
        H = self.model.hidden_state
        c0 = (np.asarray(ep.state_in, np.float32)
              if getattr(ep, "state_in", None) is not None
              else np.zeros(H, np.float32))
        if len(obs) <= T:
            return [c0]
        with torch.no_grad(), full_float32():
            carries = self.model.seq_with_carries(
                torch.from_numpy(obs[None]).to(self.device),
                torch.from_numpy(c0[None]).to(self.device))[2]
        carries = carries[0].cpu().numpy()
        return [c0] + [carries[s - 1] for s in range(T, len(obs), T)]

    def compute_advantages(self, episodes) -> dict[str, np.ndarray]:
        T = self.max_seq_len
        segs: dict[str, list] = {k: [] for k in (
            "obs", "actions", "logp_old", "advantages", "returns",
            "mask", "carry0")}
        per_ep = [self._gae(ep) for ep in episodes]
        flat = np.concatenate(per_ep)
        mean, std = flat.mean(), flat.std() + 1e-8
        for ep, adv_raw in zip(episodes, per_ep):
            adv = (adv_raw - mean) / std
            ret = adv_raw + np.asarray(ep.values, np.float32)
            obs = np.stack(ep.obs).astype(np.float32)
            acts = np.asarray(ep.actions, np.int32)
            logps = np.asarray(ep.logps, np.float32)
            carries = self._segment_carries(ep, obs)
            for i, s in enumerate(range(0, len(obs), T)):
                sl = slice(s, s + T)
                n = len(obs[sl])
                pad = T - n

                def p0(x, pad=pad):
                    if pad == 0:
                        return x
                    width = [(0, pad)] + [(0, 0)] * (x.ndim - 1)
                    return np.pad(x, width)

                segs["obs"].append(p0(obs[sl]))
                segs["actions"].append(p0(acts[sl]))
                segs["logp_old"].append(p0(logps[sl]))
                segs["advantages"].append(
                    p0(adv[sl].astype(np.float32)))
                segs["returns"].append(
                    p0(ret[sl].astype(np.float32)))
                segs["mask"].append(p0(np.ones(n, np.float32)))
                segs["carry0"].append(
                    np.asarray(carries[i], np.float32))
        return {k: np.stack(v) for k, v in segs.items()}


# The JAX package's names: a program written for it runs here unchanged.
JaxLearner = TorchLearner
RecurrentJaxLearner = RecurrentTorchLearner
