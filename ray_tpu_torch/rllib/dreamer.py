"""Dreamer: model-based RL — world model + imagination-trained AC, on the
port.

Counterpart of ``ray_tpu/rllib/dreamer.py`` (reference analog:
``rllib/algorithms/dreamerv3/``), compact but structurally faithful:

- **RSSM with straight-through categorical latents** (n_cat independent
  categoricals of n_classes), 1% uniform mixing on every categorical
  ("unimix") so KL terms stay finite.
- **Symlog regression** for the reward head (plain MSE in symlog space).
- **KL balancing with free bits**: dyn loss KL(sg(post)||prior) and rep
  loss KL(post||sg(prior)), each clipped below 1 nat.
- **Imagination training**: posterior states from the world-model batch
  seed H-step latent rollouts through the prior; λ-returns over imagined
  reward/continue train the critic (MSE) and the actor (REINFORCE with
  normalized advantages + entropy).

:class:`DreamerModule` is an ``nn.Module`` whose submodules carry the
flax module's names (``wm_encoder``, ``wm_gru``, ..., ``actor``,
``critic``; each MLP's ``Dense_0..2``), so ``load_jax_params`` carries the
JAX learner's flat tree across; its GRU is the catalog's flax-exact
``GRUCell``. The JAX module's ``nn.scan`` over time is a loop over T, its
imagination ``lax.scan`` a loop over the horizon.

Noise is an input. ``jax.random.categorical`` is ``argmax(logits +
gumbel)``; every categorical sample here takes its Gumbel noise as a
tensor: the posterior samples of ``observe`` ``[T, B, n_cat,
n_classes]``, and in imagination each step's action ``[H, N, A]`` and
prior sample ``[H, N, n_cat, n_classes]``. The learner draws them from
its own ``torch.Generator`` on its device (seeded ``seed + 1``, where the
JAX learner splits ``jax.random.key(seed + 1)``: equal in distribution,
not in stream), or takes them (``update(batch, noise=...)``), so a
captured step replays with fresh noise and a test can feed JAX's draws.

The learner has two optimizers on disjoint parameter sets, each
``chain(clip_by_global_norm, adam)`` with the clip over its own set: the
world model's (``wm_*``) and the actor-critic's. Each update is one step
of ``train.step.make_step``, captured on the card as one CUDA graph (the
counterpart of each ``jit``): the world-model step returns the posterior
states (from the parameters before its update), and the actor-critic
step imagines from them under the parameters after it. The learner runs
on the card unless the config asks otherwise (``.learners(device=
"cpu")``); the rollouts run on the CPU runners (``policy="dreamer"``):
the module's ``forward`` is the recurrent-policy protocol (obs, carry) ->
(logits, value, carry'), with ``feed_action`` installing the chosen action
into the carry (h, z, a_prev).
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field, replace
from typing import Any

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ray_tpu_torch.core.accelerator import resolve_device
from ray_tpu_torch.rllib.algorithm import LearnersConfig
from ray_tpu_torch.rllib.catalog import (
    GRUCell, _Carried, _generator, dense,
)
from ray_tpu_torch.rllib.checkpoints import Checkpointable, tree_to_host
from ray_tpu_torch.rllib.env_runner import (
    EnvRunnerGroup, SupportsEvaluation,
)
from ray_tpu_torch.rllib.learner import (
    ModelLearner, adam_load, adam_view, as_tensor, batch_to_device,
    full_float32, gumbel,
)
from ray_tpu_torch.train.optim import adamw, chain, clip_by_global_norm
from ray_tpu_torch.train.step import TrainState, compile_count, make_step


def symlog(x):
    return torch.sign(x) * torch.log1p(torch.abs(x))


def symexp(x):
    return torch.sign(x) * (torch.exp(torch.abs(x)) - 1.0)


@dataclass(frozen=True)
class DreamerModelConfig:
    obs_dim: int = 4
    num_actions: int = 2
    embed: int = 64
    deter: int = 64                  # GRU deterministic state
    n_cat: int = 8                   # categorical latents
    n_classes: int = 8               # classes per latent
    hidden: int = 64                 # head MLP width
    unimix: float = 0.01

    @property
    def z_dim(self) -> int:
        return self.n_cat * self.n_classes


class MLP(nn.Module):
    """The flax ``_MLP``: ``n_hidden`` silu Dense layers of ``width``, then
    a Dense to ``out`` (``Dense_0``, ``Dense_1``, ``Dense_2``)."""

    def __init__(self, in_dim: int, width: int, out: int, gen,
                 n_hidden: int = 2):
        super().__init__()
        widths = (in_dim,) + (width,) * n_hidden + (out,)
        for i in range(n_hidden + 1):
            self.add_module(f"Dense_{i}", dense(widths[i], widths[i + 1],
                                                "cpu", gen))

    def forward(self, x):
        layers = list(self._modules.values())
        for layer in layers[:-1]:
            x = F.silu(layer(x))
        return layers[-1](x)


def _unimix_logits(logits, cfg: DreamerModelConfig):
    """Mix 1% uniform into each categorical (DreamerV3 'unimix'): keeps
    every class probability nonzero so the balanced KL cannot blow up on
    a confident prior meeting a different posterior."""
    shaped = logits.reshape(*logits.shape[:-1], cfg.n_cat, cfg.n_classes)
    probs = torch.softmax(shaped, dim=-1)
    probs = (1 - cfg.unimix) * probs + cfg.unimix / cfg.n_classes
    return torch.log(probs)


def _st_sample(logp, noise):
    """Straight-through one-hot sample from per-categorical log-probs
    [..., n_cat, n_classes] -> flat [..., n_cat*n_classes]: forward pass
    is the hard sample ``argmax(noise + logp)`` (``noise`` standard
    Gumbel, as ``jax.random.categorical``), gradient flows via the
    probs."""
    idx = torch.argmax(noise + logp.detach(), dim=-1)
    onehot = F.one_hot(idx, logp.shape[-1]).to(logp.dtype)
    probs = torch.exp(logp)
    z = onehot + probs - probs.detach()
    return z.reshape(*z.shape[:-2], -1)


def _mode(logp):
    onehot = F.one_hot(torch.argmax(logp, dim=-1),
                       logp.shape[-1]).to(logp.dtype)
    return onehot.reshape(*onehot.shape[:-2], -1)


def _kl_cat(logp_a, logp_b):
    """Sum over classes and categoricals of KL(a || b); mean over
    leading dims is the caller's job."""
    return torch.sum(torch.exp(logp_a) * (logp_a - logp_b), dim=(-2, -1))


class DreamerModule(_Carried):
    """World model + actor + critic in one module, its submodules named
    as the flax module's: ``wm_*`` the world model, ``actor`` and
    ``critic`` the behaviour. ``forward`` is the rollout step."""

    def __init__(self, cfg: DreamerModelConfig, device=None, seed: int = 0):
        super().__init__()
        device = resolve_device(device)
        gen = _generator(seed)
        c = self.cfg = cfg
        feat = c.deter + c.z_dim
        self.wm_encoder = MLP(c.obs_dim, c.hidden, c.embed, gen)
        self.wm_gru = GRUCell(c.z_dim + c.num_actions, c.deter, gen=gen)
        self.wm_prior = MLP(c.deter, c.hidden, c.z_dim, gen)
        self.wm_post = MLP(c.deter + c.embed, c.hidden, c.z_dim, gen)
        self.wm_decoder = MLP(feat, c.hidden, c.obs_dim, gen)
        self.wm_reward = MLP(feat, c.hidden, 1, gen)
        self.wm_cont = MLP(feat, c.hidden, 1, gen)
        self.actor = MLP(feat, c.hidden, c.num_actions, gen)
        self.critic = MLP(feat, c.hidden, 1, gen)
        self.hidden_state = c.deter       # recurrent-protocol metadata
        self.to(device)

    # -- state helpers --

    def _feat(self, h, z):
        return torch.cat([h, z], dim=-1)

    def _core(self, h, z, a_onehot):
        """Deterministic update h' = GRU([z, a], h)."""
        h2, _ = self.wm_gru(h, torch.cat([z, a_onehot], dim=-1))
        return h2

    def _prior_logp(self, h):
        return _unimix_logits(self.wm_prior(h), self.cfg)

    def _post_logp(self, h, embed):
        return _unimix_logits(
            self.wm_post(torch.cat([h, embed], dim=-1)), self.cfg)

    # -- world-model training pass --

    def observe(self, obs, actions, is_first, noise):
        """[B, T, ...] teacher-forced pass (``noise`` [T, B, n_cat,
        n_classes]). Returns per-step h, z, prior/posterior log-probs and
        head outputs."""
        c = self.cfg
        B, T = actions.shape
        embeds = self.wm_encoder(symlog(obs))             # [B, T, E]
        a_onehot = F.one_hot(actions.long(), c.num_actions).to(obs.dtype)
        h = torch.zeros((B, c.deter), dtype=obs.dtype, device=obs.device)
        z = torch.zeros((B, c.z_dim), dtype=obs.dtype, device=obs.device)
        a_prev = torch.zeros_like(a_onehot[:, 0])
        hs, zs, priors, posts = [], [], [], []
        for t in range(T):
            # Episode starts reset the latent state AND the incoming
            # action (no dynamics across an env reset).
            mask = (1.0 - is_first[:, t])[:, None]
            h, z, a_prev = h * mask, z * mask, a_prev * mask
            h = self._core(h, z, a_prev)
            prior = self._prior_logp(h)
            post = self._post_logp(h, embeds[:, t])
            z = _st_sample(post, noise[t])
            a_prev = a_onehot[:, t]
            hs.append(h)
            zs.append(z)
            priors.append(prior)
            posts.append(post)
        hs, zs = torch.stack(hs, 1), torch.stack(zs, 1)   # [B, T, ...]
        feat = self._feat(hs, zs)
        return {
            "h": hs, "z": zs,
            "prior": torch.stack(priors, 1), "post": torch.stack(posts, 1),
            "obs_hat": self.wm_decoder(feat),
            "reward_hat": self.wm_reward(feat)[..., 0],
            "cont_logit": self.wm_cont(feat)[..., 0],
        }

    # -- imagination --

    def img_step(self, h, z, a_onehot, noise):
        """One prior step (no observation): the imagination transition."""
        h2 = self._core(h, z, a_onehot)
        return h2, _st_sample(self._prior_logp(h2), noise)

    def heads(self, h, z):
        feat = self._feat(h, z)
        return {
            "reward": symexp(self.wm_reward(feat)[..., 0]),
            "cont": torch.sigmoid(self.wm_cont(feat)[..., 0]),
            "value": self.critic(feat)[..., 0],
            "logits": self.actor(feat),
        }

    # -- rollout-policy protocol (EnvRunner policy="dreamer") --

    def rollout_step(self, obs, carry):
        """(obs [1, D], carry (h, z, a_prev)) -> (logits, value, carry').
        The latent is the posterior MODE (rollout exploration comes from
        the runner's categorical sampling); the action slot is filled
        afterwards by :meth:`feed_action`."""
        h, z, a_prev = carry
        embed = self.wm_encoder(symlog(obs))
        h2 = self._core(h, z, a_prev)
        z2 = _mode(self._post_logp(h2, embed))
        feat = self._feat(h2, z2)
        return (self.actor(feat), self.critic(feat)[..., 0],
                (h2, z2, torch.zeros_like(a_prev)))

    forward = rollout_step

    def initial_state(self, batch: int):
        c = self.cfg
        device = next(self.parameters()).device
        return (torch.zeros((batch, c.deter), device=device),
                torch.zeros((batch, c.z_dim), device=device),
                torch.zeros((batch, c.num_actions), device=device))

    def feed_action(self, carry, action: int):
        h, z, a = carry
        a2 = F.one_hot(torch.tensor([int(action)], device=a.device),
                       self.cfg.num_actions).to(a.dtype)
        return (h, z, a2)


def _model_config(policy_config: dict) -> DreamerModelConfig:
    return DreamerModelConfig(**{
        k: v for k, v in policy_config.items()
        if k in DreamerModelConfig.__dataclass_fields__})


def build_dreamer_policy(policy_config: dict, device=None,
                         seed: int = 0) -> DreamerModule:
    """The rollout policy of ``policy_config``: a :class:`DreamerModule`
    (its forward the rollout step), the learner's parameter names."""
    return DreamerModule(_model_config(policy_config), device, seed)


# ---------------------------------------------------------------------------
# replay
# ---------------------------------------------------------------------------


class SequenceReplay:
    """Episode store sampling [B, T] training segments with is_first
    flags (reference: dreamerv3's EpisodeReplayBuffer)."""

    def __init__(self, capacity_steps: int, seq_len: int):
        self.capacity = capacity_steps
        self.seq_len = seq_len
        self.episodes: list[dict[str, np.ndarray]] = []
        self.steps = 0

    def add_episodes(self, episodes) -> int:
        n = 0
        for ep in episodes:
            if ep.length < 2:
                continue
            self.episodes.append({
                "obs": np.stack(ep.obs).astype(np.float32),
                "actions": np.asarray(ep.actions, np.int32),
                "rewards": np.asarray(ep.rewards, np.float32),
                "cont": np.asarray(
                    [1.0] * (ep.length - 1)
                    + [0.0 if ep.terminated else 1.0], np.float32),
            })
            self.steps += ep.length
            n += ep.length
        while self.steps > self.capacity and len(self.episodes) > 1:
            self.steps -= len(self.episodes.pop(0)["actions"])
        return n

    def sample(self, batch: int, rng) -> dict[str, np.ndarray] | None:
        if not self.episodes:
            return None
        T = self.seq_len
        out = {k: [] for k in ("obs", "actions", "rewards", "cont",
                               "is_first")}
        for _ in range(batch):
            ep = self.episodes[rng.integers(len(self.episodes))]
            L = len(ep["actions"])
            s = int(rng.integers(0, max(1, L - T + 1)))
            sl = slice(s, s + T)
            n = len(ep["actions"][sl])
            pad = T - n

            def p0(x, pad=pad):
                if pad == 0:
                    return x
                return np.pad(x, [(0, pad)] + [(0, 0)] * (x.ndim - 1))

            first = np.zeros(n, np.float32)
            if s == 0:
                first[0] = 1.0
            out["obs"].append(p0(ep["obs"][sl]))
            out["actions"].append(p0(ep["actions"][sl]))
            out["rewards"].append(p0(ep["rewards"][sl]))
            # Padding is masked via cont=0 on padded steps.
            out["cont"].append(p0(ep["cont"][sl]))
            out["is_first"].append(p0(first))
        return {k: np.stack(v) for k, v in out.items()}


# ---------------------------------------------------------------------------
# learner
# ---------------------------------------------------------------------------


@dataclass
class DreamerHyperparams:
    wm_lr: float = 3e-4
    ac_lr: float = 1e-4
    gamma: float = 0.97
    gae_lambda: float = 0.95
    horizon: int = 10                # imagination length
    free_bits: float = 1.0
    dyn_scale: float = 0.5
    rep_scale: float = 0.1
    entropy_coeff: float = 3e-3
    batch_size: int = 8
    seq_len: int = 16
    buffer_steps: int = 20_000
    wm_updates_per_iter: int = 8
    ac_updates_per_iter: int = 8
    learning_starts: int = 300
    max_grad_norm: float = 100.0


def sigmoid_binary_cross_entropy(logits, labels):
    """optax.sigmoid_binary_cross_entropy."""
    return (-labels * F.logsigmoid(logits)
            - (1.0 - labels) * F.logsigmoid(-logits))


class DreamerLearner(ModelLearner):
    def __init__(self, cfg: DreamerModelConfig,
                 hp: DreamerHyperparams, seed: int = 0, device=None):
        self.cfg, self.hp = cfg, hp
        self.device = resolve_device(device)
        self.module = self.model = DreamerModule(cfg, self.device, seed)
        self.wm_opt = chain(clip_by_global_norm(hp.max_grad_norm),
                            adamw(hp.wm_lr, weight_decay=0.0))
        self.ac_opt = chain(clip_by_global_norm(hp.max_grad_norm),
                            adamw(hp.ac_lr, weight_decay=0.0))
        named = list(self.module.named_parameters())
        self._wm_params = [p for k, p in named if k.startswith("wm_")]
        self._ac_params = [p for k, p in named if not k.startswith("wm_")]
        self.state = TrainState(step=0, params=self.module, opt_state={
            "wm": self.wm_opt.init(self._wm_params),
            "ac": self.ac_opt.init(self._ac_params)})
        self.generator = torch.Generator(self.device).manual_seed(seed + 1)
        self._wm_update = make_step(self._wm_body)
        self._ac_update = make_step(self._ac_body)

    # -- state --

    @property
    def wm_opt_state(self) -> dict:
        return adam_view(self.state.opt_state["wm"][-1])

    @wm_opt_state.setter
    def wm_opt_state(self, st: dict) -> None:
        adam_load(self.state.opt_state["wm"][-1], st)

    @property
    def ac_opt_state(self) -> dict:
        return adam_view(self.state.opt_state["ac"][-1])

    @ac_opt_state.setter
    def ac_opt_state(self, st: dict) -> None:
        adam_load(self.state.opt_state["ac"][-1], st)

    @property
    def compile_count(self) -> int | None:
        """Captures of the two updates together (one each per batch
        shape); None where they have only run eagerly (on the CPU)."""
        counts = [compile_count(s) for s in (self._wm_update,
                                             self._ac_update)]
        return None if None in counts else sum(counts)

    # -- world model --

    def _wm_loss(self, module, batch, noise):
        hp = self.hp
        out = module.observe(batch["obs"], batch["actions"],
                             batch["is_first"], noise)
        # cont doubles as the pad mask (padded steps carry cont=0).
        cont = batch["cont"]
        mask = torch.cat([torch.ones_like(cont[:, :1]), cont[:, :-1]], 1)
        msum = mask.sum() + 1e-8
        recon = (((out["obs_hat"] - symlog(batch["obs"])) ** 2
                  ).sum(-1) * mask).sum() / msum
        rew = (((out["reward_hat"] - symlog(batch["rewards"])) ** 2)
               * mask).sum() / msum
        cont_loss = (sigmoid_binary_cross_entropy(out["cont_logit"], cont)
                     * mask).sum() / msum
        dyn = torch.clamp(_kl_cat(out["post"].detach(), out["prior"]),
                          min=hp.free_bits)
        rep = torch.clamp(_kl_cat(out["post"], out["prior"].detach()),
                          min=hp.free_bits)
        dyn = (dyn * mask).sum() / msum
        rep = (rep * mask).sum() / msum
        total = recon + rew + cont_loss + hp.dyn_scale * dyn \
            + hp.rep_scale * rep
        aux = {"wm_loss": total, "recon_loss": recon,
               "reward_loss": rew, "cont_loss": cont_loss, "kl_dyn": dyn}
        return total, aux, out

    def _wm_body(self, state, batch) -> dict:
        total, aux, out = self._wm_loss(state.params, batch, batch["noise"])
        grads = torch.autograd.grad(total, self._wm_params)
        self.wm_opt.update(list(grads), state.opt_state["wm"],
                           self._wm_params)
        return {**{k: v.detach() for k, v in aux.items()},
                "h": out["h"].detach(), "z": out["z"].detach()}

    # -- actor-critic in imagination --

    def _ac_loss(self, module, h0, z0, noise_a, noise_z):
        """The imagined H-step rollout from (h0, z0) and the actor and
        critic losses on it. Only the actor's log-probs and entropies and
        the critic's values carry gradient: the samples are discrete
        (no gradient to the actor through the dynamics) and the returns
        and weights are constants, as in the JAX loss."""
        hp, c = self.hp, self.cfg
        N = h0.shape[0]
        h, z = h0, z0
        rews, conts, values, logps, ents = [], [], [], [], []
        for t in range(hp.horizon):
            feat = module._feat(h, z)
            logits = module.actor(feat)
            values.append(module.critic(feat)[..., 0])
            with torch.no_grad():
                rews.append(symexp(module.wm_reward(feat)[..., 0]))
                conts.append(torch.sigmoid(module.wm_cont(feat)[..., 0]))
                a = torch.argmax(noise_a[t] + logits.detach(), dim=-1)
            logp_all = F.log_softmax(logits, dim=-1)
            logps.append(logp_all.gather(-1, a[:, None])[:, 0])
            ents.append(-torch.sum(torch.exp(logp_all) * logp_all, dim=-1))
            with torch.no_grad():
                a_onehot = F.one_hot(a, c.num_actions).to(h.dtype)
                h, z = module.img_step(h, z, a_onehot, noise_z[t])
        rews, conts = torch.stack(rews), torch.stack(conts)
        values, logps, ents = (torch.stack(values), torch.stack(logps),
                               torch.stack(ents))
        with torch.no_grad():
            v_h = module.critic(module._feat(h, z))[..., 0]
            # λ-returns over the imagined trajectory, discount from the
            # continue head (terminal states stop the return).
            disc = hp.gamma * conts
            v_next = torch.cat([values[1:].detach(), v_h[None]], 0)
            acc, rets = v_h, [None] * hp.horizon
            for t in range(hp.horizon - 1, -1, -1):
                acc = rews[t] + disc[t] * ((1 - hp.gae_lambda) * v_next[t]
                                           + hp.gae_lambda * acc)
                rets[t] = acc
            returns = torch.stack(rets)
            # Discount-weight imagined steps so later (less reliable)
            # steps count less.
            weight = torch.cumprod(torch.cat(
                [torch.ones((1, N), dtype=disc.dtype, device=disc.device),
                 disc[:-1]], 0), 0)
            adv = returns - values.detach()
            # jnp.std: the population standard deviation.
            adv = adv / torch.clamp(torch.std(adv, unbiased=False), min=1.0)
        actor_loss = -(weight * (logps * adv
                                 + hp.entropy_coeff * ents)).mean()
        critic_loss = (weight * (values - returns) ** 2).mean()
        total = actor_loss + critic_loss
        return total, {"actor_loss": actor_loss.detach(),
                       "critic_loss": critic_loss.detach(),
                       "imag_return": returns.mean(),
                       "imag_entropy": ents.detach().mean()}

    def _ac_body(self, state, batch) -> dict:
        # Imagination starts from every posterior state of the world-
        # model batch, gradients stopped (the world model is trained only
        # by its own loss).
        d = batch["h"].shape[-1]
        total, aux = self._ac_loss(
            state.params, batch["h"].reshape(-1, d),
            batch["z"].reshape(-1, batch["z"].shape[-1]),
            batch["noise_a"], batch["noise_z"])
        grads = torch.autograd.grad(total, self._ac_params)
        self.ac_opt.update(list(grads), state.opt_state["ac"],
                           self._ac_params)
        return aux

    # -- public --

    def draw_noise(self, batch: int, seq_len: int) -> dict:
        """Gumbel noise for one update of a [batch, seq_len] batch: the
        world model's posterior samples and, over the batch's
        batch·seq_len imagination starts, each step's action and prior
        sample."""
        c, H, g, dev = self.cfg, self.hp.horizon, self.generator, self.device
        n = batch * seq_len
        return {"wm": gumbel((seq_len, batch, c.n_cat, c.n_classes), g, dev),
                "ac_a": gumbel((H, n, c.num_actions), g, dev),
                "ac_z": gumbel((H, n, c.n_cat, c.n_classes), g, dev)}

    def update(self, batch: dict[str, np.ndarray], noise=None) -> dict:
        mb = batch_to_device(
            {"obs": np.asarray(batch["obs"], np.float32),
             "actions": np.asarray(batch["actions"], np.int64),
             "rewards": np.asarray(batch["rewards"], np.float32),
             "cont": np.asarray(batch["cont"], np.float32),
             "is_first": np.asarray(batch["is_first"], np.float32)},
            self.device)
        if noise is None:
            noise = self.draw_noise(*batch["actions"].shape)
        noise = {k: as_tensor(v).to(self.device) for k, v in noise.items()}
        with full_float32():
            _, wm = self._wm_update(self.state, {**mb, "noise": noise["wm"]})
            h, z = wm.pop("h"), wm.pop("z")
            _, ac = self._ac_update(self.state, {
                "h": h, "z": z, "noise_a": noise["ac_a"],
                "noise_z": noise["ac_z"]})
        return {k: float(v) for k, v in {**wm, **ac}.items()}


# ---------------------------------------------------------------------------
# algorithm
# ---------------------------------------------------------------------------


@dataclass
class DreamerConfig(LearnersConfig):
    env: Any = None
    policy_config: dict = field(default_factory=dict)
    num_env_runners: int = 1
    rollout_fragment_length: int = 128
    hparams: DreamerHyperparams = field(
        default_factory=DreamerHyperparams)
    seed: int = 0
    device: Any = None                      # the learner's; None: the card

    def environment(self, env, *, obs_dim: int, num_actions: int,
                    **model_kw) -> "DreamerConfig":
        return replace(self, env=env, policy_config={
            "obs_dim": obs_dim, "num_actions": num_actions,
            **model_kw})

    def env_runners(self, num_env_runners: int) -> "DreamerConfig":
        return replace(self, num_env_runners=num_env_runners)

    def training(self, **hp_overrides) -> "DreamerConfig":
        return replace(self, hparams=replace(self.hparams,
                                             **hp_overrides))

    def build(self) -> "Dreamer":
        return Dreamer(self)


class Dreamer(Checkpointable, SupportsEvaluation):
    """Dreamer algorithm under the shared Algorithm surface
    (train() -> metrics dict; Checkpointable save/restore)."""

    def __init__(self, config: DreamerConfig):
        assert config.env is not None
        self.config = config
        hp = config.hparams
        self.learner = DreamerLearner(_model_config(config.policy_config),
                                      hp, seed=config.seed,
                                      device=config.device)
        self.runners = EnvRunnerGroup(
            config.env, config.policy_config,
            num_runners=config.num_env_runners, seed=config.seed,
            policy="dreamer")
        self.buffer = SequenceReplay(hp.buffer_steps, hp.seq_len)
        self.rng = np.random.default_rng(config.seed)
        self.iteration = 0
        self.runners.set_weights(self.learner.get_weights())

    def get_state(self) -> dict:
        return {
            "iteration": self.iteration,
            "learner": {
                "params": tree_to_host(self.learner.params),
                "wm_opt_state": tree_to_host(self.learner.wm_opt_state),
                "ac_opt_state": tree_to_host(self.learner.ac_opt_state),
            },
        }

    def set_state(self, state: dict) -> None:
        self.iteration = int(state["iteration"])
        lst = state["learner"]
        # Copied into the learner's tensors in place: a captured update
        # goes on writing the same ones.
        self.learner.params = lst["params"]
        self.learner.wm_opt_state = lst["wm_opt_state"]
        self.learner.ac_opt_state = lst["ac_opt_state"]
        self.runners.set_weights(self.learner.get_weights())

    def train(self) -> dict:
        hp = self.config.hparams
        t0 = time.time()
        episodes = self.runners.sample(
            self.config.rollout_fragment_length)
        added = self.buffer.add_episodes(episodes)
        sample_time = time.time() - t0

        metrics: dict = {}
        t1 = time.time()
        if self.buffer.steps >= hp.learning_starts:
            for _ in range(hp.wm_updates_per_iter):
                batch = self.buffer.sample(hp.batch_size, self.rng)
                if batch is None:
                    break
                metrics = self.learner.update(batch)
            self.runners.set_weights(self.learner.get_weights())
        learn_time = time.time() - t1

        self.iteration += 1
        finished = [e for e in episodes if e.terminated or e.truncated]
        mean_reward = (sum(e.total_reward for e in finished)
                       / len(finished)) if finished else float("nan")
        return {
            "training_iteration": self.iteration,
            "episode_reward_mean": mean_reward,
            "episodes_this_iter": len(finished),
            "num_env_steps_sampled": added,
            "buffer_steps": self.buffer.steps,
            "time_sample_s": round(sample_time, 3),
            "time_learn_s": round(learn_time, 3),
            **metrics,
        }

    def stop(self) -> None:
        self.runners.shutdown()
