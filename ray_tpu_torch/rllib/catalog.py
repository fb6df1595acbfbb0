"""Model catalog: architectures decoupled from algorithms, in PyTorch.

Counterpart of ``ray_tpu/rllib/catalog.py``. Reference analog:
``rllib/core/models/catalog.py`` — the Catalog builds encoder + head
components from the observation/action spec and a model config, so
EVERY algorithm consumes the same factory instead of hand-rolling its
network. A registry of encoder builders ("mlp", "cnn", user-registered
customs) and factory functions (``build_actor_critic``,
``build_q_network``, ``build_recurrent_actor_critic``) compose encoder +
policy/value/Q heads.

policy_config keys (as the JAX package's):
- ``obs_dim`` (int) or ``obs_shape`` (tuple, e.g. (84, 84, 4))
- ``num_actions`` (int)
- ``hidden``: tuple of dense widths (default (64, 64))
- ``encoder``: registry name, default "mlp" ("cnn" for obs_shape)
- ``activation``: "tanh" | "relu" | "gelu" (default tanh for pi,
  relu for Q and the CNN)
- ``conv_filters``: for cnn — ((features, kernel, stride), ...)
- ``dtype``: the parameters' and the computation's torch dtype
  (float32 by default)

Every factory takes ``device`` (the card by default: it raises where
none is visible, unless ``device="cpu"``) and ``seed``, from which a
CPU ``torch.Generator`` draws the initial weights; the model is built
on the CPU and moved, so a seed gives the same weights on every device.
The distributions are flax's (lecun-normal dense and conv kernels, zero
biases, orthogonal heads at scale 0.01 and 1.0, orthogonal GRU
recurrent kernels); the numbers are not. ``load_jax_params(params)`` carries a flax parameter
tree across: a ``Dense`` kernel ``[in, out]`` is the transpose of a
``Linear`` weight; a ``Conv`` kernel ``[kh, kw, in, out]`` becomes
``[out, in, kh, kw]``.

What differs from PyTorch's own layers:

- The CNN takes observations ``[B, H, W, C]`` as the JAX module does,
  convolves an NCHW view of them (``channels_last`` memory) with flax's
  uneven ``"SAME"`` padding (``models.resnet.Conv``: on 84x84 with the
  default filters the second conv, k 3 s 2 from 42, pads 0 low and 1
  high), and flattens in NHWC order, as ``x.reshape(B, -1)`` flattens
  the JAX model's NHWC maps, so the first dense layer's carried weights
  meet the features in their order.
- The GRU is flax's ``nn.GRUCell`` written out (:class:`GRUCell`):
  ``r = σ(ir(x) + hr(h))``, ``z = σ(iz(x) + hz(h))``,
  ``n = tanh(in(x) + r · hn(h))``, ``h' = (1 − z)·n + z·h``, with biases
  on ``ir``, ``iz``, ``in`` and ``hn`` only. ``torch.nn.GRUCell``
  computes the same forward with ``b_ih = [ir.b, iz.b, in.b]`` and
  ``b_hh = [0, 0, hn.b]``, but it would train the two zero biases of
  ``b_hh`` too, which flax does not have.
"""

from __future__ import annotations

from typing import Callable

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ray_tpu_torch.core.accelerator import resolve_device
from ray_tpu_torch.models.resnet import Conv, lecun_normal_

_ACTIVATIONS = {"tanh": torch.tanh, "relu": torch.relu,
                "gelu": lambda x: F.gelu(x, approximate="tanh")}

_ENCODERS: dict[str, Callable[[dict], nn.Module]] = {}


def register_encoder(name: str,
                     builder: Callable[[dict], nn.Module]) -> None:
    """Register a custom encoder builder: ``builder(policy_config)``
    returns a ``torch.nn.Module`` mapping obs -> feature vector ``[B, F]``
    (built on the CPU; the factory moves it to the model's device)."""
    _ENCODERS[name] = builder


def dense(c_in: int, c_out: int, device, gen, dtype=torch.float32,
          scale: float | None = None, bias: bool = True) -> nn.Linear:
    """flax ``nn.Dense``: a lecun-normal kernel, or an orthogonal one at
    ``scale``; a zero bias."""
    lin = nn.Linear(c_in, c_out, bias=bias, device=device, dtype=dtype)
    with torch.no_grad():
        if scale is None:
            lecun_normal_(lin.weight, c_in, gen)
        else:
            w = torch.empty(c_out, c_in, dtype=torch.float32)
            nn.init.orthogonal_(w, gain=scale, generator=gen)
            lin.weight.copy_(w)
        if bias:
            lin.bias.zero_()
    return lin


class MLPEncoder(nn.Module):
    def __init__(self, in_dim: int, hidden: tuple = (64, 64),
                 activation: str = "tanh", dtype=torch.float32,
                 device=None, gen=None):
        super().__init__()
        self.activation = activation
        self.dtype = dtype
        self.hidden = tuple(hidden)
        widths = (in_dim,) + self.hidden
        for i in range(len(self.hidden)):
            self.add_module(f"fc{i}", dense(widths[i], widths[i + 1],
                                            device, gen, dtype))
        self.out_dim = widths[-1]

    def forward(self, obs: torch.Tensor) -> torch.Tensor:
        act = _ACTIVATIONS[self.activation]
        x = obs.to(self.dtype)
        if x.dim() > 2:                    # flat features expected
            x = x.reshape(x.shape[0], -1)
        for i in range(len(self.hidden)):
            x = act(getattr(self, f"fc{i}")(x))
        return x


class CNNEncoder(nn.Module):
    """Conv stack for image observations ``[B, H, W, C]`` (reference: the
    catalog's CNN encoder defaults), flattened in NHWC order then densed
    (module docstring)."""

    def __init__(self, obs_shape: tuple,
                 conv_filters: tuple = ((16, 4, 2), (32, 3, 2)),
                 hidden: tuple = (64,), activation: str = "relu",
                 dtype=torch.float32, device=None, gen=None):
        super().__init__()
        self.activation = activation
        self.dtype = dtype
        self.conv_filters = tuple(tuple(f) for f in conv_filters)
        self.hidden = tuple(hidden)
        h, w, c = obs_shape
        for i, (feat, kern, stride) in enumerate(self.conv_filters):
            self.add_module(f"conv{i}", Conv(c, feat, kern, stride, dtype,
                                             dtype, device, gen, bias=True))
            # flax's SAME: ceil(size / stride) positions.
            h, w, c = -(-h // stride), -(-w // stride), feat
        widths = (h * w * c,) + self.hidden
        for i in range(len(self.hidden)):
            self.add_module(f"fc{i}", dense(widths[i], widths[i + 1],
                                            device, gen, dtype))
        self.out_dim = widths[-1]

    def forward(self, obs: torch.Tensor) -> torch.Tensor:
        act = _ACTIVATIONS[self.activation]
        x = obs.to(self.dtype).permute(0, 3, 1, 2)    # NCHW view of NHWC
        for i in range(len(self.conv_filters)):
            x = act(getattr(self, f"conv{i}")(x))
        x = x.permute(0, 2, 3, 1).reshape(x.shape[0], -1)   # NHWC order
        for i in range(len(self.hidden)):
            x = act(getattr(self, f"fc{i}")(x))
        return x


def _dtype(cfg: dict):
    dt = cfg.get("dtype", torch.float32)
    return dt if isinstance(dt, torch.dtype) else torch.float32


def _obs_shape(cfg: dict) -> tuple:
    shape = cfg.get("obs_shape")
    return tuple(shape) if shape is not None else (cfg["obs_dim"],)


def build_encoder(policy_config: dict, device=None,
                  gen: torch.Generator | None = None) -> nn.Module:
    cfg = dict(policy_config)
    name = cfg.get("encoder") or (
        "cnn" if cfg.get("obs_shape") is not None
        and len(cfg["obs_shape"]) >= 2 else "mlp")
    custom = _ENCODERS.get(name)
    if custom is None and name not in ("mlp", "cnn"):
        raise ValueError(
            f"unknown encoder {name!r}; registered: "
            f"{['mlp', 'cnn'] + sorted(_ENCODERS)}")
    device = resolve_device(device)
    gen = gen if gen is not None else _generator(0)
    dtype = _dtype(cfg)
    if custom is not None:
        enc = custom(cfg)
        with torch.no_grad():       # its feature width, as flax infers it
            probe = enc(torch.zeros((1, *_obs_shape(cfg))))
        enc.out_dim = int(probe.shape[-1])
    elif name == "mlp":
        enc = MLPEncoder(int(np.prod(_obs_shape(cfg))),
                         hidden=tuple(cfg.get("hidden", (64, 64))),
                         activation=cfg.get("activation", "tanh"),
                         dtype=dtype, gen=gen)
    else:
        enc = CNNEncoder(
            _obs_shape(cfg),
            conv_filters=tuple(cfg.get("conv_filters",
                                       ((16, 4, 2), (32, 3, 2)))),
            hidden=tuple(cfg.get("hidden", (64,))),
            activation=cfg.get("activation", "relu"),
            dtype=dtype, gen=gen)
    return enc.to(device)


class _Carried(nn.Module):
    """``load_jax_params`` for a module whose submodules carry flax's
    names: each ``{"kernel", "bias"}`` leaf of the tree goes into the
    submodule at the same path."""

    def load_jax_params(self, params: dict) -> None:
        load_flax_tree(self, params)


def load_flax_tree(module: nn.Module, tree: dict) -> None:
    """Copy a flax parameter tree (numpy leaves) into ``module``, whose
    submodules carry the tree's names: a Dense kernel ``[in, out]`` into
    a ``Linear`` weight ``[out, in]``, a Conv kernel ``[kh, kw, in,
    out]`` into ``[out, in, kh, kw]``. ValueError on a shape that does
    not fit, KeyError on a name the module lacks."""
    for name, sub in tree.items():
        child = module._modules[name]
        if "kernel" not in sub:
            load_flax_tree(child, sub)
            continue
        k = np.asarray(sub["kernel"], np.float32)
        k = k.transpose(3, 2, 0, 1) if k.ndim == 4 else k.T
        _put(child.weight, k)
        if "bias" in sub:
            _put(child.bias, np.asarray(sub["bias"], np.float32))
        elif child.bias is not None:
            raise ValueError(f"{name} has a bias the flax layer lacks")


def _put(dst: torch.Tensor, src: np.ndarray) -> None:
    if tuple(src.shape) != tuple(dst.shape):
        raise ValueError(f"shape {tuple(src.shape)} does not fit "
                         f"parameter {tuple(dst.shape)}")
    with torch.no_grad():
        dst.copy_(torch.from_numpy(np.array(src, np.float32)))


class CatalogActorCritic(_Carried):
    """Encoder + discrete policy/value heads, catalog-assembled:
    ``forward(obs) -> (logits [B, A], value [B])``."""

    def __init__(self, encoder: nn.Module, num_actions: int,
                 dtype=torch.float32, device=None, gen=None):
        super().__init__()
        self.encoder = encoder
        self.num_actions = num_actions
        self.pi = dense(encoder.out_dim, num_actions, device, gen, dtype,
                        scale=0.01)
        self.vf = dense(encoder.out_dim, 1, device, gen, dtype, scale=1.0)

    def forward(self, obs):
        x = self.encoder(obs)
        return self.pi(x), self.vf(x)[..., 0]


class CatalogQNetwork(_Carried):
    """Encoder + Q head, catalog-assembled: ``forward(obs) -> q [B, A]``."""

    def __init__(self, encoder: nn.Module, num_actions: int,
                 dtype=torch.float32, device=None, gen=None):
        super().__init__()
        self.encoder = encoder
        self.num_actions = num_actions
        self.q = dense(encoder.out_dim, num_actions, device, gen, dtype)

    def forward(self, obs):
        return self.q(self.encoder(obs))


class GRUCell(nn.Module):
    """flax ``nn.GRUCell(features)`` (module docstring):
    ``forward(carry [B, H], x [B, F]) -> (carry', y)``, ``y = carry'``."""

    def __init__(self, in_dim: int, features: int, dtype=torch.float32,
                 device=None, gen=None):
        super().__init__()
        self.features = features
        for name in ("ir", "iz", "in"):
            self.add_module(name, dense(in_dim, features, device, gen,
                                        dtype))
        for name in ("hr", "hz", "hn"):
            lin = dense(features, features, device, gen, dtype, scale=1.0,
                        bias=name == "hn")
            self.add_module(name, lin)

    def forward(self, carry, x):
        m = self._modules
        r = torch.sigmoid(m["ir"](x) + m["hr"](carry))
        z = torch.sigmoid(m["iz"](x) + m["hz"](carry))
        n = torch.tanh(m["in"](x) + r * m["hn"](carry))
        h = (1.0 - z) * n + z * carry
        return h, h


class RecurrentActorCritic(_Carried):
    """GRU policy+value with EXPLICIT carry (reference: the catalog's
    recurrent encoders + DreamerV3-class recurrent paths the Learner
    must handle). Entry points:

    - ``step`` / ``forward``: (obs [B, obs], carry [B, H]) ->
      (logits [B, A], value [B], carry) — rollouts.
    - ``seq``: (obs [B, T, obs], carry0 [B, H]) ->
      (logits [B, T, A], values [B, T]) — BPTT training, a loop over T.
    - ``seq_with_carries``: ``seq`` and the carry after each step
      ([B, T, H]).

    The pre-GRU featurizer comes from the encoder registry, so cnn/
    custom encoders compose with recurrence."""

    def __init__(self, encoder: nn.Module, num_actions: int,
                 hidden_state: int = 64, dtype=torch.float32, device=None,
                 gen=None):
        super().__init__()
        self.encoder = encoder
        self.num_actions = num_actions
        self.hidden_state = hidden_state
        self.dtype = dtype
        self.gru = GRUCell(encoder.out_dim, hidden_state, dtype, device,
                           gen)
        self.pi = dense(hidden_state, num_actions, device, gen, dtype,
                        scale=0.01)
        self.vf = dense(hidden_state, 1, device, gen, dtype, scale=1.0)

    def initial_state(self, batch_size: int) -> torch.Tensor:
        device = next(self.parameters()).device
        return torch.zeros((batch_size, self.hidden_state),
                           dtype=self.dtype, device=device)

    def _heads(self, x):
        return self.pi(x), self.vf(x)[..., 0]

    def forward(self, obs, carry):            # step
        carry, x = self.gru(carry, self.encoder(obs))
        logits, value = self._heads(x)
        return logits, value, carry

    def step(self, obs, carry):
        return self(obs, carry)

    def seq(self, obs_seq, carry0):
        logits, value, _carries = self.seq_with_carries(obs_seq, carry0)
        return logits, value

    def seq_with_carries(self, obs_seq, carry0):
        """Like ``seq`` but also returns the carry AFTER each step
        ([B, T, H]) — the learner slices these at segment boundaries
        so truncated-BPTT segments replay from their true rollout
        state instead of zeros."""
        B, T = obs_seq.shape[:2]
        flat = obs_seq.reshape(B * T, *obs_seq.shape[2:])
        feat = self.encoder(flat).reshape(B, T, -1)
        carry, ys = carry0, []
        for t in range(T):
            carry, y = self.gru(carry, feat[:, t])
            ys.append(y)
        x = torch.stack(ys, 1)                  # [B, T, H]
        logits, value = self._heads(x)
        return logits, value, x


def _generator(seed: int) -> torch.Generator:
    return torch.Generator().manual_seed(int(seed))


def build_recurrent_actor_critic(policy_config: dict, device=None,
                                 seed: int = 0) -> RecurrentActorCritic:
    """Recurrent variant: ``policy_config`` additionally takes
    ``hidden_state`` (GRU width, default 64). step/seq share params —
    rollouts use step, the learner BPTTs with seq."""
    cfg = dict(policy_config)
    device = resolve_device(device)
    gen = _generator(seed)
    return RecurrentActorCritic(
        build_encoder(cfg, "cpu", gen), cfg["num_actions"],
        hidden_state=int(cfg.get("hidden_state", 64)), dtype=_dtype(cfg),
        gen=gen).to(device)


def build_actor_critic(policy_config: dict, device=None,
                       seed: int = 0) -> CatalogActorCritic:
    cfg = dict(policy_config)
    device = resolve_device(device)
    gen = _generator(seed)
    return CatalogActorCritic(build_encoder(cfg, "cpu", gen),
                              cfg["num_actions"], _dtype(cfg),
                              gen=gen).to(device)


def build_q_network(policy_config: dict, device=None,
                    seed: int = 0) -> CatalogQNetwork:
    cfg = dict(policy_config)
    cfg.setdefault("activation", "relu")   # legacy QNetwork default
    device = resolve_device(device)
    gen = _generator(seed)
    return CatalogQNetwork(build_encoder(cfg, "cpu", gen),
                           cfg["num_actions"], _dtype(cfg),
                           gen=gen).to(device)
