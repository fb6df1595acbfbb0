"""AdamW, SGD and RMSProp with optax's semantics, updating in place, and
the gradient clip by global norm that ``optax.chain`` puts before them.

Counterpart of ``optax.adamw`` as the JAX package uses it
(``optax.adamw(3e-4, weight_decay=0.1, mu_dtype=bf16)`` on the bench):
``chain(scale_by_adam, add_decayed_weights, scale_by_learning_rate)``.
``torch.optim.AdamW`` differs in three ways that matter for parity: it
cannot keep the first moment in bf16, it folds the decay into the
parameter before the Adam step, and it scales the decay by the learning
rate at another point. So, per parameter ``p`` with gradient ``g``:

    mu    = (1 - b1) * g + b1 * mu       # b1 * mu in mu's type (b1 too), sum in f32
    nu    = (1 - b2) * g² + b2 * nu      # float32
    count = count + 1
    u     = (mu / (1 - b1**count)) / (sqrt(nu / (1 - b2**count)) + eps)
    u     = u + weight_decay * p         # every parameter: optax's mask is None
    p     = p + (-lr) * u
    mu    stored in mu_dtype (rounded after the update used it in f32)

The step count and both bias corrections are float32 tensors on the
parameters' device, computed there as optax computes them in float32:
a step captured as a CUDA graph (``train.step``) replays them with the
count it reads at each replay, where a value computed on the host would
be frozen at its capture-time value. Parameters, ``mu`` and ``nu`` are
updated in place: the port's counterpart of the JAX step's buffer
donation.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from ray_tpu_torch.parallel.sharding import local


@dataclass
class AdamWState:
    count: torch.Tensor           # float32 scalar on the parameters' device
    mu: list[torch.Tensor]
    nu: list[torch.Tensor]


class AdamW:
    def __init__(self, lr: float, b1: float, b2: float, eps: float,
                 weight_decay: float, mu_dtype: torch.dtype | None):
        self.lr = lr
        self.b1 = b1
        self.b2 = b2
        self.eps = eps
        self.weight_decay = weight_decay
        self.mu_dtype = mu_dtype

    def init(self, params) -> AdamWState:
        """Zero moments for ``params`` (a module or a list of tensors)."""
        params = _as_list(params)
        device = params[0].device if params else None
        return AdamWState(
            count=torch.zeros((), dtype=torch.float32, device=device),
            mu=[torch.zeros_like(p, dtype=self.mu_dtype or p.dtype)
                for p in params],
            nu=[torch.zeros_like(p) for p in params])

    @torch.no_grad()
    def update(self, grads, state: AdamWState, params) -> None:
        """One AdamW step: updates ``params`` and ``state`` in place."""
        params = _as_list(params)
        grads = [local(g) for g in grads]
        b1, b2 = self.b1, self.b2
        state.count.add_(1)
        # 1 - decay**count in float32 on the device, as optax computes it.
        bc1 = 1 - torch.pow(b1, state.count)
        bc2 = 1 - torch.pow(b2, state.count)
        for p, g, mu, nu in zip(params, grads, state.mu, state.nu):
            if g is None:
                g = torch.zeros_like(p)
            m32 = g * (1 - b1)
            m32 += mu * _round_to(b1, mu.dtype)
            nu.mul_(b2).add_(g.square().mul_(1 - b2))
            u = (m32 / bc1).div_((nu / bc2).sqrt_().add_(self.eps))
            u.add_(p, alpha=self.weight_decay)
            p.add_(u, alpha=-self.lr)
            mu.copy_(m32)


def adamw(lr: float, b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8,
          weight_decay: float = 1e-4,
          mu_dtype: torch.dtype | None = None) -> AdamW:
    """optax.adamw's defaults and semantics; see the module docstring."""
    return AdamW(lr, b1, b2, eps, weight_decay, mu_dtype)


@dataclass
class SGDState:
    trace: list[torch.Tensor] | None


class SGD:
    """optax.sgd: ``chain(trace(momentum, nesterov), scale_by_learning_rate)``.

    Per parameter ``p`` with gradient ``g`` and trace ``t`` (zeros at
    first, in the parameter's type):

        t = g + momentum * t
        u = g + momentum * t   if nesterov, else t
        p = p + (-lr) * u

    Every parameter takes the update (optax has no mask here), BatchNorm
    scale and bias included. Without momentum, ``u = g`` and no trace is
    kept. Parameters and traces are updated in place. Nothing depends on
    the step count, so no host-side value changes from step to step and a
    captured step replays it as it is."""

    def __init__(self, lr: float, momentum: float | None, nesterov: bool):
        self.lr = lr
        self.momentum = momentum
        self.nesterov = nesterov

    def init(self, params) -> SGDState:
        if self.momentum is None:
            return SGDState(trace=None)
        return SGDState(trace=[torch.zeros_like(p) for p in _as_list(params)])

    @torch.no_grad()
    def update(self, grads, state: SGDState, params) -> None:
        """One SGD step: updates ``params`` and ``state`` in place."""
        params = _as_list(params)
        grads = [local(g) for g in grads]
        traces = state.trace or [None] * len(params)
        for p, g, t in zip(params, grads, traces):
            if g is None:
                g = torch.zeros_like(p)
            u = g
            if t is not None:
                t.mul_(self.momentum).add_(g)
                u = g + self.momentum * t if self.nesterov else t
            p.add_(u, alpha=-self.lr)


def sgd(lr: float, momentum: float | None = None,
        nesterov: bool = False) -> SGD:
    """optax.sgd's defaults and semantics; see :class:`SGD`."""
    return SGD(lr, momentum, nesterov)


@dataclass
class RMSPropState:
    nu: list[torch.Tensor]


class RMSProp:
    """optax.rmsprop(lr, decay, eps) with its defaults (``initial_scale=0``,
    ``eps_in_sqrt=True``, no centring, momentum or bias correction):
    ``chain(scale_by_rms, scale_by_learning_rate)``. Per parameter ``p``
    with gradient ``g``:

        nu = (1 - decay) * g² + decay * nu     # float32, zeros at first
        p  = p + (-lr) * (g * rsqrt(nu + eps))

    ``torch.optim.RMSprop`` divides by ``sqrt(nu) + eps`` instead, which is
    another optimizer wherever ``eps`` is not negligible beside ``nu``
    (IMPALA's ``eps = 0.1``). Nothing depends on the step count, so a
    captured step replays it as it is; ``nu`` and the parameters are
    updated in place."""

    def __init__(self, lr: float, decay: float, eps: float):
        self.lr = lr
        self.decay = decay
        self.eps = eps

    def init(self, params) -> RMSPropState:
        return RMSPropState(nu=[torch.zeros_like(p) for p in _as_list(params)])

    @torch.no_grad()
    def update(self, grads, state: RMSPropState, params) -> None:
        """One RMSProp step: updates ``params`` and ``state`` in place."""
        params = _as_list(params)
        grads = [local(g) for g in grads]
        for p, g, nu in zip(params, grads, state.nu):
            if g is None:
                g = torch.zeros_like(p)
            nu.copy_(g.square().mul_(1 - self.decay).add_(nu * self.decay))
            p.add_(g * torch.rsqrt(nu + self.eps), alpha=-self.lr)


def rmsprop(lr: float, decay: float = 0.9, eps: float = 1e-8) -> RMSProp:
    """optax.rmsprop's defaults and semantics; see :class:`RMSProp`."""
    return RMSProp(lr, decay, eps)


class ClipByGlobalNorm:
    """optax.clip_by_global_norm(max_norm): each gradient ``g`` becomes

        where(norm < max_norm, g, g / norm * max_norm)

    with ``norm`` the global norm of all of them, computed on their
    device: no value goes to the host, so a captured step replays the
    clip with each replay's norm. It keeps no state. It transforms
    gradients and updates no parameter: it is a link of :func:`chain`."""

    def __init__(self, max_norm: float):
        self.max_norm = max_norm

    def init(self, params) -> None:
        return None

    @torch.no_grad()
    def transform(self, grads, state) -> list:
        grads = [local(g) for g in grads]
        norm = global_norm(grads)
        keep = norm < self.max_norm
        return [None if g is None else
                torch.where(keep, g, g / norm.to(g.dtype) * self.max_norm)
                for g in grads]


def clip_by_global_norm(max_norm: float) -> ClipByGlobalNorm:
    """optax.clip_by_global_norm's semantics; see :class:`ClipByGlobalNorm`."""
    return ClipByGlobalNorm(max_norm)


class Chain:
    """optax.chain of gradient transforms ending in an optimizer:
    ``chain(clip_by_global_norm(0.5), adamw(lr, weight_decay=0))`` is
    ``optax.chain(clip_by_global_norm(0.5), adam(lr))``. The state is the
    list of the links' states; ``update`` passes the gradients through
    each transform in turn, then the last link updates the parameters in
    place."""

    def __init__(self, *links):
        self.links = links

    def init(self, params) -> list:
        return [link.init(params) for link in self.links]

    @torch.no_grad()
    def update(self, grads, state: list, params) -> None:
        for link, st in zip(self.links[:-1], state[:-1]):
            grads = link.transform(grads, st)
        self.links[-1].update(grads, state[-1], params)


def chain(*links) -> Chain:
    """optax.chain: every link but the last transforms the gradients
    (:func:`clip_by_global_norm`), the last is an optimizer (:func:`adamw`,
    :func:`sgd`, :func:`rmsprop`)."""
    return Chain(*links)


def global_norm(tensors) -> torch.Tensor:
    """sqrt of the sum of squares of every element (optax.global_norm),
    over each tensor's local part (``collective.device.global_norm``
    takes a norm over shards)."""
    norms = [torch.linalg.vector_norm(local(t).float()) for t in tensors
             if t is not None]
    return torch.linalg.vector_norm(torch.stack(norms))


def _round_to(x: float, dtype: torch.dtype) -> float:
    """``x`` rounded to ``dtype``: JAX casts a Python scalar to the type
    of the array it multiplies, so optax's ``b1 * mu`` with a bf16 ``mu``
    uses b1 = 0.8984375, not 0.9."""
    return torch.tensor(x, dtype=dtype).item()


def _as_list(params) -> list[torch.Tensor]:
    """The tensors to update: a module's parameters, or a list; each
    parameter that FSDP2 shards is its local shard (what this rank
    updates)."""
    if isinstance(params, torch.nn.Module):
        params = params.parameters()
    return [local(p) for p in params]
