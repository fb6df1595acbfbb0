"""The port's RLlib networks (``ray_tpu_torch.rllib.catalog`` and
``.models``) against the JAX package's flax modules, on shared weights.

Each flax module's own ``init_params(jax.random.key(0))`` is carried into
the port's module by ``load_jax_params``; both get the same numpy-seeded
inputs on the CPU, in float32.

Tolerance: LOGIT_TOL = 1e-5 absolute on every output (logits, values, Q
values, the gaussian's mean and log-std, GRU carries), which are O(1)
here: only the order of float32 sums differs between XLA and PyTorch.
The image inputs are uniform in [0, 1), so the CNN's features stay O(1)
too. The planted faults below (flattening the CNN's maps in NCHW order,
an even split of SAME padding, the GRU's ``hn`` bias on the input side)
each move an output far past that limit.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
pytest.importorskip("flax")

from ray_tpu.rllib import catalog as jcat  # noqa: E402
from ray_tpu.rllib import models as jmodels  # noqa: E402
from ray_tpu_torch.models import resnet as resnet_mod  # noqa: E402
from ray_tpu_torch.rllib import catalog as cat  # noqa: E402
from ray_tpu_torch.rllib import models as tmodels  # noqa: E402

LOGIT_TOL = 1e-5
NATURE = ((32, 8, 4), (64, 4, 2), (64, 3, 1))


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One torch thread for the module, as every test_torch_* file."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _inputs(shape, seed=0, image=False):
    rng = np.random.default_rng(seed)
    x = rng.random(shape) if image else rng.standard_normal(shape)
    return x.astype(np.float32)


def _err(a, b) -> float:
    return float(np.abs(np.asarray(a) - np.asarray(b)).max())


def _actor_critic(cfg):
    jm = jcat.build_actor_critic(cfg)
    params = jm.init_params(jax.random.key(0))
    model = cat.build_actor_critic(cfg, device="cpu")
    model.load_jax_params(_np(params))
    return jm, params, model


def _check_actor_critic(cfg, obs):
    jm, params, model = _actor_critic(cfg)
    jl, jv = jm.apply({"params": params}, obs)
    with torch.no_grad():
        tl, tv = model(torch.from_numpy(obs))
    assert tl.shape == jl.shape and tv.shape == jv.shape
    assert _err(tl, jl) < LOGIT_TOL, _err(tl, jl)
    assert _err(tv, jv) < LOGIT_TOL, _err(tv, jv)


@pytest.mark.parametrize("activation", ["tanh", "relu", "gelu"])
def test_mlp_actor_critic_matches_flax(activation):
    _check_actor_critic({"obs_dim": 6, "num_actions": 3, "hidden": (16, 8),
                         "activation": activation}, _inputs((5, 6)))


def test_cnn_default_filters_with_uneven_same_padding():
    """84x84x4 with the default filters: the second conv (k 3, s 2 from
    42) pads (0, 1)."""
    assert resnet_mod.same_pads(42, 3, 2) == (0, 1)
    cfg = {"obs_shape": (84, 84, 4), "num_actions": 6}
    assert isinstance(cat.build_encoder(cfg, device="cpu"), cat.CNNEncoder)
    _check_actor_critic(cfg, _inputs((3, 84, 84, 4), image=True))


def test_cnn_nature_filters_at_full_width():
    """The chip phase's model: Nature-DQN filters, maps 21, 11 and 11,
    the first dense layer 7744 x 512 (about 4.0 M parameters)."""
    cfg = {"obs_shape": (84, 84, 4), "num_actions": 6,
           "conv_filters": NATURE, "hidden": (512,)}
    jm, params, model = _actor_critic(cfg)
    assert model.encoder.fc0.weight.shape == (512, 7744)
    n = sum(p.numel() for p in model.parameters())
    assert n == sum(x.size for x in jax.tree_util.tree_leaves(params))
    assert 3.9e6 < n < 4.1e6
    obs = _inputs((2, 84, 84, 4), image=True)
    jl, jv = jm.apply({"params": params}, obs)
    with torch.no_grad():
        tl, tv = model(torch.from_numpy(obs))
    assert _err(tl, jl) < LOGIT_TOL and _err(tv, jv) < LOGIT_TOL


def test_q_network_matches_flax():
    cfg = {"obs_dim": 5, "num_actions": 4, "hidden": (8, 8)}
    jm = jcat.build_q_network(cfg)
    params = jm.init_params(jax.random.key(1))
    model = cat.build_q_network(cfg, device="cpu")
    model.load_jax_params(_np(params))
    obs = _inputs((3, 5))
    with torch.no_grad():
        q = model(torch.from_numpy(obs))
    assert _err(q, jm.apply({"params": params}, obs)) < LOGIT_TOL


def test_models_module_networks_match_flax():
    """``models.ActorCritic``, ``QNetwork``, ``SquashedGaussianActor``
    and ``TwinQ``."""
    obs = _inputs((4, 3))
    act = _inputs((4, 2), seed=1)
    ac = jmodels.ActorCriticConfig(obs_dim=3, num_actions=2, hidden=(8, 8))
    cc = jmodels.ContinuousConfig(obs_dim=3, action_dim=2, hidden=(8, 8))
    tac = tmodels.ActorCriticConfig(obs_dim=3, num_actions=2, hidden=(8, 8))
    tcc = tmodels.ContinuousConfig(obs_dim=3, action_dim=2, hidden=(8, 8))
    pairs = [(jmodels.ActorCritic(ac), tmodels.ActorCritic(tac, "cpu"),
              (obs,)),
             (jmodels.QNetwork(ac), tmodels.QNetwork(tac, "cpu"), (obs,)),
             (jmodels.SquashedGaussianActor(cc),
              tmodels.SquashedGaussianActor(tcc, "cpu"), (obs,)),
             (jmodels.TwinQ(cc), tmodels.TwinQ(tcc, "cpu"), (obs, act))]
    for jm, tm, args in pairs:
        params = jm.init_params(jax.random.key(0))
        tm.load_jax_params(_np(params))
        want = jm.apply({"params": params}, *args)
        with torch.no_grad():
            got = tm(*(torch.from_numpy(a) for a in args))
        want = want if isinstance(want, tuple) else (want,)
        got = got if isinstance(got, tuple) else (got,)
        for g, w in zip(got, want):
            assert _err(g, w) < LOGIT_TOL, (type(tm).__name__, _err(g, w))


def test_gaussian_sample_is_the_reparameterized_tanh_gaussian():
    """``sample`` draws from a torch.Generator (not the JAX key stream):
    held against the formula on the noise it drew."""
    mu = torch.tensor([[0.3, -0.2]])
    log_std = torch.tensor([[-0.5, 0.1]])
    gen = torch.Generator().manual_seed(3)
    a, logp = tmodels.SquashedGaussianActor.sample(mu, log_std, gen)
    eps = torch.randn(mu.shape, generator=torch.Generator().manual_seed(3))
    pre = mu + torch.exp(log_std) * eps
    assert torch.equal(a, torch.tanh(pre))
    want = (-0.5 * (eps ** 2 + 2 * log_std + np.log(2 * np.pi))).sum(-1) \
        - torch.log(1 - torch.tanh(pre) ** 2 + 1e-6).sum(-1)
    torch.testing.assert_close(logp, want)


def _recurrent():
    cfg = {"obs_dim": 3, "num_actions": 2, "hidden": (8,),
           "hidden_state": 6}
    jm = jcat.build_recurrent_actor_critic(cfg)
    params = jm.init_params(jax.random.key(0))
    model = cat.build_recurrent_actor_critic(cfg, device="cpu")
    model.load_jax_params(_np(params))
    return jm, params, model


def test_gru_step_seq_and_carries_match_flax():
    jm, params, model = _recurrent()
    obs = _inputs((2, 7, 3))
    c0 = _inputs((2, 6), seed=2) * 0.5
    jl, jv, jc = jm.apply({"params": params}, obs, c0,
                          method="seq_with_carries")
    with torch.no_grad():
        tl, tv, tc = model.seq_with_carries(torch.from_numpy(obs),
                                            torch.from_numpy(c0))
        sl, sv = model.seq(torch.from_numpy(obs), torch.from_numpy(c0))
        c = torch.from_numpy(c0)
        stepped = []
        for t in range(7):
            lt, vt, c = model.step(torch.from_numpy(obs[:, t]), c)
            stepped.append(lt)
    for got, want in ((tl, jl), (tv, jv), (tc, jc), (sl, jl), (sv, jv)):
        assert _err(got, want) < LOGIT_TOL, _err(got, want)
    # step and seq agree (tests/test_rllib_recurrent.py:14)
    assert _err(torch.stack(stepped, 1), sl) < LOGIT_TOL
    jst = jm.apply({"params": params}, obs[:, 0], c0)
    with torch.no_grad():
        tst = model(torch.from_numpy(obs[:, 0]), torch.from_numpy(c0))
    for got, want in zip(tst, jst):
        assert _err(got, want) < LOGIT_TOL


def test_gru_cell_is_torch_gru_cell_with_the_mapped_biases():
    """``torch.nn.GRUCell`` with rows (r, z, n), ``b_ih = [ir.b, iz.b,
    in.b]`` and ``b_hh = [0, 0, hn.b]`` computes the port's cell."""
    _, _, model = _recurrent()
    g = model.gru
    m = g._modules
    ref = torch.nn.GRUCell(8, 6)
    with torch.no_grad():
        ref.weight_ih.copy_(torch.cat([m[k].weight for k in ("ir", "iz",
                                                             "in")]))
        ref.weight_hh.copy_(torch.cat([m[k].weight for k in ("hr", "hz",
                                                             "hn")]))
        ref.bias_ih.copy_(torch.cat([m[k].bias for k in ("ir", "iz",
                                                         "in")]))
        ref.bias_hh.copy_(torch.cat([torch.zeros(12), m["hn"].bias]))
        x = torch.from_numpy(_inputs((4, 8)))
        h = torch.from_numpy(_inputs((4, 6), seed=1))
        assert _err(ref(x, h), g(h, x)[0]) < LOGIT_TOL


def test_custom_encoder_through_register_encoder():
    """The same name registered in both packages' registries, each with
    its own framework's module."""
    from flax import linen as nn

    class JaxTiny(nn.Module):
        @nn.compact
        def __call__(self, obs):
            return nn.relu(nn.Dense(4, name="fc0")(obs))

    class TorchTiny(torch.nn.Module):
        def __init__(self, cfg):
            super().__init__()
            self.fc0 = torch.nn.Linear(cfg["obs_dim"], 4)

        def forward(self, obs):
            return torch.relu(self.fc0(obs))

    calls = []
    jcat.register_encoder("tiny_parity", lambda cfg: JaxTiny())
    cat.register_encoder("tiny_parity",
                         lambda cfg: calls.append(cfg["obs_dim"])
                         or TorchTiny(cfg))
    _check_actor_critic({"obs_dim": 7, "num_actions": 2,
                         "encoder": "tiny_parity"}, _inputs((3, 7)))
    assert calls == [7]


def test_unknown_encoder_raises_before_any_device():
    with pytest.raises(ValueError, match="unknown encoder"):
        cat.build_encoder({"obs_dim": 3, "encoder": "nope"})


# -- planted faults: each must fail the tolerance ------------------------


def _cnn_error(cfg, obs) -> float:
    """The larger error of the logits and the values (the value head's
    orthogonal scale 1.0 shows a fault better than the policy's 0.01)."""
    jm, params, model = _actor_critic(cfg)
    jl, jv = jm.apply({"params": params}, obs)
    with torch.no_grad():
        tl, tv = model(torch.from_numpy(obs))
    return max(_err(tl, jl), _err(tv, jv))


def test_nchw_flatten_order_fails_the_tolerance(monkeypatch):
    def nchw(self, obs):
        act = cat._ACTIVATIONS[self.activation]
        x = obs.to(self.dtype).permute(0, 3, 1, 2)
        for i in range(len(self.conv_filters)):
            x = act(getattr(self, f"conv{i}")(x))
        x = x.reshape(x.shape[0], -1)             # NCHW order
        for i in range(len(self.hidden)):
            x = act(getattr(self, f"fc{i}")(x))
        return x

    monkeypatch.setattr(cat.CNNEncoder, "forward", nchw)
    cfg = {"obs_shape": (84, 84, 4), "num_actions": 6}
    err = _cnn_error(cfg, _inputs((3, 84, 84, 4), image=True))
    assert err > 100 * LOGIT_TOL, err


def test_even_same_padding_fails_the_tolerance(monkeypatch):
    same = resnet_mod.same_pads

    def even(size, kernel, stride):
        lo, hi = same(size, kernel, stride)
        return (hi, hi)

    monkeypatch.setattr(resnet_mod, "same_pads", even)
    cfg = {"obs_shape": (84, 84, 4), "num_actions": 6}
    err = _cnn_error(cfg, _inputs((3, 84, 84, 4), image=True))
    assert err > 100 * LOGIT_TOL, err


def test_hn_bias_on_the_input_side_fails_the_tolerance(monkeypatch):
    def input_side(self, carry, x):
        m = self._modules
        r = torch.sigmoid(m["ir"](x) + m["hr"](carry))
        z = torch.sigmoid(m["iz"](x) + m["hz"](carry))
        hn = torch.nn.functional.linear(carry, m["hn"].weight)
        n = torch.tanh(m["in"](x) + m["hn"].bias + r * hn)
        h = (1.0 - z) * n + z * carry
        return h, h

    jm, params, model = _recurrent()
    # flax initialises biases at zero: give hn's bias a value first.
    params = _np(params)
    params["gru"]["hn"]["bias"] = _inputs((6,), seed=5)
    model.load_jax_params(params)
    monkeypatch.setattr(cat.GRUCell, "forward", input_side)
    obs, c0 = _inputs((2, 7, 3)), _inputs((2, 6), seed=2)
    *_, jc = jm.apply({"params": params}, obs, c0,
                      method="seq_with_carries")
    with torch.no_grad():
        *_, tc = model.seq_with_carries(torch.from_numpy(obs),
                                        torch.from_numpy(c0))
    assert _err(tc, jc) > 100 * LOGIT_TOL, _err(tc, jc)
