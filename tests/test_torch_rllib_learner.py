"""The port's PPO learner (``ray_tpu_torch.rllib.learner``) against the
JAX package's, on shared weights, on the CPU.

Each JAX learner's own initial parameters are carried into the port's
learner by ``load_jax_params``; both get the same numpy-seeded episodes.

Tolerances. The loss and its three terms within 1e-6 relative or 1e-7
absolute (the policy term is a mean of O(1) terms that nearly cancel to
~1e-3, so its relative error is larger), and each
gradient within 1e-5 of its JAX counterpart's largest entry: at the same
weights only the order of float32 sums differs. GAE and
``compute_advantages`` run the same numpy code in both packages: their
arrays are bit-equal (the recurrent learner's ``carry0``, which its
model computes, within 1e-6). After 1 and after 5 updates of
``clip_by_global_norm(0.5)`` then Adam (lr 3e-4), every parameter within
PARAM_TOL = 1e-6 of optax's: updates move entries by up to 1.5e-3, and
Adam divides each gradient entry by its own running RMS, which turns
rounding noise in a near-zero gradient into a larger step, but these
gradients have no such entries and the parameters agree to ~6e-8. The
five updates run on five different minibatches, whose gradient norms
differ, so the clip's factor changes from update to update: clipping the
Adam update instead of the gradient (the planted fault) is then not the
same trajectory (Adam alone is blind to one constant factor), and it
lands ~2.5e-4 from optax's, far past PARAM_TOL.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
pytest.importorskip("flax")
optax = pytest.importorskip("optax")
import jax.numpy as jnp  # noqa: E402

from ray_tpu.rllib.env_runner import Episode  # noqa: E402
from ray_tpu.rllib.learner import (  # noqa: E402
    JaxLearner,
    PPOHyperparams as JaxHP,
    RecurrentJaxLearner,
)
from ray_tpu_torch.rllib.learner import (  # noqa: E402
    PPOHyperparams,
    RecurrentTorchLearner,
    TorchLearner,
)
from ray_tpu_torch.train import optim  # noqa: E402
from torch_rllib_programs import torch_names  # noqa: E402

CFG = {"obs_dim": 4, "num_actions": 3, "hidden": (16, 16)}
RCFG = {"obs_dim": 2, "num_actions": 3, "hidden": (8,), "hidden_state": 8}
LOSS_RTOL = 1e-6
LOSS_ATOL = 1e-7
GRAD_TOL = 1e-5
PARAM_TOL = 1e-6


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One torch thread for the module, as every test_torch_* file."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def episodes(seed: int, n: int = 64, obs_dim: int = 4, actions: int = 3,
             scale: float = 3.0, parts: int = 1) -> list:
    rng = np.random.default_rng(seed)
    out = []
    for i, m in enumerate(np.array_split(np.arange(n), parts)):
        out.append(Episode(
            obs=list(rng.standard_normal((len(m), obs_dim))
                     .astype(np.float32)),
            actions=list(rng.integers(0, actions, len(m))),
            rewards=list(rng.standard_normal(len(m)) * scale),
            logps=list(np.full(len(m), -np.log(actions))),
            values=list(rng.standard_normal(len(m)) * 0.1),
            terminated=i % 2 == 0, last_value=0.0 if i % 2 == 0 else 0.5))
    return out


def pair(jax_cls=JaxLearner, torch_cls=TorchLearner, cfg=CFG, **hp):
    kw = {"max_seq_len": 4} if jax_cls is RecurrentJaxLearner else {}
    jl = jax_cls(cfg, JaxHP(**hp), **kw)
    tl = torch_cls(cfg, PPOHyperparams(**hp), device="cpu", **kw)
    tl.model.load_jax_params(jax.tree_util.tree_map(np.asarray, jl.params))
    return jl, tl


def param_error(jl, tl) -> float:
    want = torch_names(jax.tree_util.tree_map(np.asarray, jl.params))
    assert set(want) == set(tl.params)
    return max(float(np.abs(want[k] - p.detach().numpy()).max())
               for k, p in tl.params.items())


def _loss_and_grads(jl, tl, batch):
    (total, (pi, vf, ent)), grads = jax.value_and_grad(
        jl._loss_with_aux, has_aux=True)(
            jl.params, {k: jnp.asarray(v) for k, v in batch.items()})
    tbatch = {k: torch.from_numpy(v) for k, v in batch.items()}
    ttotal, aux = tl._loss(tl.model, tbatch)
    tgrads, metrics = tl.compute_grads(tl.params, batch)
    for got, want in ((ttotal, total), (aux["policy_loss"], pi),
                      (metrics["vf_loss"], vf), (metrics["entropy"], ent)):
        np.testing.assert_allclose(float(got.detach()), float(want),
                                   rtol=LOSS_RTOL, atol=LOSS_ATOL)
    want = torch_names(jax.tree_util.tree_map(np.asarray, grads))
    assert set(want) == set(tgrads)
    for k, g in tgrads.items():
        scale = float(np.abs(want[k]).max())
        err = float(np.abs(g.numpy() - want[k]).max())
        assert err <= GRAD_TOL * scale, (k, err, scale)


def test_ppo_loss_and_every_gradient_match_jax():
    jl, tl = pair()
    _loss_and_grads(jl, tl, jl.compute_advantages(episodes(0)))


def test_gae_and_advantages_are_bit_equal():
    jl, tl = pair(gamma=0.97, gae_lambda=0.9)
    eps = episodes(3, n=50, parts=3)
    for ep in eps:
        np.testing.assert_array_equal(tl._gae(ep), jl._gae(ep))
    want, got = jl.compute_advantages(eps), tl.compute_advantages(eps)
    assert list(got) == list(want)
    for k in want:
        assert got[k].dtype == want[k].dtype
        np.testing.assert_array_equal(got[k], want[k])


@pytest.mark.parametrize("clip", [0.5, 1e6], ids=["clip_engaged",
                                                   "clip_idle"])
@pytest.mark.parametrize("updates", [1, 5])
def test_updates_match_optax_chain(updates, clip):
    """``updates`` Adam steps on ``updates`` minibatches of 64 rows."""
    jl, tl = pair(num_epochs=1, minibatch_size=64, max_grad_norm=clip)
    eps = episodes(1, n=64 * updates)
    batch = jl.compute_advantages(eps)
    grads, _ = jl.compute_grads(jl.params, {k: jnp.asarray(v[:64])
                                            for k, v in batch.items()})
    norm = float(optax.global_norm(grads))
    assert (norm > clip) == (clip == 0.5), norm       # engaged / idle
    jm = jl.update_from_episodes(eps)
    tm = tl.update_from_episodes(eps)
    assert list(tm) == ["total_loss", "policy_loss", "vf_loss", "entropy"]
    for k in jm:
        np.testing.assert_allclose(tm[k], jm[k], rtol=LOSS_RTOL,
                                   atol=LOSS_ATOL)
    assert float(tl.opt_state["count"]) == updates
    assert param_error(jl, tl) <= PARAM_TOL


def test_clip_by_global_norm_is_optax_arithmetic():
    rng = np.random.default_rng(4)
    grads = [rng.standard_normal(s).astype(np.float32)
             for s in ((5, 3), (3,), (2, 2, 2))]
    for max_norm in (0.5, 1e3):
        want, _ = optax.clip_by_global_norm(max_norm).update(
            [jnp.asarray(g) for g in grads], None)
        got = optim.clip_by_global_norm(max_norm).transform(
            [torch.from_numpy(g) for g in grads], None)
        for g, w in zip(got, want):
            np.testing.assert_allclose(g.numpy(), np.asarray(w),
                                       rtol=1e-6, atol=0)


def test_clipping_after_adam_fails_the_tolerance(monkeypatch):
    """The planted fault: Adam on the raw gradients, then the update
    clipped by its global norm (which is idle at these norms)."""
    def clip_after(self, grads, state, params):
        before = [p.detach().clone() for p in params]
        self.links[-1].update(grads, state[-1], params)
        deltas = [p - b for p, b in zip(params, before)]
        clipped = self.links[0].transform(deltas, None)
        with torch.no_grad():
            for p, b, d in zip(params, before, clipped):
                p.copy_(b + d)

    jl, tl = pair(num_epochs=1, minibatch_size=64, max_grad_norm=0.5)
    monkeypatch.setattr(optim.Chain, "update", clip_after)
    eps = episodes(1, n=64 * 5)
    jl.update_from_episodes(eps)
    tl.update_from_episodes(eps)
    assert param_error(jl, tl) > 100 * PARAM_TOL


def _recurrent_episode(seed: int, n: int) -> Episode:
    rng = np.random.default_rng(seed)
    return Episode(
        obs=list(rng.standard_normal((n, 2)).astype(np.float32)),
        actions=list(rng.integers(0, 3, n)),
        rewards=list(rng.standard_normal(n)), logps=list(np.full(n, -1.1)),
        values=list(rng.standard_normal(n) * 0.1), terminated=True,
        state_in=np.zeros(8, np.float32))


def test_recurrent_loss_gradients_and_one_update_match_jax():
    """Segments of 4 over episodes of 11 and 6 steps (carries replayed by
    the model at segment boundaries), then one update of all segments."""
    jl, tl = pair(RecurrentJaxLearner, RecurrentTorchLearner, RCFG,
                  num_epochs=1, minibatch_size=64)
    eps = [_recurrent_episode(0, 11), _recurrent_episode(1, 6)]
    want, got = jl.compute_advantages(eps), tl.compute_advantages(eps)
    assert got["obs"].shape == want["obs"].shape == (5, 4, 2)
    for k in want:
        if k == "carry0":
            np.testing.assert_allclose(got[k], want[k], rtol=0, atol=1e-6)
        else:
            np.testing.assert_array_equal(got[k], want[k])
    _loss_and_grads(jl, tl, want)
    jl.update_from_episodes(eps)
    tl.update_from_episodes(eps)
    assert param_error(jl, tl) <= PARAM_TOL
    assert tl.compile_count is None         # eager on the CPU


def test_weights_round_trip_and_state_copy_in_place():
    _, tl = pair()
    ptrs = [p.data_ptr() for p in tl.params.values()]
    w = tl.get_weights()
    assert all(t.device.type == "cpu" for t in w.values())
    tl.set_weights({k: v + 1 for k, v in w.items()})
    tl.opt_state = {"count": np.float32(3.0),
                    "mu": [np.ones(p.shape, np.float32)
                           for p in tl.params.values()],
                    "nu": [np.ones(p.shape, np.float32)
                           for p in tl.params.values()]}
    assert [p.data_ptr() for p in tl.params.values()] == ptrs
    assert all(torch.equal(tl.params[k], w[k] + 1) for k in w)
    assert float(tl.opt_state["count"]) == 3.0


def test_learner_refuses_to_run_without_a_card():
    with pytest.raises(RuntimeError, match="no CUDA device"):
        TorchLearner(CFG)
