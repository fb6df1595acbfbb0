"""The port's Dreamer (``ray_tpu_torch.rllib.dreamer``) against the JAX
package's, on the CPU, from the same weights and JAX's own noise.

The JAX module draws every categorical sample as
``jax.random.categorical(key, logits)``, which is ``argmax(logits +
gumbel(key, logits.shape))`` (checked below); the port's module takes the
Gumbel noise as a tensor, so the test draws it from the JAX keys exactly
as the JAX functions split them: ``observe`` splits its key into T step
keys; the imagination splits its key into ``horizon`` step keys and each
into the action's and the prior sample's.

Tolerances: the module's outputs (``observe``, ``img_step``, ``heads``,
``rollout_step``) within 1e-5 (absolute, on values of order 1); the
losses within 1e-6 relative or 1e-7 absolute, each gradient within 1e-5
of its JAX counterpart's largest entry, the parameters after one update
of the world model and one of the actor-critic within 1e-6 (the
tolerances of tests/test_torch_rllib_learner.py). The planted fault: the advantages normalised by the
unbiased standard deviation where ``jnp.std`` is the population one,
which the actor's loss fails (with rewards large enough that the std
passes 1, where the normalisation engages).
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
pytest.importorskip("flax")
pytest.importorskip("optax")
import jax.numpy as jnp  # noqa: E402

from ray_tpu.rllib import dreamer as jd  # noqa: E402
from ray_tpu_torch.rllib import dreamer as td  # noqa: E402
from torch_rllib_programs import torch_names  # noqa: E402

MODULE_TOL = 1e-5
LOSS_RTOL = 1e-6
LOSS_ATOL = 1e-7
GRAD_TOL = 1e-5
PARAM_TOL = 1e-6
CFG = dict(obs_dim=6, num_actions=2, embed=16, deter=16, n_cat=4,
           n_classes=4, hidden=16)
B, T, H = 3, 5, 4


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One torch thread for the module, as every test_torch_* file."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _t(x):
    return torch.from_numpy(np.array(x))


def pair(**hp):
    hp = {"batch_size": B, "seq_len": T, "horizon": H, **hp}
    jl = jd.DreamerLearner(jd.DreamerModelConfig(**CFG),
                           jd.DreamerHyperparams(**hp), seed=0)
    tl = td.DreamerLearner(td.DreamerModelConfig(**CFG),
                           td.DreamerHyperparams(**hp), device="cpu")
    tl.load_jax_params(_np(jl.params))
    return jl, tl


def batch(seed: int = 0, reward_scale: float = 1.0) -> dict:
    """A [B, T] world-model batch: one-hot chain observations, episode
    starts at step 0 of the first row and mid-row in the second, a
    terminal (cont 0) then padding in the third."""
    rng = np.random.default_rng(seed)
    obs = np.eye(CFG["obs_dim"], dtype=np.float32)[
        rng.integers(0, CFG["obs_dim"], (B, T))]
    cont = np.ones((B, T), np.float32)
    cont[2, 2:] = 0.0
    first = np.zeros((B, T), np.float32)
    first[0, 0] = first[1, 3] = 1.0
    return {"obs": obs, "actions": rng.integers(0, 2, (B, T)).astype(
                np.int32),
            "rewards": (rng.standard_normal((B, T)) * reward_scale)
            .astype(np.float32),
            "cont": cont, "is_first": first}


def observe_noise(key) -> np.ndarray:
    c = CFG
    return np.stack([np.asarray(jax.random.gumbel(
        k, (B, c["n_cat"], c["n_classes"]))) for k in jax.random.split(
            key, T)])


def imagine_noise(key, n: int) -> tuple[np.ndarray, np.ndarray]:
    c = CFG
    ga, gz = [], []
    for k in jax.random.split(key, H):
        k_a, k_z = jax.random.split(k)
        ga.append(np.asarray(jax.random.gumbel(k_a, (n, c["num_actions"]))))
        gz.append(np.asarray(jax.random.gumbel(
            k_z, (n, c["n_cat"], c["n_classes"]))))
    return np.stack(ga), np.stack(gz)


def close(got, want, tol=MODULE_TOL) -> None:
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    np.testing.assert_allclose(got, np.asarray(want), rtol=0, atol=tol)


def test_categorical_is_argmax_of_logits_plus_gumbel():
    logits = jnp.asarray(np.random.default_rng(0).standard_normal(
        (64, 4, 5)), jnp.float32)
    key = jax.random.key(3)
    want = jax.random.categorical(key, logits, axis=-1)
    got = jnp.argmax(logits + jax.random.gumbel(key, logits.shape), -1)
    np.testing.assert_array_equal(np.asarray(got), np.asarray(want))


def test_symlog_symexp_unimix_kl_match_jax():
    x = np.asarray([-100.0, -1.0, 0.0, 0.5, 30.0], np.float32)
    close(td.symlog(_t(x)), jd.symlog(jnp.asarray(x)), 1e-6)
    close(td.symexp(td.symlog(_t(x))), x, 1e-4)
    logits = np.random.default_rng(1).standard_normal((3, 16)).astype(
        np.float32) * 4
    cfg = jd.DreamerModelConfig(**CFG)
    a = jd._unimix_logits(jnp.asarray(logits), cfg)
    got = td._unimix_logits(_t(logits), td.DreamerModelConfig(**CFG))
    close(got, a, 1e-6)
    b = jd._unimix_logits(jnp.asarray(logits[::-1].copy()), cfg)
    close(td._kl_cat(got, _t(np.asarray(b))), jd._kl_cat(a, b), 1e-6)
    close(td._mode(got), jd._mode(a), 0)


def test_observe_matches_the_flax_module():
    jl, tl = pair()
    mb = batch(0)
    key = jax.random.key(5)
    want = jl.module.apply({"params": jl.params}, jnp.asarray(mb["obs"]),
                           jnp.asarray(mb["actions"]),
                           jnp.asarray(mb["is_first"]), key,
                           method="observe")
    with torch.no_grad():
        got = tl.module.observe(_t(mb["obs"]), _t(mb["actions"]),
                                _t(mb["is_first"]), _t(observe_noise(key)))
    assert set(got) == set(want)
    for k in want:
        assert tuple(got[k].shape) == want[k].shape, k
        close(got[k], want[k])


def test_img_step_heads_and_rollout_step_match_the_flax_module():
    jl, tl = pair()
    rng = np.random.default_rng(2)
    c = CFG
    z_dim = c["n_cat"] * c["n_classes"]
    h = rng.standard_normal((7, c["deter"])).astype(np.float32)
    z = np.eye(z_dim, dtype=np.float32)[rng.integers(0, z_dim, 7)]
    a = np.eye(2, dtype=np.float32)[rng.integers(0, 2, 7)]
    key = jax.random.key(9)
    p = {"params": jl.params}
    h2, z2 = jl.module.apply(p, h, z, a, key, method="img_step")
    noise = np.asarray(jax.random.gumbel(key, (7, c["n_cat"],
                                               c["n_classes"])))
    with torch.no_grad():
        gh2, gz2 = tl.module.img_step(_t(h), _t(z), _t(a), _t(noise))
        close(gh2, h2)
        close(gz2, z2)
        want = jl.module.apply(p, h2, z2, method="heads")
        got = tl.module.heads(gh2, gz2)
        for k in want:
            close(got[k], want[k])
        obs = rng.standard_normal((1, c["obs_dim"])).astype(np.float32)
        carry = (h[:1], z[:1], a[:1])
        logits, value, (hn, zn, an) = jl.module.apply(
            p, obs, carry, method="rollout_step")
        glogits, gvalue, (ghn, gzn, gan) = tl.module(
            _t(obs), tuple(_t(x) for x in carry))
    for g, w in ((glogits, logits), (gvalue, value), (ghn, hn), (gzn, zn),
                 (gan, an)):
        close(g, w)


def test_rollout_policy_protocol():
    """tests/test_rllib_dreamer.py::test_rollout_policy_protocol on the
    port: the carry advances, feed_action installs the chosen action."""
    pol = td.build_dreamer_policy({"obs_dim": 4, "num_actions": 3,
                                   "deter": 16, "n_cat": 2, "n_classes": 4,
                                   "embed": 16, "hidden": 16}, "cpu")
    carry = pol.initial_state(1)
    obs = torch.zeros((1, 4))
    with torch.no_grad():
        logits, value, carry2 = pol(obs, carry)
        assert tuple(logits.shape) == (1, 3) and tuple(value.shape) == (1,)
        assert float(carry2[2].abs().sum()) == 0.0
        carry3 = pol.feed_action(carry2, 2)
        assert carry3[2][0].tolist() == [0.0, 0.0, 1.0]
        again, _, _ = pol(obs, carry)
    assert torch.equal(again, logits)


def _wm(jl, tl, mb, key):
    """One world-model update on both; returns the JAX outputs, the
    port's metrics and both recorded gradients."""
    jgrads = []
    inner = jl.wm_opt

    class Rec:
        init = inner.init

        @staticmethod
        def update(g, s, p=None):
            jgrads.append(_np(g))
            return inner.update(g, s, p)

    jl.wm_opt = Rec
    tgrads = []
    tinner = tl.wm_opt.update
    tl.wm_opt.update = lambda g, s, p: (tgrads.append(
        [x.detach().clone().numpy() for x in g]), tinner(g, s, p))[1]
    jout = jl._wm_update_fn(jl.params, jl.wm_opt_state,
                            {k: jnp.asarray(v) for k, v in mb.items()}, key)
    mbt = td.batch_to_device({
        "obs": mb["obs"], "actions": mb["actions"].astype(np.int64),
        "rewards": mb["rewards"], "cont": mb["cont"],
        "is_first": mb["is_first"]}, tl.device)
    _, tm = tl._wm_update(tl.state, {**mbt, "noise": _t(observe_noise(key))})
    return jout, tm, jgrads[0], tgrads[0]


def _check_grads(tl, got: list, want_tree, prefix: str) -> None:
    want = torch_names(want_tree)
    names = [k for k in tl.params if k.startswith("wm_") == (prefix == "wm")]
    assert set(want) == set(names)
    for name, g in zip(names, got):
        scale = float(np.abs(want[name]).max())
        err = float(np.abs(g - want[name]).max())
        assert err <= GRAD_TOL * scale, (name, err, scale)


def _param_error(tl, tree) -> float:
    want = torch_names(_np(tree))
    return max(float(np.abs(want[k] - p.detach().numpy()).max())
               for k, p in tl.params.items())


def test_world_model_loss_and_update_match_jax():
    jl, tl = pair()
    mb = batch(0)
    key = jax.random.key(21)
    (params, _, aux, h, z), tm, jg, tg = _wm(jl, tl, mb, key)
    for k, v in aux.items():
        np.testing.assert_allclose(float(tm[k]), float(v), rtol=LOSS_RTOL,
                                   atol=LOSS_ATOL, err_msg=k)
    close(tm["h"], h)
    close(tm["z"], z)
    _check_grads(tl, tg, jg, "wm")
    assert _param_error(tl, params) <= PARAM_TOL


def _ac(jl, tl, params, h, z, key):
    jgrads = []
    inner = jl.ac_opt

    class Rec:
        init = inner.init

        @staticmethod
        def update(g, s, p=None):
            jgrads.append(_np(g))
            return inner.update(g, s, p)

    jl.ac_opt = Rec
    tgrads = []
    tinner = tl.ac_opt.update
    tl.ac_opt.update = lambda g, s, p: (tgrads.append(
        [x.detach().clone().numpy() for x in g]), tinner(g, s, p))[1]
    jout = jl._ac_update_fn(params, jl.ac_opt_state, h, z, key)
    ga, gz = imagine_noise(key, h.shape[0] * h.shape[1])
    _, tm = tl._ac_update(tl.state, {"h": _t(h), "z": _t(z),
                                     "noise_a": _t(ga), "noise_z": _t(gz)})
    return jout, tm, jgrads[0], tgrads[0]


def test_actor_critic_loss_and_update_match_jax():
    """The world-model update, then the actor-critic's from its posterior
    states under the updated parameters, as ``update`` runs them."""
    jl, tl = pair()
    mb = batch(1)
    k1, k2 = jax.random.split(jax.random.key(33))
    (params, _, _, h, z), _, _, _ = _wm(jl, tl, mb, k1)
    (params2, _, aux), tm, jg, tg = _ac(jl, tl, params, h, z, k2)
    for k, v in aux.items():
        np.testing.assert_allclose(float(tm[k]), float(v), rtol=LOSS_RTOL,
                                   atol=LOSS_ATOL, err_msg=k)
    _check_grads(tl, tg, jg, "ac")
    assert _param_error(tl, params2) <= PARAM_TOL


def _large_reward_actor_loss() -> tuple[float, float]:
    """The port's and JAX's actor loss with the reward head's output
    layer ×30, so that the imagined advantages' std passes 1."""
    jl, tl = pair()
    jl.params["wm_reward"]["Dense_2"]["kernel"] = \
        jl.params["wm_reward"]["Dense_2"]["kernel"] * 30
    tl.load_jax_params(_np(jl.params))
    k1, k2 = jax.random.split(jax.random.key(33))
    (params, _, _, h, z), _, _, _ = _wm(jl, tl, batch(1), k1)
    (_, _, aux), tm, _, _ = _ac(jl, tl, params, h, z, k2)
    assert abs(float(aux["imag_return"])) > 10.0
    return float(tm["actor_loss"]), float(aux["actor_loss"])


def test_unbiased_std_fails_the_actor_loss(monkeypatch):
    """At large rewards the port holds; with ``torch.std``'s Bessel
    correction (off by sqrt(n/(n−1)), n = H·B·T) it fails."""
    got, want = _large_reward_actor_loss()
    np.testing.assert_allclose(got, want, rtol=LOSS_RTOL, atol=LOSS_ATOL)
    real = torch.std
    monkeypatch.setattr(torch, "std", lambda x, unbiased=False:
                        real(x, unbiased=True))
    got, want = _large_reward_actor_loss()
    assert abs(got - want) > 100 * LOSS_RTOL * abs(want)


def test_sequence_replay_draws_the_jax_segments():
    rng = np.random.default_rng(4)
    from ray_tpu.rllib.env_runner import Episode
    eps = []
    for n, term in ((9, True), (3, False), (1, True), (14, True)):
        eps.append(Episode(
            obs=list(rng.standard_normal((n, 2)).astype(np.float32)),
            actions=list(rng.integers(0, 2, n)),
            rewards=list(rng.standard_normal(n)), logps=[0.0] * n,
            values=[0.0] * n, terminated=term))
    jb, tb = jd.SequenceReplay(20, 6), td.SequenceReplay(20, 6)
    assert jb.add_episodes(eps) == tb.add_episodes(eps)
    assert jb.steps == tb.steps
    want = jb.sample(5, np.random.default_rng(0))
    got = tb.sample(5, np.random.default_rng(0))
    for k in want:
        np.testing.assert_array_equal(got[k], want[k])


def test_update_draws_its_own_noise_and_learns_nothing_on_the_cpu_captured():
    _, tl = pair()
    m = tl.update(batch(2))
    assert sorted(m) == sorted(["wm_loss", "recon_loss", "reward_loss",
                                "cont_loss", "kl_dyn", "actor_loss",
                                "critic_loss", "imag_return",
                                "imag_entropy"])
    assert all(np.isfinite(v) for v in m.values())
    assert tl.compile_count is None
    assert float(tl.wm_opt_state["count"]) == 1.0
    assert float(tl.ac_opt_state["count"]) == 1.0
