"""The port's off-policy, offline and V-trace learners (IMPALA, APPO, DQN,
SAC, CQL, BC, MARWIL) against the JAX package's, one update each, on the
CPU, from the same weights, the same batch and JAX's own noise.

Each JAX learner's initial parameters are carried into the port's by
``load_jax_params``. The JAX update runs eagerly (its ``_update_fn`` or
``_step_fn`` called as a function, not through ``jit``) with its optax
transformations wrapped so that they record the gradients they are
given; the port's optimizers are wrapped the same way. Where the JAX step
draws noise from a key, the test draws the same arrays from the same keys
(``jax.random.normal``, ``uniform``) and hands them to the port's step.

Tolerances (tests/test_torch_rllib_learner.py's): losses within 1e-6 relative or 1e-7 absolute (a
term that nearly cancels has a larger relative error); each gradient
within 1e-5 of its JAX counterpart's largest entry; after the update
every parameter within PARAM_TOL = 1e-6 (absolute) of JAX's: only the
order of float32 sums differs. V-trace's ``vs`` and advantages within
1e-6; RMSProp against ``optax.rmsprop`` over 5 steps within 1e-6.

SAC and CQL squash their gaussian samples with tanh and correct the
log-density by log(1 - tanh(pre)² + 1e-6): near saturation a change of
one ulp in tanh's result moves that term by up to 2/(1 - tanh² + 1e-6)
ulps, ~4e4 at pre = 5.7, which these weights reach (log_std up to 1.0).
XLA's CPU tanh is off by up to 4.2 ulp and differs from torch's (0.56 ulp)
on 60% of float32 inputs, so in float32 one sample's log-prob differs by
up to 2.4e-3 between the packages, and the actor's loss and gradient by
~1e-3 relative: a float32 property of the JAX formula, which the port
evaluates as written. So SAC's and CQL's steps are held to the
tolerances above in float64 (the JAX learner under ``jax.enable_x64``
with its modules computing in float64, the port's modules in float64;
JAX's own noise drawn in float64), and once more in float32, the
learners' own type, with the critic's terms to the tolerances above and
the actor's and temperature's within SQUASH_RTOL.

Each planted fault fails its check: RMSProp with eps outside the square
root (torch's form), CQL with ``Tensor.repeat`` (tiling the batch) for
``jnp.repeat``, SAC's actor reading the critic before the critic's
update.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
pytest.importorskip("flax")
optax = pytest.importorskip("optax")
import jax.numpy as jnp  # noqa: E402

from ray_tpu.rllib import appo as jappo  # noqa: E402
from ray_tpu.rllib import bc as jbc  # noqa: E402
from ray_tpu.rllib import cql as jcql  # noqa: E402
from ray_tpu.rllib import dqn as jdqn  # noqa: E402
from ray_tpu.rllib import impala as jimpala  # noqa: E402
from ray_tpu.rllib import marwil as jmarwil  # noqa: E402
from ray_tpu.rllib import sac as jsac  # noqa: E402
from ray_tpu.rllib.env_runner import Episode  # noqa: E402
from ray_tpu_torch.rllib import appo, bc, cql, dqn, impala, marwil, sac  # noqa: E402,E501
from ray_tpu_torch.train import optim  # noqa: E402
from torch_rllib_programs import torch_names  # noqa: E402

import chip_smoke as cs  # noqa: E402

LOSS_RTOL = 1e-6
LOSS_ATOL = 1e-7
GRAD_TOL = 1e-5
PARAM_TOL = 1e-6
VTRACE_TOL = 1e-6
# SAC's actor and temperature terms in float32 (see above).
SQUASH_RTOL = 1e-2
RMSPROP_TOL = 1e-6
CFG = {"obs_dim": 4, "num_actions": 3, "hidden": (16, 16)}
CCFG = {"obs_dim": 3, "action_dim": 2, "hidden": (16, 16)}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One torch thread for the module, as every test_torch_* file."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# -- recording the gradients an optimizer is given ---------------------------


class OptaxRecorder:
    """An optax transformation that records the gradients it is given."""

    def __init__(self, inner):
        self.inner = inner
        self.grads = []

    def init(self, params):
        return self.inner.init(params)

    def update(self, grads, state, params=None):
        self.grads.append(jax.tree_util.tree_map(np.asarray, grads))
        return self.inner.update(grads, state, params)


def record(jl, *names: str) -> list[OptaxRecorder]:
    out = []
    for name in names:
        rec = OptaxRecorder(getattr(jl, name))
        setattr(jl, name, rec)
        out.append(rec)
    return out


def port_record(opt) -> list:
    """Records the gradients a port optimizer (or chain) is given, in the
    order of its parameters."""
    seen = []
    inner = opt.update

    def update(grads, state, params):
        seen.append([None if g is None else g.detach().clone().numpy()
                     for g in grads])
        return inner(grads, state, params)

    opt.update = update
    return seen


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def check_losses(got: dict, want: dict) -> None:
    for k, w in want.items():
        np.testing.assert_allclose(float(got[k]), float(w), rtol=LOSS_RTOL,
                                   atol=LOSS_ATOL, err_msg=k)


def grad_errors(names: list[str], got: list, want_tree) -> dict:
    """{parameter: (error, scale)} of the port's gradients (in ``names``'
    order) against a JAX gradient tree."""
    want = torch_names(_np(want_tree))
    assert set(want) == set(names)
    out = {}
    for name, g in zip(names, got):
        g = np.zeros_like(want[name]) if g is None else g
        out[name] = (float(np.abs(g - want[name]).max()),
                     float(np.abs(want[name]).max()))
    return out


def check_grads(names, got, want_tree) -> None:
    for name, (err, scale) in grad_errors(names, got, want_tree).items():
        assert err <= GRAD_TOL * scale, (name, err, scale)


def param_error(module: torch.nn.Module, want_tree) -> float:
    want = torch_names(_np(want_tree))
    got = dict(module.named_parameters())
    assert set(want) == set(got)
    return max(float(np.abs(want[k] - p.detach().numpy()).max())
               for k, p in got.items())


def names(module: torch.nn.Module) -> list[str]:
    return [k for k, _ in module.named_parameters()]


# -- RMSProp -------------------------------------------------------------------


class EpsOutsideSqrt(optim.RMSProp):
    """The planted fault: torch.optim.RMSprop's ``g / (sqrt(nu) + eps)``."""

    @torch.no_grad()
    def update(self, grads, state, params):
        for p, g, nu in zip(params, grads, state.nu):
            nu.copy_(g.square().mul_(1 - self.decay).add_(nu * self.decay))
            p.add_(g / (nu.sqrt() + self.eps), alpha=-self.lr)


def rmsprop_errors(opt) -> list[float]:
    rng = np.random.default_rng(0)
    shapes = ((5, 3), (3,), (2, 2))
    params = [rng.standard_normal(s).astype(np.float32) for s in shapes]
    want = [jnp.asarray(p) for p in params]
    got = [torch.from_numpy(p.copy()) for p in params]
    ref = optax.rmsprop(5e-4, decay=0.99, eps=0.1)
    ref_state, state = ref.init(want), opt.init(got)
    errors = []
    for _ in range(5):
        grads = [rng.standard_normal(s).astype(np.float32) * 3
                 for s in shapes]
        updates, ref_state = ref.update([jnp.asarray(g) for g in grads],
                                        ref_state, want)
        want = optax.apply_updates(want, updates)
        opt.update([torch.from_numpy(g) for g in grads], state, got)
        errors.append(max(float(np.abs(np.asarray(w) - g.numpy()).max())
                          for w, g in zip(want, got)))
    return errors


def test_rmsprop_matches_optax_over_five_steps():
    errors = rmsprop_errors(optim.rmsprop(5e-4, decay=0.99, eps=0.1))
    assert max(errors) <= RMSPROP_TOL, errors


def test_rmsprop_with_eps_outside_the_sqrt_fails_the_tolerance():
    errors = rmsprop_errors(EpsOutsideSqrt(5e-4, 0.99, 0.1))
    assert errors[0] > 100 * RMSPROP_TOL, errors


# -- IMPALA and APPO ---------------------------------------------------------


def impala_episodes(seed: int = 0, T: int = 8) -> list:
    """Four episodes of lengths 8, 5, 3 and 8 (two terminated, two
    truncated), on CFG's observations."""
    rng = np.random.default_rng(seed)
    out = []
    for n, term in ((T, True), (5, False), (3, True), (T, False)):
        out.append(Episode(
            obs=list(rng.standard_normal((n, 4)).astype(np.float32)),
            actions=list(rng.integers(0, 3, n)),
            rewards=list(rng.standard_normal(n)),
            logps=list(np.log(rng.uniform(0.2, 0.5, n))),
            values=[0.0] * n, terminated=term, truncated=not term,
            final_obs=rng.standard_normal(4).astype(np.float32)))
    return out


def impala_pair(jax_learner=jimpala.ImpalaLearner,
                port_learner=impala.ImpalaLearner,
                hp=jimpala.ImpalaHyperparams, port_hp=impala.ImpalaHyperparams,
                **over):
    jl = jax_learner(CFG, hp(**over), max_seq_len=8, seed=0)
    tl = port_learner(CFG, port_hp(**over), max_seq_len=8, device="cpu")
    tl.load_jax_params(_np(jl.params))
    return jl, tl


def jax_impala_batch(jl, episodes) -> dict:
    """The JAX learner's ``update_from_episodes`` batch (bootstrap values
    under its current parameters), as numpy."""
    batch = jl._pad_episodes(episodes)
    finals = np.stack([e.final_obs for e in episodes])
    _, boot = jl.model.apply({"params": jl.params}, jnp.asarray(finals))
    term = np.array([e.terminated for e in episodes])
    batch["bootstrap"] = np.where(term, 0.0, np.asarray(boot))
    return batch


def test_vtrace_targets_and_advantages_match_jax(monkeypatch):
    jl, tl = impala_pair(gamma=0.9, rho_bar=0.8, c_bar=0.9)
    eps = impala_episodes(1)
    batch = jax_impala_batch(jl, eps)
    got_batch = tl.make_batch(eps)
    for k in batch:
        np.testing.assert_allclose(got_batch[k], batch[k], rtol=0,
                                   atol=1e-6 if k == "bootstrap" else 0)
    # The JAX terms stop the gradient of the advantages, then of vs: the
    # two calls' arguments are the JAX values.
    seen = []
    real = jax.lax.stop_gradient
    monkeypatch.setattr(jax.lax, "stop_gradient",
                        lambda x: seen.append(np.asarray(x)) or real(x))
    jl._vtrace_terms(jl.params, {k: jnp.asarray(v)
                                 for k, v in batch.items()})
    monkeypatch.undo()
    want_adv, want_vs = seen[:2]
    t = tl._vtrace_terms(tl.model, {k: torch.from_numpy(np.asarray(v))
                                    for k, v in batch.items()})
    assert want_vs.shape == tuple(t["vs"].shape) == (4, 8)
    np.testing.assert_allclose(t["vs"].numpy(), want_vs, rtol=0,
                               atol=VTRACE_TOL)
    np.testing.assert_allclose(t["adv"].numpy(), want_adv, rtol=0,
                               atol=VTRACE_TOL)
    # The bootstrap enters at each episode's last real step: without it
    # the truncated episodes' targets move.
    no_boot = {**batch, "bootstrap": np.zeros(4, np.float32)}
    t0 = tl._vtrace_terms(tl.model, {k: torch.from_numpy(np.asarray(v))
                                     for k, v in no_boot.items()})
    assert float((t0["vs"] - t["vs"]).abs().max()) > 1e3 * VTRACE_TOL


def one_impala_update(jl, tl, episodes):
    (jrec,) = record(jl, "opt")
    trec = port_record(tl.opt)
    batch = jax_impala_batch(jl, episodes)
    params, _, jm = jl._update_fn(jl.params, jl.opt_state,
                                  {k: jnp.asarray(v) for k, v in
                                   batch.items()})
    tm = tl.update(batch)
    check_losses(tm, jm)
    check_grads(names(tl.model), trec[0], jrec.grads[0])
    assert param_error(tl.model, params) <= PARAM_TOL


@pytest.mark.parametrize("optimizer", ["rmsprop", "adam"])
def test_impala_update_matches_jax(optimizer):
    jl, tl = impala_pair(optimizer=optimizer, max_grad_norm=40.0)
    one_impala_update(jl, tl, impala_episodes(2))


def test_impala_update_with_the_clip_engaged_matches_jax():
    jl, tl = impala_pair(max_grad_norm=0.05)
    one_impala_update(jl, tl, impala_episodes(3))


def test_appo_update_matches_jax():
    jl, tl = impala_pair(jappo.APPOLearner, appo.APPOLearner,
                         jappo.APPOHyperparams, appo.APPOHyperparams)
    one_impala_update(jl, tl, impala_episodes(4))


def test_impala_captures_nothing_on_the_cpu_and_mean_rho_is_one_on_policy():
    """tests/test_rllib_algos.py::test_vtrace_on_policy_rho_is_one."""
    _, tl = impala_pair()
    rng = np.random.default_rng(1)
    obs = rng.standard_normal((6, 4)).astype(np.float32)
    with torch.no_grad():
        logits, _ = tl.model(torch.from_numpy(obs))
    logp = torch.log_softmax(logits, -1).numpy()
    actions = [int(rng.integers(0, 3)) for _ in range(6)]
    ep = Episode(obs=list(obs), actions=actions, rewards=[1.0] * 6,
                 logps=[float(logp[t, a]) for t, a in enumerate(actions)],
                 values=[0.0] * 6, terminated=True, final_obs=obs[-1])
    m = tl.update_from_episodes([ep])
    assert m["mean_rho"] == pytest.approx(1.0, abs=1e-6)
    assert tl.compile_count is None


# -- DQN -----------------------------------------------------------------------


def transitions(seed: int, n: int = 32, obs_dim: int = 4, actions=3,
                action_dim: int | None = None) -> dict:
    rng = np.random.default_rng(seed)
    out = {"obs": rng.standard_normal((n, obs_dim)).astype(np.float32),
           "rewards": rng.standard_normal(n).astype(np.float32),
           "next_obs": rng.standard_normal((n, obs_dim)).astype(np.float32),
           "dones": (rng.random(n) < 0.2).astype(np.float32)}
    if action_dim is None:
        out["actions"] = rng.integers(0, actions, n).astype(np.int32)
    else:
        out["actions"] = rng.uniform(-1, 1, (n, action_dim)).astype(
            np.float32)
    return out


@pytest.mark.parametrize("double_q", [True, False])
def test_dqn_update_matches_jax(double_q):
    jl = jdqn.DQNLearner(CFG, jdqn.DQNHyperparams(double_q=double_q))
    tl = dqn.DQNLearner(CFG, dqn.DQNHyperparams(double_q=double_q),
                        device="cpu")
    tl.load_jax_params(_np(jl.params))
    # A target network apart from the online one, as after training.
    jl.target_params = jax.tree_util.tree_map(lambda x: x * 1.5, jl.params)
    tl.target_params = torch_names(_np(jl.target_params))
    (jrec,) = record(jl, "opt")
    trec = port_record(tl.opt)
    batch = transitions(0)
    params, _, jm = jl._update_fn(jl.params, jl.opt_state, jl.target_params,
                                  {k: jnp.asarray(v) for k, v in
                                   batch.items()})
    tm = tl.update(batch)
    check_losses(tm, jm)
    check_grads(names(tl.model), trec[0], jrec.grads[0])
    assert param_error(tl.model, params) <= PARAM_TOL
    tl.sync_target()
    assert all(torch.equal(tl.target_params[k], p)
               for k, p in tl.params.items())


def test_replay_buffer_draws_the_jax_minibatches():
    """The same episodes and ``default_rng(0)``: equal samples."""
    rng = np.random.default_rng(5)
    eps = [Episode(obs=list(rng.standard_normal((n, 2)).astype(np.float32)),
                   actions=list(rng.integers(0, 2, n)),
                   rewards=list(rng.standard_normal(n)), logps=[0.0] * n,
                   values=[0.0] * n, terminated=bool(n % 2),
                   final_obs=rng.standard_normal(2).astype(np.float32))
           for n in (7, 12, 4)]
    jb, tb = jdqn.ReplayBuffer(16, 2), dqn.ReplayBuffer(16, 2)
    assert jb.add_episodes(eps) == tb.add_episodes(eps) == 23
    want = jb.sample(32, np.random.default_rng(0))
    got = tb.sample(32, np.random.default_rng(0))
    for k in want:
        np.testing.assert_array_equal(got[k], want[k])


# -- SAC and CQL ---------------------------------------------------------------


@pytest.fixture
def x64():
    with jax.enable_x64(True):
        yield


def continuous_pair(jax_cls, port_cls, hp, port_hp, f64=True, **over):
    """The JAX and the port's learner from the same weights, computing in
    float64 (``f64``, under the ``x64`` fixture) or float32."""
    jcfg, tcfg = CCFG, CCFG
    if f64:
        jcfg, tcfg = {**CCFG, "dtype": jnp.float64}, \
            {**CCFG, "dtype": torch.float64}
    jl = jax_cls(jcfg, hp(**over), seed=0)
    tl = port_cls(tcfg, port_hp(**over), device="cpu")
    # A target apart from the critic, as after training.
    jl.target_critic_params = jax.tree_util.tree_map(
        lambda x: x * 0.9, jl.critic_params)
    tl.load_jax_params(_np(jl.actor_params), _np(jl.critic_params),
                       _np(jl.target_critic_params), np.asarray(jl.log_alpha))
    return jl, tl


def sac_noise(key, B: int, A: int = 2) -> dict:
    k1, k2 = jax.random.split(key)
    return {"noise_next": np.asarray(jax.random.normal(k1, (B, A))),
            "noise": np.asarray(jax.random.normal(k2, (B, A)))}


def cql_noise(key, B: int, N: int, A: int = 2) -> dict:
    k1, k2, k3, k4, _ = jax.random.split(key, 5)
    return {"noise_next": np.asarray(jax.random.normal(k1, (B, A))),
            "a_rand": np.asarray(jax.random.uniform(
                k2, (B, N, A), minval=-1.0, maxval=1.0)),
            "noise_pi": np.asarray(jax.random.normal(k3, (B * N, A))),
            "noise": np.asarray(jax.random.normal(k4, (B, A)))}


def one_continuous_update(jl, tl, batch, noise, key, **static):
    recs = record(jl, "critic_opt", "actor_opt", "alpha_opt")
    trecs = [port_record(o) for o in (tl.critic_opt, tl.actor_opt,
                                      tl.alpha_opt)]
    out = jl._step_fn(jl.actor_params, jl.critic_params,
                      jl.target_critic_params, jl.log_alpha,
                      jl.actor_opt_state, jl.critic_opt_state,
                      jl.alpha_opt_state,
                      {k: jnp.asarray(v) for k, v in batch.items()}, key,
                      **static)
    tm = tl.update(batch, noise=noise)
    return out, tm, recs, trecs


def check_continuous(jl, tl, out, tm, recs, trecs, strict: bool = True,
                     critic_keys=("critic_loss",)) -> None:
    """Every term to the tolerances of the module docstring; with
    ``strict`` False (float32), the actor's and temperature's within
    SQUASH_RTOL."""
    actor_p, critic_p, target_p, log_alpha = out[:4]
    want = out[-1]
    check_losses({k: tm[k] for k in critic_keys},
                 {k: want[k] for k in critic_keys})
    check_grads(names(tl.critic), trecs[0][0], recs[0].grads[0])
    assert param_error(tl.critic, critic_p) <= PARAM_TOL
    assert param_error(tl.target_critic, target_p) <= PARAM_TOL
    rtol, grad_tol = (LOSS_RTOL, GRAD_TOL) if strict else (SQUASH_RTOL,
                                                           SQUASH_RTOL)
    for k in set(want) - set(critic_keys):
        np.testing.assert_allclose(tm[k], float(want[k]), rtol=rtol,
                                   atol=LOSS_ATOL, err_msg=k)
    for name, (err, scale) in grad_errors(names(tl.actor), trecs[1][0],
                                          recs[1].grads[0]).items():
        assert err <= grad_tol * scale, (name, err, scale)
    np.testing.assert_allclose(trecs[2][0][0], recs[2].grads[0],
                               rtol=grad_tol, atol=0)
    if strict:
        assert param_error(tl.actor, actor_p) <= PARAM_TOL
        np.testing.assert_allclose(float(tl.log_alpha.detach()),
                                   float(log_alpha), rtol=0, atol=PARAM_TOL)


def test_sac_step_matches_jax(x64):
    jl, tl = continuous_pair(jsac.SACLearner, sac.SACLearner,
                             jsac.SACHyperparams, sac.SACHyperparams)
    key = jax.random.key(7)
    batch = transitions(1, action_dim=2, obs_dim=3)
    out, tm, recs, trecs = one_continuous_update(
        jl, tl, batch, sac_noise(key, 32), key)
    assert sorted(tm) == ["actor_loss", "alpha", "critic_loss", "entropy"]
    check_continuous(jl, tl, out, tm, recs, trecs)


def test_sac_step_in_float32_is_near_jax():
    jl, tl = continuous_pair(jsac.SACLearner, sac.SACLearner,
                             jsac.SACHyperparams, sac.SACHyperparams,
                             f64=False)
    key = jax.random.key(7)
    batch = transitions(1, action_dim=2, obs_dim=3)
    out, tm, recs, trecs = one_continuous_update(
        jl, tl, batch, sac_noise(key, 32), key)
    check_continuous(jl, tl, out, tm, recs, trecs, strict=False)


# The planted fault (chip_smoke's, whose --plant-fault runs it on the card):
# the actor steps before the critic, so it reads the critic as it was
# before the critic's update.
StaleCriticSAC = type("StaleCriticSAC", (cs.StaleCriticSAC, sac.SACLearner),
                      {})


def test_sac_actor_on_the_stale_critic_fails_the_tolerance(x64):
    jl, tl = continuous_pair(jsac.SACLearner, StaleCriticSAC,
                             jsac.SACHyperparams, sac.SACHyperparams)
    key = jax.random.key(7)
    batch = transitions(1, action_dim=2, obs_dim=3)
    out, tm, recs, trecs = one_continuous_update(
        jl, tl, batch, sac_noise(key, 32), key)
    errors = grad_errors(names(tl.actor), trecs[1][0], recs[1].grads[0])
    assert max(e / s for e, s in errors.values()) > 100 * GRAD_TOL
    want = float(out[-1]["actor_loss"])
    assert abs(tm["actor_loss"] - want) > 100 * LOSS_RTOL * abs(want)


@pytest.mark.parametrize("bc_flag", [False, True], ids=["sac", "bc_warmup"])
def test_cql_step_matches_jax(bc_flag, x64):
    N = 4
    jl, tl = continuous_pair(jcql.CQLLearner, cql.CQLLearner,
                             jcql.CQLHyperparams, cql.CQLHyperparams,
                             num_penalty_actions=N,
                             bc_warmup_steps=1 if bc_flag else 0)
    key = jax.random.key(11)
    batch = transitions(2, n=16, action_dim=2, obs_dim=3)
    out, tm, recs, trecs = one_continuous_update(
        jl, tl, batch, cql_noise(key, 16, N), key, bc=bc_flag)
    assert sorted(tm) == ["actor_loss", "alpha", "bellman_loss",
                          "cql_penalty", "critic_loss"]
    check_continuous(jl, tl, out, tm, recs, trecs, critic_keys=(
        "critic_loss", "bellman_loss", "cql_penalty"))


class TiledCQL(cql.CQLLearner):
    """The planted fault: ``Tensor.repeat`` (the batch tiled N times) where
    the JAX learner repeats each state N times in a row."""

    def _q_samples(self, critic, obs, actions):
        B, N, A = actions.shape
        q1, q2 = critic(obs.repeat(N, 1), actions.reshape(B * N, A))
        return q1.reshape(B, N), q2.reshape(B, N)


def test_cql_with_tensor_repeat_fails_the_tolerance(x64):
    N = 4
    jl, tl = continuous_pair(jcql.CQLLearner, TiledCQL,
                             jcql.CQLHyperparams, cql.CQLHyperparams,
                             num_penalty_actions=N)
    key = jax.random.key(11)
    batch = transitions(2, n=16, action_dim=2, obs_dim=3)
    out, tm, recs, trecs = one_continuous_update(
        jl, tl, batch, cql_noise(key, 16, N), key, bc=False)
    want = float(out[-1]["cql_penalty"])
    assert abs(tm["cql_penalty"] - want) > 100 * LOSS_RTOL * abs(want)
    errors = grad_errors(names(tl.critic), trecs[0][0], recs[0].grads[0])
    assert max(e / s for e, s in errors.values()) > 100 * GRAD_TOL


# -- BC and MARWIL -------------------------------------------------------------


def offline_batch(seed: int, n: int = 32) -> dict:
    rng = np.random.default_rng(seed)
    return {"obs": rng.standard_normal((n, 4)).astype(np.float32),
            "action": rng.integers(0, 3, n),
            "return": (rng.standard_normal(n) * 2).astype(np.float32)}


def test_bc_update_matches_jax():
    jl = jbc.BCLearner(CFG, jbc.BCHyperparams(lr=3e-3))
    tl = bc.BCLearner(CFG, bc.BCHyperparams(lr=3e-3), device="cpu")
    tl.load_jax_params(_np(jl.params))
    (jrec,) = record(jl, "opt")
    trec = port_record(tl.opt)
    batch = offline_batch(0)
    params, _, jm = jl._update_fn(
        jl.params, jl.opt_state,
        {"obs": jnp.asarray(batch["obs"]),
         "action": jnp.asarray(batch["action"], jnp.int32)})
    tm = tl.update(batch)
    check_losses(tm, jm)
    check_grads(names(tl.model), trec[0], jrec.grads[0])
    assert param_error(tl.model, params) <= PARAM_TOL


@pytest.mark.parametrize("beta", [0.0, 1.5])
def test_marwil_updates_and_the_running_norm_match_jax(beta):
    """Two updates: the second reads the running norm the first left."""
    hp = {"beta": beta, "norm_ema": 0.3}
    jl = jmarwil.MARWILLearner(CFG, jmarwil.MARWILHyperparams(**hp))
    tl = marwil.MARWILLearner(CFG, marwil.MARWILHyperparams(**hp),
                              device="cpu")
    tl.load_jax_params(_np(jl.params))
    (jrec,) = record(jl, "opt")
    trec = port_record(tl.opt)
    params, opt_state, norm = jl.params, jl.opt_state, jl.adv_sq_norm
    for i in range(2):
        batch = offline_batch(i)
        params, opt_state, norm, jm = jl._update_fn(
            params, opt_state, norm,
            {"obs": jnp.asarray(batch["obs"]),
             "action": jnp.asarray(batch["action"], jnp.int32),
             "return": jnp.asarray(batch["return"])})
        tm = tl.update(batch)
        check_losses(tm, jm)
        check_grads(names(tl.model), trec[i], jrec.grads[i])
        assert param_error(tl.model, params) <= PARAM_TOL
        np.testing.assert_allclose(float(tl.adv_sq_norm), float(norm),
                                   rtol=LOSS_RTOL)
    if beta == 0.0:
        assert tm["mean_weight"] == 1.0


def test_returns_from_rewards_is_the_jax_function():
    rng = np.random.default_rng(3)
    r = rng.standard_normal(20).astype(np.float32)
    d = rng.random(20) < 0.2
    np.testing.assert_array_equal(marwil.returns_from_rewards(r, d, 0.9),
                                  jmarwil.returns_from_rewards(r, d, 0.9))


def test_learners_refuse_to_run_without_a_card():
    for make in (lambda: dqn.DQNLearner(CFG, dqn.DQNHyperparams()),
                 lambda: sac.SACLearner(CCFG, sac.SACHyperparams()),
                 lambda: impala.ImpalaLearner(CFG, impala.ImpalaHyperparams(),
                                              8)):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            make()
