"""Small RLlib and host-collective programs, each run once on ``ray_tpu``
and once on ``ray_tpu_torch`` (tests/test_torch_rllib_parity.py and
tests/test_torch_collective_host.py).

Every program takes the package module (``rt``) and reaches RLlib as
``rt.rllib`` and the runtime through ``rt.remote`` and ``rt.get``, so the
same code runs on both; where the frameworks differ (a flax module's
``apply`` against a torch module's call, the port's ``device="cpu"``)
one helper below says how. A program returns a plain result that holds
only what a run decides (actions, shapes, flags, exact numpy values),
never a time or a path; a float that the two frameworks round apart is
checked inside the program against its tolerance, and the result holds
the verdict. Learning is read as "passes the JAX test's threshold", not
as reward values. :data:`EXPECTED` holds what each program must give.

The programs cover the behaviours of the JAX package's
``tests/test_rllib.py``, ``tests/test_rllib_catalog.py``,
``tests/test_rllib_recurrent.py``,
``tests/test_rllib_connectors_offline.py`` (BC from JSON offline data
too), ``tests/test_rllib_algos.py`` (IMPALA, APPO, DQN, SAC, CQL, BC,
MARWIL; their learning tests at the JAX tests' settings and thresholds)
and ``tests/test_rllib_dreamer.py``; the toy environments of the last
two live here. Nothing here imports either package at module level: a
runner actor of the port that unpickles an environment defined here must
not load ``ray_tpu``.
"""

from __future__ import annotations

import importlib
import os
import shutil
import tempfile

import numpy as np

PORT = "ray_tpu_torch"
CARTPOLE = {"obs_dim": 4, "num_actions": 2}


def _sub(rt, name: str):
    return importlib.import_module(f"{rt.__name__}.{name}")


def _port(rt) -> bool:
    return rt.__name__ == PORT


def _dev(rt) -> dict:
    """The port's entry points run on the card unless told otherwise."""
    return {"device": "cpu"} if _port(rt) else {}


def _cpu(rt, config):
    """An algorithm config whose learner runs on the CPU in the port."""
    return config.learners(device="cpu") if _port(rt) else config


def _init(rt, model, seed: int = 0):
    """The model's parameters: the flax tree from ``init_params`` in the
    JAX package; None in the port, whose modules hold their own."""
    if _port(rt):
        return None
    import jax
    return model.init_params(jax.random.key(seed))


def _apply(rt, model, params, *args, method: str | None = None):
    """A forward on numpy inputs, as numpy outputs."""
    if _port(rt):
        import torch
        fn = getattr(model, method) if method else model
        with torch.no_grad():
            out = fn(*(torch.from_numpy(np.asarray(a, np.float32))
                       for a in args))
    else:
        out = _jitted(model, method)(params, *args)
    if isinstance(out, tuple):
        return tuple(np.asarray(o) for o in out)
    return np.asarray(out)


_JITTED: dict = {}


def _jitted(model, method):
    """``model.apply`` under ``jax.jit``, once per module and method (a
    loop of eager flax calls would take minutes)."""
    key = (id(model), method)
    if key not in _JITTED:
        import jax
        kw = {"method": method} if method else {}
        _JITTED[key] = (model, jax.jit(
            lambda p, *a: model.apply({"params": p}, *a, **kw)))
    return _JITTED[key][1]


def _leaves(rt, params) -> list[np.ndarray]:
    """Parameters as numpy arrays: a flax tree's leaves, or the port's
    tensors by name, each in a fixed order."""
    if isinstance(params, dict) and params and \
            not isinstance(next(iter(params.values())), dict):
        return [np.asarray(params[k].detach().cpu()) if hasattr(
            params[k], "detach") else np.asarray(params[k])
            for k in sorted(params)]
    import jax
    return [np.asarray(x) for x in jax.tree_util.tree_leaves(params)]


def torch_names(tree, prefix: str = "") -> dict:
    """A flax parameter tree by the port's parameter names, each leaf in
    the port's layout (Dense kernels transposed)."""
    out = {}
    for k, v in tree.items():
        if "kernel" not in v:
            out.update(torch_names(v, f"{prefix}{k}."))
            continue
        kernel = np.asarray(v["kernel"], np.float32)
        out[f"{prefix}{k}.weight"] = (kernel.transpose(3, 2, 0, 1)
                                      if kernel.ndim == 4 else kernel.T)
        if "bias" in v:
            out[f"{prefix}{k}.bias"] = np.asarray(v["bias"], np.float32)
    return out


def _episode(rt, n=5, reward=1.0, logp=-0.5):
    e = _sub(rt, "rllib.env_runner").Episode()
    for i in range(n):
        e.obs.append(np.full(3, float(i), np.float32))
        e.actions.append(i % 2)
        e.rewards.append(reward)
        e.logps.append(logp)
        e.values.append(0.5)
    e.terminated = True
    return e


# -- environments (numpy only) ---------------------------------------------


class RecallEnv:
    """Memory probe (tests/test_rllib_recurrent.py): the first
    observation is +1 or -1, later ones 0; only the action at the final
    step matters and must match the initial sign. A memoryless policy
    earns 0.5 in expectation."""

    def __init__(self, horizon: int = 5, seed: int = 0):
        self.h = horizon
        self.rng = np.random.default_rng(seed)

    def reset(self, seed=None, options=None):
        self.sign = 1 if self.rng.random() < 0.5 else -1
        self.t = 0
        return np.array([self.sign], np.float32), {}

    def step(self, action):
        self.t += 1
        done = self.t >= self.h
        reward = 0.0
        if done:
            want = 0 if self.sign > 0 else 1
            reward = 1.0 if int(action) == want else 0.0
        return (np.zeros(1, np.float32), reward, done, False, {})


def recall_env():
    return RecallEnv(horizon=4)


class TwoAgentEnv:
    """Two agents; each is rewarded for action == (its obs[0] > 0);
    episodes of 10 steps."""

    possible_agents = ["a", "b"]

    def __init__(self):
        self.rng = np.random.default_rng(0)
        self.t = 0

    def _obs(self):
        return {a: self.rng.standard_normal(2).astype(np.float32)
                for a in self.possible_agents}

    def reset(self, seed=None, options=None):
        self.t = 0
        self.last = self._obs()
        return self.last, {}

    def step(self, actions):
        self.t += 1
        rewards = {a: float(int(actions[a]) == int(self.last[a][0] > 0))
                   for a in actions}
        done = self.t >= 10
        self.last = self._obs()
        return (self.last, rewards, {"__all__": done},
                {"__all__": False}, {})


def two_agent_env():
    return TwoAgentEnv()


class ChainEnv:
    """tests/test_rllib_algos.py: walk right along a chain of N one-hot
    states; +1 at the end, -0.01 per step; truncates after ``limit``
    steps (tests/test_rllib_dreamer.py's is N = 6, limit 20)."""

    N = 8
    limit = 30

    def __init__(self):
        self.pos = 0
        self.t = 0

    def _obs(self):
        o = np.zeros(self.N, np.float32)
        o[self.pos] = 1.0
        return o

    def reset(self, seed=None, options=None):
        self.pos, self.t = 0, 0
        return self._obs(), {}

    def step(self, action):
        self.t += 1
        self.pos = max(0, min(self.N - 1,
                              self.pos + (1 if action == 1 else -1)))
        term = self.pos == self.N - 1
        reward = 1.0 if term else -0.01
        trunc = self.t >= self.limit and not term
        return self._obs(), reward, term, trunc, {}


class ShortChainEnv(ChainEnv):
    """tests/test_rllib_dreamer.py's chain."""

    N = 6
    limit = 20


class Point1DEnv:
    """Continuous: drive x to 0; reward -x^2; 16-step episodes."""

    def __init__(self):
        self.x = 0.0
        self.t = 0
        self.rng = np.random.default_rng(0)

    def reset(self, seed=None, options=None):
        if seed is not None:
            self.rng = np.random.default_rng(seed)
        self.x = float(self.rng.uniform(-1.0, 1.0))
        self.t = 0
        return np.array([self.x], np.float32), {}

    def step(self, action):
        a = float(np.clip(np.asarray(action).reshape(-1)[0], -1, 1))
        self.x = float(np.clip(self.x + 0.25 * a, -2.0, 2.0))
        self.t += 1
        reward = -self.x ** 2
        trunc = self.t >= 16
        return np.array([self.x], np.float32), reward, False, trunc, {}


class FixedRewardEnv:
    """+1 a step, episodes of 5 steps."""

    def __init__(self):
        self.t = 0

    def reset(self, seed=None, options=None):
        self.t = 0
        return np.zeros(2, np.float32), {}

    def step(self, action):
        self.t += 1
        return np.zeros(2, np.float32), 1.0, self.t >= 5, False, {}


class LongEnv(FixedRewardEnv):
    """+1 a step, episodes of 400 steps: longer than a 256-step round."""

    def step(self, action):
        self.t += 1
        return np.zeros(2, np.float32), 1.0, self.t >= 400, False, {}


def policy_of(agent: str) -> str:
    return "pa" if agent == "a" else "pb"


def cartpole():
    """The creator that :func:`registered_env` registers."""
    import gymnasium
    return gymnasium.make("CartPole-v1")


# -- test_rllib.py -----------------------------------------------------------


def gae(rt):
    learner = _sub(rt, "rllib.learner")
    ln = learner.JaxLearner({"obs_dim": 2, "num_actions": 2},
                            learner.PPOHyperparams(gamma=0.5,
                                                   gae_lambda=1.0),
                            **_dev(rt))
    ep = _sub(rt, "rllib.env_runner").Episode(
        obs=[np.zeros(2, np.float32)] * 3, actions=[0, 1, 0],
        rewards=[1.0, 1.0, 1.0], logps=[-0.7] * 3, values=[0.0] * 3,
        terminated=True)
    batch = ln.compute_advantages([ep])
    return [batch["returns"].tolist(), list(batch["obs"].shape),
            abs(float(batch["advantages"].mean())) < 1e-6]


def learner_update(rt):
    learner = _sub(rt, "rllib.learner")
    rng = np.random.default_rng(0)
    ln = learner.JaxLearner({"obs_dim": 4, "num_actions": 2},
                            learner.PPOHyperparams(minibatch_size=32,
                                                   num_epochs=2),
                            **_dev(rt))
    ep = _sub(rt, "rllib.env_runner").Episode(
        obs=list(rng.standard_normal((64, 4)).astype(np.float32)),
        actions=list(rng.integers(0, 2, 64)),
        rewards=list(rng.standard_normal(64)),
        logps=list(np.full(64, -0.69)), values=list(np.zeros(64)),
        terminated=True)
    m = ln.update_from_episodes([ep])
    return [sorted(m), all(np.isfinite(v) for v in m.values())]


def ppo_cartpole_learns(rt):
    """tests/test_rllib.py::test_ppo_cartpole_learns: 2 runners, 1024
    steps, lr 3e-3, minibatch 128, 6 epochs, 12 iterations; the best
    mean reward must pass the first by 30."""
    rllib = _sub(rt, "rllib")
    algo = _cpu(rt, rllib.PPOConfig()
                .environment("CartPole-v1", **CARTPOLE)
                .env_runners(2)
                .training(train_batch_size=1024, lr=3e-3,
                          minibatch_size=128, num_epochs=6)).build()
    try:
        first, best = None, -np.inf
        for _ in range(12):
            r = algo.train()["episode_reward_mean"]
            if first is None and np.isfinite(r):
                first = r
            best = max(best, r if np.isfinite(r) else best)
        return [first is not None, bool(best > first + 30)]
    finally:
        algo.stop()


# -- test_rllib_catalog.py ---------------------------------------------------


def catalog_shapes(rt):
    cat = _sub(rt, "rllib.catalog")
    out = []
    m = cat.build_actor_critic({"obs_dim": 6, "num_actions": 3,
                                "hidden": (16, 16)}, **_dev(rt))
    logits, value = _apply(rt, m, _init(rt, m), np.zeros((4, 6)))
    out.append([list(logits.shape), list(value.shape)])
    cfg = {"obs_shape": (16, 16, 3), "num_actions": 4,
           "conv_filters": ((8, 3, 2), (16, 3, 2)), "hidden": (32,)}
    out.append(type(cat.build_encoder(cfg, **_dev(rt))).__name__)
    m = cat.build_actor_critic(cfg, **_dev(rt))
    logits, value = _apply(rt, m, _init(rt, m), np.zeros((2, 16, 16, 3)))
    out.append([list(logits.shape), list(value.shape)])
    m = cat.build_q_network({"obs_dim": 5, "num_actions": 2,
                             "hidden": (8,)}, **_dev(rt))
    out.append(list(_apply(rt, m, _init(rt, m, 1),
                           np.zeros((3, 5))).shape))
    try:
        cat.build_encoder({"obs_dim": 3, "encoder": "nope"})
    except ValueError as e:
        out.append("unknown encoder" in str(e))
    return out


def custom_encoder(rt):
    cat = _sub(rt, "rllib.catalog")
    calls = []
    if _port(rt):
        def build(cfg):
            calls.append(cfg["obs_dim"])
            return cat.MLPEncoder(cfg["obs_dim"], hidden=(4,),
                                  activation="relu")
    else:
        def build(cfg):
            calls.append(cfg["obs_dim"])
            return cat.MLPEncoder(hidden=(4,), activation="relu")
    cat.register_encoder("tiny", build)
    m = cat.build_actor_critic({"obs_dim": 7, "num_actions": 2,
                                "encoder": "tiny"}, **_dev(rt))
    logits, _ = _apply(rt, m, _init(rt, m), np.zeros((1, 7)))
    return [list(logits.shape), calls]


def checkpoint_and_actions(rt):
    """An algorithm built through the catalog trains one iteration
    (tests/test_rllib_catalog.py); save_to_path -> from_checkpoint
    restores the learner's parameters (bit for bit), its optimizer state
    and the iteration, locally and through a mock-s3 URI, and the
    restored algorithm resumes at the next iteration. Actions
    (tests/test_rllib.py::test_algorithm_compute_single_action): the
    greedy one is the argmax of the learner's logits, the same on both
    instances for 16 observations, and seeded exploration gives the same
    20 actions on both."""
    rllib = _sub(rt, "rllib")
    storage = _sub(rt, "util.storage")
    cfg = _cpu(rt, rllib.PPOConfig()
               .environment("CartPole-v1", **CARTPOLE, hidden=(16,))
               .env_runners(1))
    tmp = tempfile.mkdtemp(prefix="rllib_prog_")
    old = os.environ.get("RAY_TPU_MOCK_S3_DIR")
    algo = cfg.build()
    try:
        r = algo.train()
        out = [r["training_iteration"], bool(np.isfinite(r["total_loss"])),
               r["num_env_steps_sampled"]]
        path = os.path.join(tmp, "ckpt")
        algo.save_to_path(path)
        out.append(os.path.exists(os.path.join(path,
                                               "algorithm_state.pkl")))
        restored = type(algo).from_checkpoint(path, cfg)
        try:
            a = _leaves(rt, algo.learner.params)
            b = _leaves(rt, restored.learner.params)
            out.append(restored.iteration == algo.iteration)
            out.append(all(np.array_equal(x, y) for x, y in zip(a, b)))
            obs = np.random.default_rng(0).standard_normal(
                (16, 4)).astype(np.float32)
            greedy = [algo.compute_single_action(o) for o in obs]
            logits = _apply(rt, algo.learner.model, algo.learner.params,
                            obs)[0]
            out.append(greedy == np.argmax(logits, -1).tolist())
            out.append(greedy == [restored.compute_single_action(o)
                                  for o in obs])
            acts = [algo.compute_single_action(obs[0], explore=True)
                    for _ in range(20)]
            acts2 = [restored.compute_single_action(obs[0], explore=True)
                     for _ in range(20)]
            out.append(set(acts) <= {0, 1} and acts == acts2)
            out.append(restored.train()["training_iteration"])
        finally:
            restored.stop()
        os.environ["RAY_TPU_MOCK_S3_DIR"] = os.path.join(tmp, "s3root")
        storage.register_storage("mock-s3", storage.MockS3Storage)
        algo.save_to_path("mock-s3://ckpts/algo1")
        r2 = type(algo).from_checkpoint("mock-s3://ckpts/algo1", cfg)
        try:
            out.append(r2.iteration == algo.iteration)
        finally:
            r2.stop()
        return out
    finally:
        algo.stop()
        if old is None:
            os.environ.pop("RAY_TPU_MOCK_S3_DIR", None)
        else:
            os.environ["RAY_TPU_MOCK_S3_DIR"] = old
        shutil.rmtree(tmp, ignore_errors=True)


def save_restore_aliases(rt):
    ckpt = _sub(rt, "rllib.checkpoints")

    class Toy(ckpt.Checkpointable):
        def __init__(self):
            self.v = 0

        def get_state(self):
            return {"v": self.v}

        def set_state(self, state):
            self.v = state["v"]

    tmp = tempfile.mkdtemp(prefix="rllib_prog_")
    try:
        t = Toy()
        t.v = 41
        path = t.save(os.path.join(tmp, "ck"))
        t2 = Toy()
        t2.restore(path)
        t3 = Toy()
        first, second = t3.save(), t3.save()
        return [t2.v, os.path.basename(first), os.path.basename(second),
                os.path.dirname(first) == os.path.dirname(second)]
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


# -- test_rllib_recurrent.py -------------------------------------------------


def _rollout(rt, env, model, params, rng, n_episodes):
    """Episodes of ``model`` (a recurrent actor-critic) in ``env``, each
    step's forward through :func:`_apply`."""
    Episode = _sub(rt, "rllib.env_runner").Episode
    H = model.hidden_state
    episodes = []
    for _ in range(n_episodes):
        obs, _ = env.reset()
        carry = np.zeros((1, H), np.float32)
        ep = Episode()
        done = False
        while not done:
            logits, value, carry = _apply(rt, model, params, obs[None],
                                          carry)
            z = logits[0].astype(np.float64)
            probs = np.exp(z - z.max())
            probs /= probs.sum()
            a = int(rng.choice(len(probs), p=probs))
            nobs, r, term, trunc, _ = env.step(a)
            ep.obs.append(obs)
            ep.actions.append(a)
            ep.rewards.append(float(r))
            ep.logps.append(float(np.log(probs[a] + 1e-9)))
            ep.values.append(float(value[0]))
            obs = nobs
            done = term or trunc
        ep.terminated = True
        ep.last_value = 0.0
        episodes.append(ep)
    return episodes


def step_and_seq_agree(rt):
    cat = _sub(rt, "rllib.catalog")
    m = cat.build_recurrent_actor_critic(
        {"obs_dim": 3, "num_actions": 2, "hidden": (8,),
         "hidden_state": 6}, **_dev(rt))
    params = _init(rt, m)
    obs = np.asarray(np.random.default_rng(0).standard_normal((2, 7, 3)),
                     np.float32)
    c = np.zeros((2, 6), np.float32)
    stepped = []
    for t in range(7):
        lt, _vt, c = _apply(rt, m, params, obs[:, t], c)
        stepped.append(lt)
    ls, vs = _apply(rt, m, params, obs, np.zeros((2, 6), np.float32),
                    method="seq")
    return [bool(np.allclose(np.stack(stepped, 1), ls, rtol=1e-5,
                             atol=1e-5)), list(vs.shape)]


def recurrent_ppo_memory_task(rt):
    """A GRU policy must pass the 0.85 mean reward that no memoryless
    policy reaches (tests/test_rllib_recurrent.py)."""
    learner = _sub(rt, "rllib.learner")
    env = RecallEnv(horizon=5, seed=3)
    ln = learner.RecurrentJaxLearner(
        {"obs_dim": 1, "num_actions": 2, "hidden": (16,),
         "hidden_state": 16},
        learner.PPOHyperparams(lr=5e-3, num_epochs=4, minibatch_size=64,
                               entropy_coeff=0.003),
        max_seq_len=8, **_dev(rt))
    rng = np.random.default_rng(0)
    mean_r = 0.0
    for _ in range(25):
        eps = _rollout(rt, env, ln.model, ln.params, rng, 40)
        mean_r = float(np.mean([e.total_reward for e in eps]))
        if mean_r > 0.92:
            break
        ln.update_from_episodes(eps)
    return [bool(mean_r > 0.85)]


def env_runner_recurrent(rt):
    runner = rt.rllib.EnvRunner.remote(
        recall_env, {"obs_dim": 1, "num_actions": 2, "hidden": (8,),
                     "hidden_state": 8}, 0, "recurrent")
    try:
        eps = rt.get(runner.sample.remote(24), timeout=120)
        return [bool(eps), all(e.length == 4 for e in eps
                               if e.terminated),
                all(np.isfinite(v) for e in eps for v in e.values),
                all(e.state_in.shape == (8,) for e in eps)]
    finally:
        rt.kill(runner)


def segment_carries_ratio_one(rt):
    """Segments of a long episode replay from their true rollout carry:
    at epoch 0 the replayed log-probs equal the rollout's (1e-4)."""
    learner = _sub(rt, "rllib.learner")
    Episode = _sub(rt, "rllib.env_runner").Episode
    rng = np.random.default_rng(7)
    ln = learner.RecurrentJaxLearner(
        {"obs_dim": 2, "num_actions": 3, "hidden": (8,),
         "hidden_state": 8}, learner.PPOHyperparams(), max_seq_len=4,
        **_dev(rt))
    m, params = ln.model, ln.params
    ep = Episode()
    ep.state_in = np.zeros(8, np.float32)
    carry = np.zeros((1, 8), np.float32)
    for _ in range(11):                      # 11 steps -> 3 segments
        obs = rng.standard_normal(2).astype(np.float32)
        logits, value, carry = _apply(rt, m, params, obs[None], carry)
        z = logits[0].astype(np.float64)
        probs = np.exp(z - z.max())
        probs /= probs.sum()
        a = int(rng.choice(3, p=probs))
        ep.obs.append(obs)
        ep.actions.append(a)
        ep.rewards.append(0.0)
        ep.logps.append(float(np.log(probs[a])))
        ep.values.append(float(value[0]))
    ep.terminated = True
    batch = ln.compute_advantages([ep])
    logits, _v = _apply(rt, m, params, batch["obs"], batch["carry0"],
                        method="seq")
    z = logits.astype(np.float64)
    logp_all = z - z.max(-1, keepdims=True)
    logp_all -= np.log(np.exp(logp_all).sum(-1, keepdims=True))
    replay = np.take_along_axis(logp_all, batch["actions"][..., None],
                                axis=-1)[..., 0]
    mask = batch["mask"].astype(bool)
    return [batch["obs"].shape[0],
            bool(np.allclose(replay[mask], batch["logp_old"][mask],
                             rtol=1e-4, atol=1e-4))]


# -- test_rllib_connectors_offline.py ---------------------------------------


def connectors(rt):
    c = _sub(rt, "rllib.connectors")
    p = c.ConnectorPipelineV2([c.FlattenObs()])
    p.append(c.ClipObs(-1, 1))
    p.insert_before(c.ClipObs, c.Lambda(lambda x: x * 10))
    p.insert_after(c.ClipObs, c.Lambda(lambda x: x + 100))
    out = [p(np.array([[0.05, -0.2]]), {}).tolist()]
    p.remove(c.ClipObs)
    out.append(len(p))
    out.append(c.FlattenObs()({"b": np.ones((2, 2)),
                               "a": (3.0, 4.0)}).tolist())
    norm = c.NormalizeObs()
    rng = np.random.default_rng(0)
    for _ in range(500):
        last = norm(rng.normal(5.0, 2.0, size=4), {})
    out.append(last.tolist())
    fs = c.FrameStack(3)
    out.append([fs(np.array([1.0]), {"reset": True}).tolist(),
                fs(np.array([2.0]), {"reset": False}).tolist(),
                fs(np.array([9.0]), {"reset": True}).tolist()])
    out.append([float(c.ClipActions(-1, 1)(np.array([3.0]), {})[0]),
                float(c.UnsquashActions(low=[0.0], high=[10.0])(
                    np.array([0.0]), {})[0])])
    batch = c.GAE(gamma=0.5, lam=1.0, normalize=False)(
        [_episode(rt, 4, reward=1.0)], {})
    out.append([sorted(batch), list(batch["obs"].shape),
                batch["value_targets"].tolist()])
    return out


def env_runner_connectors(rt):
    c = _sub(rt, "rllib.connectors")
    r = rt.rllib.EnvRunner.remote("CartPole-v1",
                                  {"obs_dim": 8, "num_actions": 2}, 0,
                                  "categorical", [c.FrameStack(2)], [])
    try:
        eps = rt.get(r.sample.remote(40), timeout=120)
        return [bool(eps), all(o.shape == (8,) for e in eps for o in e.obs)]
    finally:
        rt.kill(r)


def env_runner_episodes(rt, weights):
    """An env runner carrying the JAX model's weights (``weights``, a
    flax tree of numpy arrays): its actions exactly, and its log-probs
    and values within 1e-6 of a numpy forward of the same weights. The
    actions come from the runner's numpy ``default_rng(0)`` on float32
    softmax probabilities, which the two frameworks round apart in the
    last bits: a draw would flip only within ~1e-7 of a cumulative
    bound, and at this seed none does."""
    carried = weights if not _port(rt) else torch_names(weights)
    r = rt.rllib.EnvRunner.remote("CartPole-v1", CARTPOLE, 0)
    try:
        rt.get(r.set_weights.remote(carried), timeout=120)
        eps = rt.get(r.sample.remote(64), timeout=120)
    finally:
        rt.kill(r)
    enc = weights["encoder"]
    errs = []
    for e in eps:
        x = np.stack(e.obs).astype(np.float64)
        for name in ("fc0", "fc1"):
            x = np.tanh(x @ enc[name]["kernel"] + enc[name]["bias"])
        logits = x @ weights["pi"]["kernel"] + weights["pi"]["bias"]
        values = (x @ weights["vf"]["kernel"] + weights["vf"]["bias"])[:, 0]
        logp = logits - logits.max(-1, keepdims=True)
        logp -= np.log(np.exp(logp).sum(-1, keepdims=True))
        chosen = logp[np.arange(len(e.actions)), e.actions]
        errs.append(max(np.abs(chosen - np.asarray(e.logps)).max(),
                        np.abs(values - np.asarray(e.values)).max()))
    return [[e.actions for e in eps], [e.terminated for e in eps],
            bool(max(errs) < 1e-6)]


def json_and_dataset(rt):
    off = _sub(rt, "rllib.offline")
    tmp = tempfile.mkdtemp(prefix="rllib_prog_")
    try:
        w = off.JsonWriter(tmp)
        w.write([_episode(rt, 5), _episode(rt, 3)])
        w.close()
        eps = off.JsonReader(tmp).read_episodes()
        ds = off.JsonReader(tmp).as_dataset()
        batches = list(off.DatasetReader(ds, batch_size=4).iter_batches())
        return [[e.length for e in eps], [e.obs[1].tolist() for e in eps],
                ds.count(), sum(len(b["obs"]) for b in batches),
                sorted(batches[0])]
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def is_wis(rt):
    off = _sub(rt, "rllib.offline")
    eps = [_episode(rt, 4, reward=1.0, logp=-0.5) for _ in range(8)]

    def like(obs, acts):
        return np.full(len(acts), -0.1, np.float32)

    def dislike(obs, acts):
        return np.full(len(acts), -2.0, np.float32)

    up = off.ImportanceSampling(gamma=1.0).estimate(eps, like)
    down = off.ImportanceSampling(gamma=1.0).estimate(eps, dislike)
    wis = off.WeightedImportanceSampling(gamma=1.0).estimate(eps, like)
    return [sorted(up.items()), sorted(down.items()),
            abs(wis["v_target"] - wis["v_behavior"]) < 1e-6]


def learner_group_identical(rt):
    rng = np.random.default_rng(0)
    n = 64
    batch = {
        "obs": rng.normal(size=(n, 4)).astype(np.float32),
        "actions": rng.integers(0, 2, n).astype(np.int64),
        "logp_old": np.full(n, -0.7, np.float32),
        "advantages": rng.normal(size=n).astype(np.float32),
        "returns": rng.normal(size=n).astype(np.float32),
    }
    group = rt.rllib.LearnerGroup({"obs_dim": 4, "num_actions": 2,
                                   "hidden": (16,)}, num_learners=2,
                                  seed=0, **_dev(rt))
    try:
        for _ in range(3):
            metrics = group.update(batch)
        d1, d2 = group.weights_digests()
        return [len(metrics), sorted(metrics[0]), d1 == d2]
    finally:
        group.shutdown()


def multi_agent_ppo(rt):
    rllib = rt.rllib
    pol = {"obs_dim": 2, "num_actions": 2, "hidden": (16,)}
    cfg = (rllib.MultiAgentPPOConfig()
           .environment(two_agent_env)
           .multi_agent(policies={"pa": pol, "pb": pol},
                        policy_mapping_fn=policy_of)
           .env_runners(1)
           .training(minibatch_size=32, num_epochs=2))
    algo = _cpu(rt, cfg).build()
    try:
        r = algo.train()
        keys = sorted(k for k in r if "/" in k)
        return [r["training_iteration"], keys,
                all(np.isfinite(r[k]) for k in keys),
                r["episodes_this_iter"]]
    finally:
        algo.stop()


def registered_env(rt):
    """An environment registered by name on the driver resolves inside
    the runner actors."""
    rt.tune.register_env("rllib_prog_cartpole", cartpole)
    algo = _cpu(rt, rt.rllib.PPOConfig()
                .environment("rllib_prog_cartpole", **CARTPOLE,
                             hidden=(16,))
                .env_runners(2)
                .training(train_batch_size=256)).build()
    try:
        r = algo.train()
        return [r["num_env_steps_sampled"], bool(np.isfinite(
            r["total_loss"]))]
    finally:
        algo.stop()


def bc_from_json(rt):
    """tests/test_rllib_connectors_offline.py::
    test_bc_trains_from_json_offline_data: expert episodes (action =
    obs[0] > 0) through JsonWriter/JsonReader into BC; accuracy > 0.85."""
    off = _sub(rt, "rllib.offline")
    Episode = _sub(rt, "rllib.env_runner").Episode
    rng = np.random.default_rng(0)
    eps = []
    for _ in range(10):
        e = Episode()
        for _ in range(20):
            o = rng.normal(size=2).astype(np.float32)
            e.obs.append(o)
            e.actions.append(int(o[0] > 0))
            e.rewards.append(0.0)
            e.logps.append(0.0)
            e.values.append(0.0)
        e.terminated = True
        eps.append(e)
    tmp = tempfile.mkdtemp(prefix="rllib_prog_")
    try:
        off.JsonWriter(tmp).write(eps)
        ds = off.JsonReader(tmp).as_dataset()
        algo = _cpu(rt, rt.rllib.BCConfig()
                    .environment(obs_dim=2, num_actions=2, hidden=(32,))
                    .offline_data(ds)
                    .training(lr=5e-3, train_batch_size=64)).build()
        for _ in range(30):
            out = algo.train()
        return [bool(out["accuracy"] > 0.85)]
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


# -- test_rllib_algos.py -----------------------------------------------------


def replay_buffer_circular(rt):
    dqn = _sub(rt, "rllib.dqn")
    Episode = _sub(rt, "rllib.env_runner").Episode
    buf = dqn.ReplayBuffer(capacity=8, obs_dim=2)
    ep = Episode(
        obs=[np.full(2, i, np.float32) for i in range(12)],
        actions=list(range(12)), rewards=[1.0] * 12,
        logps=[0.0] * 12, values=[0.0] * 12, terminated=True,
        final_obs=np.full(2, 12, np.float32))
    added = buf.add_episodes([ep])
    batch = buf.sample(16, np.random.default_rng(0))
    return [added, buf.size, list(batch["obs"].shape),
            bool(np.all(batch["next_obs"][:, 0] == batch["obs"][:, 0] + 1))]


def dqn_learner_reduces_td_error(rt):
    dqn = _sub(rt, "rllib.dqn")
    learner = dqn.DQNLearner({"obs_dim": 4, "num_actions": 2},
                             dqn.DQNHyperparams(lr=5e-3), seed=0,
                             **_dev(rt))
    rng = np.random.default_rng(0)
    batch = {
        "obs": rng.standard_normal((64, 4)).astype(np.float32),
        "actions": rng.integers(0, 2, 64).astype(np.int32),
        "rewards": rng.standard_normal(64).astype(np.float32),
        "next_obs": rng.standard_normal((64, 4)).astype(np.float32),
        "dones": np.zeros(64, np.float32),
    }
    first = learner.update(batch)["loss"]
    for _ in range(50):
        last = learner.update(batch)["loss"]
    return [bool(last < first)]


def vtrace_on_policy_rho_is_one(rt):
    """Behaviour log-probs equal to the target policy's: every importance
    weight is 1 (within 1e-4, the JAX test's)."""
    impala = _sub(rt, "rllib.impala")
    Episode = _sub(rt, "rllib.env_runner").Episode
    learner = impala.ImpalaLearner({"obs_dim": 3, "num_actions": 2},
                                   impala.ImpalaHyperparams(),
                                   max_seq_len=8, seed=0, **_dev(rt))
    rng = np.random.default_rng(1)
    obs = rng.standard_normal((6, 3)).astype(np.float32)
    logits, _ = _apply(rt, learner.model, learner.params, obs)
    z = logits.astype(np.float64)
    logp_all = z - z.max(-1, keepdims=True)
    logp_all -= np.log(np.exp(logp_all).sum(-1, keepdims=True))
    actions = [int(rng.integers(0, 2)) for _ in range(6)]
    ep = Episode(obs=list(obs), actions=actions, rewards=[1.0] * 6,
                 logps=[float(logp_all[t, a]) for t, a in enumerate(actions)],
                 values=[0.0] * 6, terminated=True, final_obs=obs[-1])
    m = learner.update_from_episodes([ep])
    return [bool(abs(m["mean_rho"] - 1.0) < 1e-4),
            bool(np.isfinite(m["total_loss"]))]


def squashed_gaussian_bounds_and_logp(rt):
    models = _sub(rt, "rllib.models")
    mu, log_std = np.zeros((32, 2), np.float32), np.zeros((32, 2), np.float32)
    if _port(rt):
        import torch
        a, logp = models.SquashedGaussianActor.sample(
            torch.from_numpy(mu), torch.from_numpy(log_std),
            torch.Generator().manual_seed(0))
    else:
        import jax
        a, logp = models.SquashedGaussianActor.sample(
            mu, log_std, jax.random.key(0))
    a, logp = np.asarray(a), np.asarray(logp)
    return [bool(np.all(np.abs(a) <= 1.0)), bool(np.all(np.isfinite(logp))),
            list(logp.shape)]


def _learns(algo, iters: int) -> list:
    try:
        return [algo.train()["episode_reward_mean"] for _ in range(iters)]
    finally:
        algo.stop()


def dqn_learns_chain(rt):
    """test_dqn_learns_chain: the last 5 iterations' mean reward > 0.6
    (optimal ≈ 0.94)."""
    rewards = _learns(_cpu(rt, rt.rllib.DQNConfig()
                           .environment(ChainEnv, obs_dim=8, num_actions=2,
                                        hidden=(32, 32))
                           .env_runners(1)
                           .training(learning_starts=200, train_batch_size=64,
                                     num_gradient_steps=4,
                                     epsilon_decay_iters=10,
                                     target_update_freq=1, lr=5e-4)).build(),
                      25)
    return [bool(np.nanmean(rewards[-5:]) > 0.6)]


def impala_learns_chain(rt):
    """test_impala_learns_chain: the last 5 iterations' mean > 0.5."""
    rewards = _learns(_cpu(rt, rt.rllib.ImpalaConfig()
                           .environment(ChainEnv, obs_dim=8, num_actions=2,
                                        hidden=(32, 32))
                           .env_runners(2)
                           .training(lr=5e-3, entropy_coeff=0.005,
                                     optimizer="adam")).build(), 35)
    return [bool(np.nanmean(rewards[-5:]) > 0.5)]


def appo_learns_chain(rt):
    """test_appo_learns_chain: the last 5 iterations' mean > 0.5."""
    rewards = _learns(_cpu(rt, rt.rllib.APPOConfig()
                           .environment(ChainEnv, obs_dim=8, num_actions=2,
                                        hidden=(32, 32))
                           .env_runners(2)
                           .training(lr=5e-3, entropy_coeff=0.005,
                                     broadcast_interval=2)).build(), 35)
    return [bool(np.nanmean(rewards[-5:]) > 0.5)]


def sac_learns_point1d(rt):
    """test_sac_learns_point1d: the last 5 iterations' mean past the first
    5's and > -3."""
    rewards = _learns(_cpu(rt, rt.rllib.SACConfig()
                           .environment(Point1DEnv, obs_dim=1, action_dim=1,
                                        hidden=(32, 32))
                           .env_runners(1)
                           .training(learning_starts=256, train_batch_size=128,
                                     num_gradient_steps=16)).build(), 25)
    early, late = np.nanmean(rewards[:5]), np.nanmean(rewards[-5:])
    return [bool(late > early), bool(late > -3.0)]


def bc_learns_offline(rt):
    """test_bc_learns_from_offline_data: accuracy > 0.9 on a linear
    expert's 512 (obs, action) pairs."""
    rng = np.random.default_rng(0)
    obs = rng.standard_normal((512, 4)).astype(np.float32)
    w = rng.standard_normal((4, 3)).astype(np.float32)
    actions = np.argmax(obs @ w, axis=1).astype(np.int64)
    ds = _sub(rt, "data").from_numpy({"obs": obs, "action": actions},
                                     parallelism=4)
    algo = _cpu(rt, rt.rllib.BCConfig()
                .environment(obs_dim=4, num_actions=3, hidden=(32, 32))
                .offline_data(ds)
                .training(lr=3e-3, num_gradient_steps=32)).build()
    for _ in range(7):
        m = algo.train()
    return [bool(m["accuracy"] > 0.9), m["num_samples"]]


def marwil_learns_offline(rt):
    """test_marwil_learns_from_offline_returns: the greedy policy matches
    the expert on > 75% of states though half the data is anti-expert."""
    rng = np.random.default_rng(1)
    obs = rng.standard_normal((512, 4)).astype(np.float32)
    w = rng.standard_normal((4, 3)).astype(np.float32)
    expert = np.argmax(obs @ w, axis=1).astype(np.int64)
    anti = np.argmin(obs @ w, axis=1).astype(np.int64)
    take_expert = rng.random(512) < 0.5
    ds = _sub(rt, "data").from_numpy(
        {"obs": obs, "action": np.where(take_expert, expert, anti),
         "return": np.where(take_expert, 1.0, -1.0).astype(np.float32)},
        parallelism=4)
    algo = _cpu(rt, rt.rllib.MARWILConfig()
                .environment(obs_dim=4, num_actions=3, hidden=(32, 32))
                .offline_data(ds)
                .training(lr=3e-3, beta=2.0, num_gradient_steps=32)).build()
    for _ in range(8):
        algo.train()
    logits, _ = _apply(rt, algo.learner.model, algo.learner.params, obs)
    return [bool((np.argmax(logits, 1) == expert).mean() > 0.75)]


def marwil_beta_zero_is_bc(rt):
    marwil = _sub(rt, "rllib.marwil")
    r = marwil.returns_from_rewards([1.0, 1.0, 1.0], [False, False, True],
                                    gamma=0.5)
    learner = marwil.MARWILLearner(
        {"obs_dim": 4, "num_actions": 3, "hidden": (16,)},
        marwil.MARWILHyperparams(beta=0.0), seed=0, **_dev(rt))
    rng = np.random.default_rng(0)
    m = learner.update({
        "obs": rng.standard_normal((32, 4)).astype(np.float32),
        "action": rng.integers(0, 3, 32),
        "return": rng.standard_normal(32).astype(np.float32)})
    return [r.tolist(), bool(abs(m["mean_weight"] - 1.0) < 1e-5)]


def cql_learns_point1d_offline(rt):
    """test_cql_learns_point1d_offline: from 4096 logged transitions of a
    noisy proportional controller, the learned policy's mean return over
    5 live episodes > -2.5 (random ~ -6)."""
    rng = np.random.default_rng(0)
    env = Point1DEnv()
    obs_l, act_l, rew_l, next_l, done_l = [], [], [], [], []
    o, _ = env.reset(seed=0)
    for t in range(4096):
        a = np.clip(-0.8 * o[0] + rng.normal() * 0.7, -1, 1)
        no, r, term, trunc, _ = env.step([a])
        obs_l.append(o)
        act_l.append([a])
        rew_l.append(r)
        next_l.append(no)
        done_l.append(float(term))
        o = no
        if term or trunc:
            o, _ = env.reset(seed=t)
    ds = _sub(rt, "data").from_numpy({
        "obs": np.asarray(obs_l, np.float32),
        "action": np.asarray(act_l, np.float32),
        "reward": np.asarray(rew_l, np.float32),
        "next_obs": np.asarray(next_l, np.float32),
        "done": np.asarray(done_l, np.float32)}, parallelism=4)
    algo = _cpu(rt, rt.rllib.CQLConfig()
                .environment(obs_dim=1, action_dim=1, hidden=(32, 32))
                .offline_data(ds)
                .training(train_batch_size=256, num_gradient_steps=32,
                          min_q_weight=1.0)).build()
    for _ in range(10):
        m = algo.train()
    total = 0.0
    for ep in range(5):
        env = Point1DEnv()
        o, _ = env.reset(seed=100 + ep)
        done = False
        while not done:
            mu, _ = _apply(rt, algo.learner.actor, algo.learner.actor_params,
                           np.asarray(o, np.float32)[None])
            o, r, term, trunc, _ = env.step(np.tanh(mu)[0])
            total += r
            done = term or trunc
    return ["cql_penalty" in m, bool(total / 5 > -2.5)]


def evaluate_full_episodes_only(rt):
    """test_algorithm_evaluate_full_episodes_only: after a train() that
    leaves the runners mid-episode, evaluate counts complete 5-step
    episodes of +1 only."""
    algo = _cpu(rt, rt.rllib.DQNConfig()
                .environment(FixedRewardEnv, obs_dim=2,
                             num_actions=2)).build()
    try:
        algo.train()
        ev = algo.evaluate(num_episodes=6)["evaluation"]
        return [ev["episodes"], ev["episode_reward_mean"],
                ev["episode_len_mean"]]
    finally:
        algo.stop()


def evaluate_stitches_long_episodes(rt):
    """test_evaluate_stitches_episodes_longer_than_a_round: 400-step
    episodes span two 256-step rounds and count once, whole."""
    algo = _cpu(rt, rt.rllib.DQNConfig()
                .environment(LongEnv, obs_dim=2, num_actions=2)
                .env_runners(1)).build()
    try:
        ev = algo.evaluate(num_episodes=2)["evaluation"]
        return [ev["episodes"], ev["episode_reward_mean"],
                ev["episode_len_mean"]]
    finally:
        algo.stop()


# -- test_rllib_dreamer.py ---------------------------------------------------


def _chain_episodes(rt, n, rng):
    """Random-policy ShortChainEnv episodes (world-model training data)."""
    Episode = _sub(rt, "rllib.env_runner").Episode
    eps = []
    env = ShortChainEnv()
    for _ in range(n):
        obs, _ = env.reset()
        ep = Episode()
        done = False
        while not done:
            a = int(rng.integers(2))
            nxt, r, term, trunc, _ = env.step(a)
            ep.obs.append(obs)
            ep.actions.append(a)
            ep.rewards.append(r)
            ep.logps.append(0.0)
            ep.values.append(0.0)
            obs = nxt
            done = term or trunc
        ep.terminated, ep.truncated = term, trunc
        ep.final_obs = obs
        eps.append(ep)
    return eps


def symlog_roundtrip(rt):
    d = _sub(rt, "rllib.dreamer")
    x = np.asarray([-100.0, -1.0, 0.0, 0.5, 30.0], np.float32)
    if _port(rt):
        import torch
        y = d.symexp(d.symlog(torch.from_numpy(x))).numpy()
    else:
        y = np.asarray(d.symexp(d.symlog(x)))
    return [bool(np.allclose(y, x, rtol=1e-5, atol=1e-5))]


def sequence_replay_segments(rt):
    d = _sub(rt, "rllib.dreamer")
    rng = np.random.default_rng(0)
    buf = d.SequenceReplay(capacity_steps=10_000, seq_len=8)
    buf.add_episodes(_chain_episodes(rt, 6, rng))
    batch = buf.sample(4, rng)
    return [list(batch["obs"].shape), list(batch["actions"].shape),
            sorted(batch), bool((batch["is_first"][:, 1:] == 0).all())]


WORLD_MODEL = dict(obs_dim=6, num_actions=2, embed=32, deter=32, n_cat=4,
                   n_classes=4, hidden=32)


def world_model_learns(rt, weights):
    """test_world_model_learns_reward_and_recon: 120 updates on random
    chain episodes; on a fixed held-out batch with a fixed latent-sampling
    noise, reward loss < 0.65x, recon < 0.6x and cont < 0.5x their
    values before. Both packages start from the JAX learner's initial
    ``weights`` (a flax tree of numpy arrays): the ratios are read
    against the initial losses, which the initial draw sets."""
    d = _sub(rt, "rllib.dreamer")
    rng = np.random.default_rng(0)
    cfg = d.DreamerModelConfig(**WORLD_MODEL)
    hp = d.DreamerHyperparams(batch_size=8, seq_len=8, horizon=5,
                              wm_lr=1e-3)
    learner = d.DreamerLearner(cfg, hp, seed=0, **_dev(rt))
    if _port(rt):
        learner.load_jax_params(weights)
    else:
        import jax
        learner.params = jax.tree_util.tree_map(jax.numpy.asarray, weights)
    buf = d.SequenceReplay(10_000, hp.seq_len)
    buf.add_episodes(_chain_episodes(rt, 40, rng))
    eval_np = buf.sample(32, rng)
    if _port(rt):
        import torch
        from ray_tpu_torch.rllib.learner import gumbel
        mb = {k: torch.from_numpy(v) for k, v in eval_np.items()}
        noise = gumbel((hp.seq_len, 32, cfg.n_cat, cfg.n_classes),
                       torch.Generator().manual_seed(123), "cpu")

        def eval_losses():
            with torch.no_grad():
                _t, aux, _out = learner._wm_loss(learner.module, mb, noise)
            return {k: float(v) for k, v in aux.items()}
    else:
        import jax
        import jax.numpy as jnp
        mb = {k: jnp.asarray(v) for k, v in eval_np.items()}
        key = jax.random.key(123)

        def eval_losses():
            _t, (aux, _out) = learner._wm_loss(learner.params, mb, key)
            return {k: float(v) for k, v in aux.items()}

    before = eval_losses()
    last = {}
    for _ in range(120):
        last = learner.update(buf.sample(hp.batch_size, rng))
    after = eval_losses()
    return [bool(after["reward_loss"] < before["reward_loss"] * 0.65),
            bool(after["recon_loss"] < before["recon_loss"] * 0.6),
            bool(after["cont_loss"] < before["cont_loss"] * 0.5),
            bool(np.isfinite(after["wm_loss"])),
            bool(np.isfinite(last["actor_loss"])),
            bool(np.isfinite(last["imag_return"]))]


def rollout_policy_protocol(rt):
    """test_rollout_policy_protocol: the carry advances, feed_action
    installs the chosen action, the posterior mode is deterministic."""
    d = _sub(rt, "rllib.dreamer")
    cfg = {"obs_dim": 4, "num_actions": 3, "deter": 16, "n_cat": 2,
           "n_classes": 4, "embed": 16, "hidden": 16}
    obs = np.zeros((1, 4), np.float32)
    if _port(rt):
        import torch
        pol = d.build_dreamer_policy(cfg, "cpu")
        carry = pol.initial_state(1)
        with torch.no_grad():
            logits, value, carry2 = pol(torch.from_numpy(obs), carry)
            l2, _v, _c = pol(torch.from_numpy(obs), carry)
    else:
        import jax
        pol = d.build_dreamer_policy(cfg)
        params = pol.init_params(jax.random.key(0))
        carry = pol.initial_state(1)
        logits, value, carry2 = pol.apply({"params": params}, obs, carry)
        l2, _v, _c = pol.apply({"params": params}, obs, carry)
    carry3 = pol.feed_action(carry2, 2)
    return [list(logits.shape), list(value.shape),
            float(np.abs(np.asarray(carry2[2])).sum()),
            np.asarray(carry3[2])[0].tolist(),
            bool(np.allclose(np.asarray(logits), np.asarray(l2)))]


def dreamer_end_to_end_and_checkpoint(rt):
    """test_dreamer_end_to_end_and_checkpoint: three train() iterations
    through a ``policy="dreamer"`` runner, save_to_path, a fresh
    algorithm restored at iteration 3 with finite parameters, one more
    iteration."""
    tmp = tempfile.mkdtemp(prefix="rllib_prog_")
    config = _cpu(rt, rt.rllib.DreamerConfig()
                  .environment(ShortChainEnv, obs_dim=ShortChainEnv.N,
                               num_actions=2, deter=32, n_cat=4,
                               n_classes=4, embed=32, hidden=32)
                  .env_runners(1)
                  .training(learning_starts=60, batch_size=4, seq_len=8,
                            horizon=5, wm_updates_per_iter=2))
    try:
        algo = config.build()
        try:
            for _ in range(3):
                result = algo.train()
            out = [result["training_iteration"],
                   bool(result["buffer_steps"] >= 60), "wm_loss" in result]
            path = os.path.join(tmp, "ckpt")
            algo.save_to_path(path)
        finally:
            algo.stop()
        restored = config.build()
        try:
            restored.restore_from_path(path)
            out.append(restored.iteration)
            out.append(all(np.isfinite(x).all() for x in
                           _leaves(rt, restored.learner.params)))
            out.append(restored.train()["training_iteration"])
        finally:
            restored.stop()
        return out
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


# -- the table ---------------------------------------------------------------

RLLIB = {
    "gae": gae,
    "learner_update": learner_update,
    "ppo_cartpole_learns": ppo_cartpole_learns,
    "catalog_shapes": catalog_shapes,
    "custom_encoder": custom_encoder,
    "checkpoint_and_actions": checkpoint_and_actions,
    "save_restore_aliases": save_restore_aliases,
    "step_and_seq_agree": step_and_seq_agree,
    "recurrent_ppo_memory_task": recurrent_ppo_memory_task,
    "env_runner_recurrent": env_runner_recurrent,
    "segment_carries_ratio_one": segment_carries_ratio_one,
    "connectors": connectors,
    "env_runner_connectors": env_runner_connectors,
    "env_runner_episodes": env_runner_episodes,
    "json_and_dataset": json_and_dataset,
    "is_wis": is_wis,
    "learner_group_identical": learner_group_identical,
    "multi_agent_ppo": multi_agent_ppo,
    "registered_env": registered_env,
    "bc_from_json": bc_from_json,
    "replay_buffer_circular": replay_buffer_circular,
    "dqn_learner_reduces_td_error": dqn_learner_reduces_td_error,
    "vtrace_on_policy_rho_is_one": vtrace_on_policy_rho_is_one,
    "squashed_gaussian_bounds_and_logp": squashed_gaussian_bounds_and_logp,
    "dqn_learns_chain": dqn_learns_chain,
    "impala_learns_chain": impala_learns_chain,
    "appo_learns_chain": appo_learns_chain,
    "sac_learns_point1d": sac_learns_point1d,
    "bc_learns_offline": bc_learns_offline,
    "marwil_learns_offline": marwil_learns_offline,
    "marwil_beta_zero_is_bc": marwil_beta_zero_is_bc,
    "cql_learns_point1d_offline": cql_learns_point1d_offline,
    "evaluate_full_episodes_only": evaluate_full_episodes_only,
    "evaluate_stitches_long_episodes": evaluate_stitches_long_episodes,
    "symlog_roundtrip": symlog_roundtrip,
    "sequence_replay_segments": sequence_replay_segments,
    "world_model_learns": world_model_learns,
    "rollout_policy_protocol": rollout_policy_protocol,
    "dreamer_end_to_end_and_checkpoint": dreamer_end_to_end_and_checkpoint,
}


def run(fn, rt, *args):
    """("ok", result) or ("raised", type, message) of one program."""
    try:
        return ("ok", fn(rt, *args))
    except Exception as e:  # noqa: BLE001 — the outcome is compared
        return ("raised", type(e).__name__, str(e)[:500])


def run_table(name: str, table: dict, inputs: dict) -> dict:
    """{program: outcome} of every program of ``table`` on package
    ``name``, in one runtime of ``num_cpus=4``; ``inputs[program]`` (the
    JAX package's initial weights, flax trees of numpy arrays) goes to
    the programs that take one."""
    import warnings
    rt = importlib.import_module(name)
    rt.init(num_cpus=4)
    try:
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            return {prog: run(fn, rt, *((inputs[prog],) if prog in inputs
                                        else ()))
                    for prog, fn in table.items()}
    finally:
        rt.shutdown()


# -- the host collective plane -----------------------------------------------


class Member:
    """A rank of a host collective group, on package ``pkg``."""

    def __init__(self, pkg: str, rank: int, world: int):
        self.coll = importlib.import_module(f"{pkg}.collective")
        self.rank, self.world = rank, world

    def join(self, group: str) -> bool:
        self.coll.init_collective_group(self.world, self.rank, group)
        return True

    def ops(self, group: str, tensors: bool) -> dict:
        """Every collective once; inputs as numpy, or as CPU torch
        tensors when ``tensors``."""
        c, r, w = self.coll, self.rank, self.world
        if tensors:
            import torch

            def x(a):
                return torch.as_tensor(np.asarray(a))
        else:
            def x(a):
                return np.asarray(a)
        out = {}
        total = c.allreduce(x(np.full(4, r + 1.0)), group)
        out["types"] = [type(total).__name__]
        out["sum"] = total.tolist()
        out["mean"] = (c.allreduce(x(np.full(2, float(r))), group)
                       / w).tolist()
        out["max"] = c.allreduce(x([float(r)]), group, op="max").tolist()
        out["min"] = c.allreduce(x([float(r)]), group, op="min").tolist()
        try:
            c.allreduce(x([1.0]), group, op="mean")
            out["op_mean"] = "no error"
        except ValueError as e:
            out["op_mean"] = str(e)
        gathered = c.allgather(x(np.array([r * 10.0])), group)
        out["allgather"] = [v.tolist() for v in gathered]
        out["types"].append(type(gathered[0]).__name__)
        out["reducescatter"] = c.reducescatter(x(np.arange(8.0) + r),
                                               group).tolist()
        out["broadcast"] = c.broadcast(
            x(np.array([99.0 if r == 2 else 0.0])), src_rank=2,
            group_name=group).tolist()
        c.barrier(group)
        out["barrier"] = True
        if r == 0:
            c.send(x(np.array([123.0, 4.0])), dst_rank=w - 1,
                   group_name=group)
            out["p2p"] = None
        elif r == w - 1:
            got = c.recv(0, group)
            out["p2p"] = [got.tolist(), type(got).__name__]
        else:
            out["p2p"] = None
        return out

    def leave(self, group: str) -> bool:
        self.coll.destroy_collective_group(group)
        return True


def collective_ops(rt, world: int = 4) -> list:
    """``world`` member actors join one group and run every collective
    on numpy inputs, then on torch tensors; the group is destroyed."""
    cls = rt.remote(Member)
    members = [cls.remote(rt.__name__, r, world) for r in range(world)]
    try:
        rt.get([m.join.remote("host_ops") for m in members], timeout=120)
        outs = [rt.get([m.ops.remote("host_ops", tensors)
                        for m in members], timeout=120)
                for tensors in (False, True)]
        rt.get([m.leave.remote("host_ops") for m in members], timeout=60)
        return outs
    finally:
        for m in members:
            rt.kill(m)


def expected_collective(world: int = 4) -> list:
    """What :func:`collective_ops` must give."""
    out = []
    for r in range(world):
        out.append({
            "types": ["ndarray", "ndarray"],
            "sum": [float(sum(range(1, world + 1)))] * 4,
            "mean": [sum(range(world)) / world] * 2,
            "max": [float(world - 1)], "min": [0.0],
            "op_mean": "unknown reduce op 'mean'",
            "allgather": [[i * 10.0] for i in range(world)],
            "reducescatter": (world * np.arange(8.0) + sum(range(world))
                              )[2 * r:2 * r + 2].tolist(),
            "broadcast": [99.0], "barrier": True,
            "p2p": ([[123.0, 4.0], "ndarray"] if r == world - 1 else None),
        })
    return [out, out]


EXPECTED = {
    "gae": [[1.75, 1.5, 1.0], [3, 2], True],
    "learner_update": [["entropy", "policy_loss", "total_loss", "vf_loss"],
                       True],
    "ppo_cartpole_learns": [True, True],
    "catalog_shapes": [[[4, 3], [4]], "CNNEncoder", [[2, 4], [2]], [3, 2],
                       True],
    "custom_encoder": [[1, 2], [7]],
    "checkpoint_and_actions": [1, True, 512, True, True, True, True, True,
                               True, 2, True],
    "save_restore_aliases": [41, "checkpoint_000001", "checkpoint_000002",
                             True],
    "step_and_seq_agree": [True, [2, 7]],
    "recurrent_ppo_memory_task": [True],
    "env_runner_recurrent": [True, True, True, True],
    "segment_carries_ratio_one": [3, True],
    "connectors": [
        [100.5, 99.0], 3, [3.0, 4.0, 1.0, 1.0, 1.0, 1.0],
        [-0.5370290279388428, -2.053279399871826, -0.841167688369751,
         0.32390546798706055],
        [[0.0, 0.0, 1.0], [0.0, 1.0, 2.0], [0.0, 0.0, 9.0]], [1.0, 5.0],
        [["actions", "advantages", "logps", "obs", "rewards",
          "value_targets"], [4, 3], [1.875, 1.75, 1.5, 1.0]]],
    "env_runner_connectors": [True, True],
    "env_runner_episodes": [
        [[1, 0, 0, 0, 1, 1, 1, 1, 1, 1, 1, 0, 1, 0],
         [1, 0, 1, 1, 0, 0, 0, 0, 1, 1, 1, 0, 1, 1, 1, 1, 1, 0, 0, 1, 1, 0,
          0, 1],
         [1, 0, 1, 0, 1, 0, 0, 1, 0, 1, 0, 1, 1, 0, 1, 0, 0, 0, 0, 1, 0, 0,
          0, 0, 0, 1]], [True, True, True], True],
    "json_and_dataset": [[5, 3], [[1.0, 1.0, 1.0], [1.0, 1.0, 1.0]], 8, 8,
                         ["action", "actions", "dones", "logps", "obs",
                          "rewards"]],
    "is_wis": [[("v_behavior", 4.0), ("v_gain", 4.95303249235305),
                ("v_target", 19.812129974365234)],
               [("v_behavior", 4.0), ("v_gain", 0.002478752051791749),
                ("v_target", 0.009915008209645748)], True],
    "learner_group_identical": [2, ["entropy", "policy_loss", "vf_loss"],
                                True],
    "multi_agent_ppo": [1, ["pa/entropy", "pa/policy_loss", "pa/total_loss",
                            "pa/vf_loss", "pb/entropy", "pb/policy_loss",
                            "pb/total_loss", "pb/vf_loss"], True, 24],
    "registered_env": [256, True],
    "bc_from_json": [True],
    "replay_buffer_circular": [12, 8, [16, 2], True],
    "dqn_learner_reduces_td_error": [True],
    "vtrace_on_policy_rho_is_one": [True, True],
    "squashed_gaussian_bounds_and_logp": [True, True, [32]],
    "dqn_learns_chain": [True],
    "impala_learns_chain": [True],
    "appo_learns_chain": [True],
    "sac_learns_point1d": [True, True],
    "bc_learns_offline": [True, 512],
    "marwil_learns_offline": [True],
    "marwil_beta_zero_is_bc": [[1.75, 1.5, 1.0], True],
    "cql_learns_point1d_offline": [True, True],
    "evaluate_full_episodes_only": [6, 5.0, 5.0],
    "evaluate_stitches_long_episodes": [2, 400.0, 400.0],
    "symlog_roundtrip": [True],
    "sequence_replay_segments": [[4, 8, 6], [4, 8],
                                 ["actions", "cont", "is_first", "obs",
                                  "rewards"], True],
    "world_model_learns": [True, True, True, True, True, True],
    "rollout_policy_protocol": [[1, 3], [1], 0.0, [0.0, 0.0, 1.0], True],
    "dreamer_end_to_end_and_checkpoint": [3, True, True, 3, True, 4],
}
