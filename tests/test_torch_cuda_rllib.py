"""Card-only tests of RLlib on the port: chip_smoke.py phase 19's (b) and
(e) at CartPole's size, read and held by chip_smoke's own
``learner_pair``/``pair_checks`` and ``group_leg``:

- (b) one ``update_from_episodes`` (1024 steps of CartPole-v1's dynamics
  under a uniform random policy, numpy seed 0; minibatch 128 x 6 epochs)
  by the learner on the card against the same learner on the CPU from the
  same weights, within LEARNER_UPDATE_RTOL of the update and
  LEARNER_METRIC_RTOL on the metrics; one capture; the recurrent learner
  the same way (phase 19's (d));
- (e) a LearnerGroup of two learners at ``GPU: 0.5`` on the CartPole
  model and a 512-row batch: equal digests after 3 updates, one shared
  card, the first update against the in-process mean-gradient update;
- (g) each of the eight other learners (IMPALA, APPO, DQN, SAC, CQL, BC,
  MARWIL, Dreamer) at the JAX tests' widths, read by chip_smoke's
  ``algo_learners``/``algo_pair``/``algo_pair_checks``: one update on the
  card against the CPU from the same weights, batch and noise (the
  gradients within LEARNER_GRAD_RTOL, the update within
  LEARNER_UPDATE_RTOL of its size), and for the MLP learners a whole
  iteration; and the SAC learner that steps its actor before its critic
  failing that check.

Marked ``cuda``: run on a host with a card with

    python -m pytest --noconftest -m cuda tests/test_torch_cuda_rllib.py

They skip, from inside the fixture, where no GPU is visible.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

import chip_smoke as cs

pytestmark = pytest.mark.cuda

CARTPOLE = {"obs_dim": 4, "num_actions": 2}


@pytest.fixture(scope="module")
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: run with -m cuda on a host with a "
                    "card")
    return cs.card_line()


def random_episodes(steps: int, seed: int = 0) -> list:
    """``steps`` steps of ChipCartPole under a uniform random policy."""
    from ray_tpu_torch.rllib.env_runner import Episode
    env, rng = cs.ChipCartPole(), np.random.default_rng(seed)
    obs, _ = env.reset(seed=seed)
    out, ep = [], Episode()
    for _ in range(steps):
        a = int(rng.integers(2))
        nobs, r, term, trunc, _ = env.step(a)
        ep.obs.append(obs)
        ep.actions.append(a)
        ep.rewards.append(r)
        ep.logps.append(float(np.log(0.5)))
        ep.values.append(0.0)
        obs = nobs
        if term or trunc:
            ep.terminated, ep.truncated = term, trunc
            out.append(ep)
            ep = Episode()
            obs, _ = env.reset()
    if ep.length:
        out.append(ep)
    return out


def test_learner_on_the_card_against_the_cpu(card):
    from ray_tpu_torch.rllib.catalog import build_actor_critic
    from ray_tpu_torch.rllib.learner import PPOHyperparams
    hp = PPOHyperparams(lr=3e-3, minibatch_size=128, num_epochs=6)
    weights = {k: p.detach().clone() for k, p in build_actor_critic(
        CARTPOLE, device="cpu").named_parameters()}
    pair = cs.learner_pair(CARTPOLE, hp, weights, random_episodes(1024))
    print(cs.describe_pair(pair))
    checks = cs.pair_checks(pair, "(b)") + [
        ("(b) one capture", pair["card"]["captures"] == 1,
         pair["card"]["captures"])]
    assert cs.report_checks(checks, card, strict=False, prefix="rllib")


def test_recurrent_learner_on_the_card_against_the_cpu(card):
    _, checks = cs.recurrent_leg(card)
    assert cs.report_checks(checks, card, strict=False, prefix="rllib")


def test_learner_group_on_one_card(card):
    import ray_tpu_torch
    rng = np.random.default_rng(0)
    n = 512
    batch = {"obs": rng.standard_normal((n, 4)).astype(np.float32),
             "actions": rng.integers(0, 2, n).astype(np.int64),
             "logp_old": np.full(n, -np.log(2), np.float32),
             "advantages": rng.standard_normal(n).astype(np.float32),
             "returns": rng.standard_normal(n).astype(np.float32)}
    ray_tpu_torch.init(num_gpus=1)
    try:
        readings, checks = cs.group_leg(2, card, "(e)", policy=CARTPOLE,
                                        batch=batch)
    finally:
        ray_tpu_torch.shutdown()
    assert cs.report_checks(checks, card, strict=False, prefix="rllib")


ALGOS = ("impala", "appo", "dqn", "sac", "cql", "bc", "marwil", "dreamer")


@pytest.mark.parametrize("name", ALGOS)
def test_algorithm_learner_on_the_card_against_the_cpu(card, name):
    r = cs.algo_pair(cs.algo_learners()[name])
    print(cs.describe_algo_pair(name, r))
    assert cs.report_checks(cs.algo_pair_checks(name, r), card,
                            strict=False, prefix="rllib")


def test_sac_actor_on_the_stale_critic_fails_the_card_check(card):
    r = cs.algo_pair(cs.algo_learners("sac_stale_critic")["sac"])
    assert not cs.report_checks(cs.algo_pair_checks("sac", r), card,
                                strict=False, prefix="rllib")
