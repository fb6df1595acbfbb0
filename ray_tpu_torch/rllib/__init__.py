"""ray_tpu_torch.rllib — reinforcement learning (RLlib analog, new API
stack) on the port's runtime.

Counterpart of ``ray_tpu.rllib``. Reference shape (SURVEY.md §3.7):
EnvRunnerGroup of actors collects episodes on the CPU → the Learner does
SGD on the card → weights go back to the runners through the object
store. The learner is a **TorchLearner** whose minibatch update is one
captured CUDA graph per minibatch shape (``train.step``); a
**LearnerGroup** of learner actors, each on its share of a card,
ring-allreduces gradients over the host collective plane
(``ray_tpu_torch.collective``).

Ported: PPO, its learner and the recurrent learner (``JaxLearner`` and
``RecurrentJaxLearner`` are aliases of them), the catalog and models,
the env runners, connectors, checkpoints, ``LearnerGroup``, multi-agent
PPO, offline data, and the other algorithms: IMPALA and APPO (V-trace),
DQN with its ``ReplayBuffer``, SAC and CQL, BC and MARWIL, and Dreamer.
Each learner runs on the card by default (``.learners(device="cpu")`` on
a config asks for the CPU) and updates through captured steps
(``train.step``); the env runners stay on the CPU.
"""

from ray_tpu_torch.rllib.algorithm import AlgorithmConfig, PPO, PPOConfig
from ray_tpu_torch.rllib.appo import APPO, APPOConfig
from ray_tpu_torch.rllib.bc import BC, BCConfig
from ray_tpu_torch.rllib.cql import CQL, CQLConfig
from ray_tpu_torch.rllib.dqn import DQN, DQNConfig, ReplayBuffer
from ray_tpu_torch.rllib.dreamer import Dreamer, DreamerConfig
from ray_tpu_torch.rllib.env_runner import EnvRunner, EnvRunnerGroup, Episode
from ray_tpu_torch.rllib.impala import Impala, ImpalaConfig
from ray_tpu_torch.rllib.learner import (
    JaxLearner,
    RecurrentJaxLearner,
    RecurrentTorchLearner,
    TorchLearner,
)
from ray_tpu_torch.rllib.learner_group import LearnerGroup
from ray_tpu_torch.rllib.marwil import MARWIL, MARWILConfig
from ray_tpu_torch.rllib.multi_agent import (
    MultiAgentEnv, MultiAgentEnvRunner, MultiAgentPPO,
    MultiAgentPPOConfig,
)
from ray_tpu_torch.rllib.sac import SAC, SACConfig
from ray_tpu_torch.rllib import connectors
from ray_tpu_torch.rllib import offline
from ray_tpu_torch.rllib.connectors import ConnectorPipelineV2, ConnectorV2

__all__ = [
    "AlgorithmConfig", "PPO", "PPOConfig",
    "APPO", "APPOConfig", "BC", "BCConfig", "CQL", "CQLConfig",
    "DQN", "DQNConfig", "ReplayBuffer",
    "Dreamer", "DreamerConfig",
    "Impala", "ImpalaConfig", "MARWIL", "MARWILConfig",
    "connectors", "offline", "ConnectorV2", "ConnectorPipelineV2",
    "LearnerGroup",
    "SAC", "SACConfig",
    "EnvRunner", "EnvRunnerGroup", "Episode", "JaxLearner",
    "RecurrentJaxLearner",
    "MultiAgentPPO", "MultiAgentPPOConfig", "MultiAgentEnvRunner",
]

# The JAX package's names this package lacks: none since the eight
# algorithms were ported.
_NOT_PORTED: tuple[str, ...] = ()
