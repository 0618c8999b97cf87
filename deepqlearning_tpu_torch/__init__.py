"""deepqlearning_tpu_torch — the PyTorch + CUDA port of deepqlearning_tpu.

``DeepQLearningSolver.solve`` (the solver layer: policy, evaluation,
checkpoints, problem adapters and the host-env path) over the feed-forward,
prioritized-replay, dueling double-DQN actor-learner loop and the recurrent
(DRQN) loop over episode replay (``learner/loop.py::build_loop``; on the
card, the feed-forward routes run as replays of one CUDA graph per
iteration, ``learner/segment.py``) on NVIDIA Hopper GPUs, on one card or
data-parallel over ``torch.distributed`` ranks (``parallel/``), with the JAX
package's Pallas kernels rewritten as hand-written CUDA kernels
(``csrc/``, bound in ``ops/cuda/``). Module paths and public names mirror
``deepqlearning_tpu``; this package imports PyTorch and never JAX.
"""

from .config import DQNConfig
from .envs.acrobot import Acrobot
from .envs.adapters import MDPEnv, POMDPEnv
from .envs.base import Env
from .envs.cartpole import CartPole
from .envs.compat import HostEnv
from .envs.gridworld import SimpleGridWorld
from .envs.mountain_car import MountainCar
from .envs.test_mdp import TestMDP
from .envs.tiger import TigerPOMDP
from .learner.loop import LoopCarry, build_loop, init_carry, populate
from .learner.segment import make_collect_graph, make_segment
from .models.chain import (
    GRU, LSTM, Activation, Chain, Conv2D, Dense, Flatten, isrecurrent)
from .models.dueling import DuelingNetwork, create_dueling_network
from .ops.helpers import (
    batch_trajectories, flattenbatch, globalnorm, huber_loss)
from .parallel.dryrun import dryrun_multichip
from .parallel.mesh import DataParallelRunner, make_mesh
from .replay.episode import (
    EpisodeBatch, EpisodeDraws, EpisodeReplayBuffer, EpisodeReplayState)
from .replay.prioritized import PrioritizedReplayBuffer, ReplayBuffer, ReplayState
from .replay.transition import DQExperience, TransitionBatch
from .solver.evaluation import basic_evaluation, evaluation
from .solver.exploration import (
    ConstantEpsilon,
    EpsGreedyPolicy,
    LinearDecaySchedule,
    VectorizedStrategy,
    epsilon_greedy_select,
    exploration,
    linear_epsilon_greedy,
)
from .solver.policy import AbstractNNPolicy, NNPolicy, getnetwork, resetstate
from .solver.solver import DeepQLearningSolver, restore_best_model, solve

__all__ = [
    "DeepQLearningSolver", "solve", "restore_best_model", "AbstractNNPolicy",
    "NNPolicy", "getnetwork", "resetstate", "EpsGreedyPolicy",
    "VectorizedStrategy", "exploration", "linear_epsilon_greedy",
    "basic_evaluation", "evaluation", "TigerPOMDP", "HostEnv", "MDPEnv",
    "POMDPEnv", "DQNConfig", "Env", "SimpleGridWorld", "TestMDP", "CartPole",
    "MountainCar", "Acrobot", "LoopCarry",
    "build_loop", "DataParallelRunner", "make_mesh", "dryrun_multichip",
    "init_carry", "populate", "make_segment", "make_collect_graph",
    "Activation", "Chain", "Conv2D", "Dense",
    "Flatten",
    "GRU", "LSTM", "isrecurrent", "EpisodeBatch", "EpisodeDraws",
    "EpisodeReplayBuffer", "EpisodeReplayState",
    "DuelingNetwork", "create_dueling_network", "batch_trajectories",
    "flattenbatch", "globalnorm",
    "huber_loss", "PrioritizedReplayBuffer", "ReplayBuffer", "ReplayState",
    "DQExperience", "TransitionBatch", "ConstantEpsilon",
    "LinearDecaySchedule", "epsilon_greedy_select",
]

__version__ = "0.1.0"
