"""Environments: the protocol (``base``), the built-in batched envs, the
problem adapters and the host-env path."""

from .acrobot import Acrobot
from .adapters import MDPEnv, POMDPEnv
from .base import Env, auto_reset
from .cartpole import CartPole
from .compat import HostEnv
from .gridworld import SimpleGridWorld
from .mountain_car import MountainCar
from .test_mdp import TestMDP
from .tiger import TigerPOMDP

__all__ = ["Acrobot", "CartPole", "Env", "HostEnv", "MDPEnv",
           "MountainCar", "POMDPEnv", "SimpleGridWorld", "TestMDP",
           "TigerPOMDP", "auto_reset"]
