"""Batched environments."""

from .acrobot import Acrobot
from .cartpole import CartPole
from .gridworld import SimpleGridWorld
from .mountain_car import MountainCar

__all__ = ["Acrobot", "CartPole", "MountainCar", "SimpleGridWorld"]
