"""Numeric helpers, the sum tree, and the hand-written CUDA kernels."""
from . import sumtree
from .helpers import batch_trajectories, flattenbatch, globalnorm, huber_loss
