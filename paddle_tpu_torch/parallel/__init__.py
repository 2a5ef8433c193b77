"""Parallelism of the port. So far the single-device Mixture-of-Experts
layer (``moe``); device meshes, expert and tensor parallelism wait for
ROADMAP Queue 1 step K."""
from . import moe  # noqa: F401
