"""Model families of the port (GPT: serving and the single-device train
step so far)."""
from . import gpt  # noqa: F401
