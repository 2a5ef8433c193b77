"""Model families of the port (GPT's serving path so far)."""
from . import gpt  # noqa: F401
