"""Model families of the port: GPT and the Mixtral-style MoE GPT
(serving and the single-device train step)."""
from . import gpt, moe_gpt  # noqa: F401
