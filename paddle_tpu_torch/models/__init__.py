"""Model families of the port: GPT and the Mixtral-style MoE GPT
(serving and the single-device train step), and the ERNIE encoder
(serving through ``serving.InferenceEngine`` and pretraining)."""
from . import ernie, gpt, moe_gpt  # noqa: F401
from .ernie import ErnieConfig, ErnieModel  # noqa: F401
