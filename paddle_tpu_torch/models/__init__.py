"""Model families of the port: GPT and the Mixtral-style MoE GPT
(serving and the single-device train step), the ERNIE encoder (serving
through ``serving.InferenceEngine`` and pretraining), the PP-YOLOE-class
detector and the SVTR-lite and CRNN text recognizers."""
from . import ernie, gpt, moe_gpt  # noqa: F401
from .crnn import CRNN  # noqa: F401
from .decode_cache import DecodeFnCache, clear_decode_caches  # noqa: F401
from .ernie import ErnieConfig, ErnieModel  # noqa: F401
from .ppyolo_lite import PPYOLOE, PPYOLOELite  # noqa: F401
from .svtr import SVTRLite  # noqa: F401
