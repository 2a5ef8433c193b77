"""paddle.callbacks parity namespace -> hapi.callbacks."""
from .hapi.callbacks import (  # noqa: F401
    Callback, EarlyStopping, LRScheduler, ModelCheckpoint, ProgBarLogger,
    ReduceLROnPlateau, VisualDL)
