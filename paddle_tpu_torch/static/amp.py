"""paddle.static.amp: the dygraph amp names, as the reference maps them."""
from ..amp import auto_cast, GradScaler, decorate  # noqa: F401
