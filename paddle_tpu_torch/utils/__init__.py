"""paddle.utils, the part the port has so far: ``checkpoint`` (the
checkpoint manager and auto-resume; port of ``paddle_tpu/utils``). The
rest of the reference's ``utils`` (unique_name, download, dlpack,
cpp_extension, the profiler and install checks) is ROADMAP Queue 1 step
S."""
from . import checkpoint  # noqa: F401
