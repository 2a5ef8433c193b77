"""paddle.utils, the part the port has so far: ``checkpoint`` (the
checkpoint manager and auto-resume; port of ``paddle_tpu/utils``) and
the profiler's names (``Profiler``, ``ProfilerOptions``,
``get_profiler``). The rest of the reference's ``utils`` (unique_name,
download, dlpack, cpp_extension, the install checks) is ROADMAP Queue 1
step S."""
from . import checkpoint  # noqa: F401
from ..profiler import Profiler, ProfilerOptions, get_profiler  # noqa: F401
