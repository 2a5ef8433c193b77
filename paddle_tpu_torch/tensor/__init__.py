"""Tensor op library — aggregated namespace (paddle.tensor parity). Port of
``paddle_tpu/tensor/__init__.py``."""
from .creation import *  # noqa: F401,F403
from .math import *  # noqa: F401,F403
from .manipulation import *  # noqa: F401,F403
from .logic import *  # noqa: F401,F403
from .linalg import *  # noqa: F401,F403
from .search import *  # noqa: F401,F403
from .stat import *  # noqa: F401,F403
from .attribute import shape, rank, is_complex, is_floating_point, is_integer  # noqa: F401
from .einsum import einsum  # noqa: F401
from .random import (  # noqa: F401
    bernoulli, multinomial, normal, poisson, rand, randint, randint_like,
    randn, randperm, seed, standard_normal, uniform)
from . import fft  # noqa: F401
from . import signal  # noqa: F401
from .inplace_and_array import (  # noqa: F401
    add_, array_length, array_read, array_write, ceil_, clip_, create_array,
    exp_, flatten_, floor_, reciprocal_, round_, rsqrt_, scale_, sqrt_,
    subtract_, uniform_)
from ..core.dispatch import apply_op, op  # noqa: F401
from ..core.tensor import Tensor, to_tensor  # noqa: F401
from .register import install as _install

_install()

from ..compat_api import (  # noqa: F401,E402
    add_n, diagonal, scatter_, set_printoptions, t, tanh_,
    unique_consecutive, unstack)
