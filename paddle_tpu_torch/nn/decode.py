"""Beam-search decoding (``paddle_tpu/nn/decode.py``): step J3, each name
raises (``nn/_deferred.py``)."""
from ._deferred import install

install(globals(), functions=('dynamic_decode',),
        classes=('BeamSearchDecoder',))
