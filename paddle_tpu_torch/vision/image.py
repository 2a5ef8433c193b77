"""The image backend (``paddle_tpu/vision/image.py``): ROADMAP Queue 1
item 9, step H (rest); each name raises (``vision/_deferred.py``)."""
from ._deferred import install

install(globals(), functions=('get_image_backend', 'image_load',
                              'set_image_backend'))
