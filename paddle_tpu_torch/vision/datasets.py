"""Vision datasets (``paddle_tpu/vision/datasets``): ROADMAP Queue 1 item
9, step H (rest); each name raises (``vision/_deferred.py``)."""
from ._deferred import install

install(globals(), classes=('Cifar10', 'Cifar100', 'DatasetFolder',
                            'FashionMNIST', 'Flowers', 'ImageFolder', 'MNIST',
                            'VOC2012'))
