"""Regularizers. Port of ``paddle_tpu/regularizer.py``: the optimizers
read the coefficient (``L2Decay`` adds ``coeff * p`` to the gradient,
``L1Decay`` adds ``coeff * sign(p)``)."""


class WeightDecayRegularizer:
    def __init__(self, coeff=0.0):
        self._coeff = coeff

    def __repr__(self):
        return f'{type(self).__name__}({self._coeff})'


class L1Decay(WeightDecayRegularizer):
    pass


class L2Decay(WeightDecayRegularizer):
    pass
