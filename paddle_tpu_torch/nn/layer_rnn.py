"""RNN layers (``paddle_tpu/nn/layer_rnn.py``): step J3, each name raises
(``nn/_deferred.py``)."""
from ._deferred import install

install(globals(), layers=('BiRNN', 'GRU', 'GRUCell', 'LSTM', 'LSTMCell',
                           'RNN', 'SimpleRNN', 'SimpleRNNCell', '_CellBase'))
