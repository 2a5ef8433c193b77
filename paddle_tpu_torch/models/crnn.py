"""CRNN text recognizer (conv backbone + BiLSTM + CTC head). Port of
``paddle_tpu/models/crnn.py``; trains with ``nn.CTCLoss``."""
from .. import nn
from ..tensor.manipulation import squeeze, transpose


class ConvBNRelu(nn.Layer):
    def __init__(self, cin, cout, k=3, s=1, p=1):
        super().__init__()
        self.conv = nn.Conv2D(cin, cout, k, stride=s, padding=p,
                              bias_attr=False)
        self.bn = nn.BatchNorm2D(cout)
        self.act = nn.ReLU()

    def forward(self, x):
        return self.act(self.bn(self.conv(x)))


class CRNN(nn.Layer):
    """Input: [N, 1, 32, W] grayscale strips -> logits [N, W/4,
    num_classes]."""

    def __init__(self, num_classes=96, hidden_size=96, in_channels=1):
        super().__init__()
        self.backbone = nn.Sequential(
            ConvBNRelu(in_channels, 32), nn.MaxPool2D(2, 2),      # 16 x W/2
            ConvBNRelu(32, 64), nn.MaxPool2D(2, 2),               # 8 x W/4
            ConvBNRelu(64, 128),
            ConvBNRelu(128, 128), nn.MaxPool2D((2, 1), (2, 1)),   # 4 x W/4
            ConvBNRelu(128, 256), nn.MaxPool2D((4, 1), (4, 1)),   # 1 x W/4
        )
        self.rnn = nn.LSTM(256, hidden_size, num_layers=2,
                           direction='bidirect')
        self.head = nn.Linear(2 * hidden_size, num_classes)

    def forward(self, x):
        feat = self.backbone(x)                       # [N, C, 1, T]
        feat = squeeze(feat, 2)                       # [N, C, T]
        feat = transpose(feat, [0, 2, 1])             # [N, T, C]
        seq, _ = self.rnn(feat)
        return self.head(seq)                         # [N, T, classes]
