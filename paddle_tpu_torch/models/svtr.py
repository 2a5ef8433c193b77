"""SVTR-lite text recognizer (PP-OCRv3's recognition architecture class).
Port of ``paddle_tpu/models/svtr.py``.

A single visual model that mixes local (conv) and global (self-attention)
token interactions over the image grid, with a height-pooled CTC head: no
recurrence, one feed-forward program. Input [N, in_channels, 32, W] ->
logits [N, W/4, num_classes] (CTC).

Attention is ``nn.MultiHeadAttention``, whose route to the flash kernels
takes head dims 64, 128 and 256 (``nn.functional.
scaled_dot_product_attention``). At the defaults (dim 96, 4 heads) the head
dim is 24, so SVTR-lite's attention takes the plain softmax route, as the
reference's does on its side (``flash_attention_available``).
"""
from .. import nn
from ..tensor.manipulation import reshape, transpose
from ..tensor.stat import mean


class _ConvBNGelu(nn.Layer):
    def __init__(self, cin, cout, k=3, s=2):
        super().__init__()
        self.conv = nn.Conv2D(cin, cout, k, stride=s, padding=k // 2,
                              bias_attr=False)
        self.bn = nn.BatchNorm2D(cout)
        self.act = nn.GELU()

    def forward(self, x):
        return self.act(self.bn(self.conv(x)))


class _MLP(nn.Layer):
    def __init__(self, d, mult=2):
        super().__init__()
        self.fc1 = nn.Linear(d, d * mult)
        self.act = nn.GELU()
        self.fc2 = nn.Linear(d * mult, d)

    def forward(self, x):
        return self.fc2(self.act(self.fc1(x)))


class _LocalMixer(nn.Layer):
    """Conv token mixing on the [H, W] grid (SVTR's local block): a
    depthwise 3x3 conv over the grid, [N, T, D] tokens in and out. The grid
    height is fixed by the model (img_h // 4); the width follows from the
    token count."""

    def __init__(self, d, grid_h):
        super().__init__()
        self.h = grid_h
        self.conv = nn.Conv2D(d, d, 3, padding=1, groups=d)

    def forward(self, x):
        n, t = x.shape[0], x.shape[1]
        w = t // self.h
        g = transpose(reshape(x, (n, self.h, w, -1)), [0, 3, 1, 2])
        g = self.conv(g)
        return reshape(transpose(g, [0, 2, 3, 1]), (n, t, -1))


class _GlobalMixer(nn.Layer):
    """Self-attention token mixing (SVTR's global block)."""

    def __init__(self, d, heads):
        super().__init__()
        self.attn = nn.MultiHeadAttention(d, heads)

    def forward(self, x):
        return self.attn(x)


class _MixBlock(nn.Layer):
    def __init__(self, d, mixer):
        super().__init__()
        self.norm1 = nn.LayerNorm(d)
        self.mixer = mixer
        self.norm2 = nn.LayerNorm(d)
        self.mlp = _MLP(d)

    def forward(self, x):
        x = x + self.mixer(self.norm1(x))
        return x + self.mlp(self.norm2(x))


class SVTRLite(nn.Layer):
    """SVTR-lite: conv patch stem -> mixed local/global token blocks on the
    [8, W/4] grid -> height-pooled CTC head."""

    def __init__(self, num_classes=96, dim=96, num_heads=4, in_channels=1,
                 img_h=32):
        super().__init__()
        self.dim, self.grid_h = dim, img_h // 4
        self.stem = nn.Sequential(_ConvBNGelu(in_channels, dim // 2),
                                  _ConvBNGelu(dim // 2, dim))     # /4 x /4
        self.block1 = _MixBlock(dim, _LocalMixer(dim, self.grid_h))
        self.block2 = _MixBlock(dim, _GlobalMixer(dim, num_heads))
        self.block3 = _MixBlock(dim, _LocalMixer(dim, self.grid_h))
        self.block4 = _MixBlock(dim, _GlobalMixer(dim, num_heads))
        self.norm = nn.LayerNorm(dim)
        self.head = nn.Linear(dim, num_classes)

    def forward(self, x):
        n, _, h, w = x.shape
        feat = self.stem(x)                               # [N, D, 8, W/4]
        gh, gw = h // 4, w // 4
        tok = reshape(transpose(feat, [0, 2, 3, 1]), (n, gh * gw, self.dim))
        tok = self.block4(self.block3(self.block2(self.block1(tok))))
        tok = self.norm(tok)
        grid = reshape(tok, (n, gh, gw, self.dim))
        seq = mean(grid, axis=1)                          # [N, W/4, D]
        return self.head(seq)                             # CTC logits
