"""DenseNet-121 layer generator (Huang et al. [16]) — 120 convs, ~8.1M weights."""
from __future__ import annotations

from ..core.workload import Network, make_network

_BLOCKS = (6, 12, 24, 16)
_GROWTH = 32
_BOTTLENECK = 4  # 1x1 produces 4*growth channels


def densenet121() -> tuple[Network, int]:
    specs = []
    h = w = 224

    def conv(kind, cin, cout, k, s):
        nonlocal h, w
        specs.append(
            dict(
                name=f"conv{len(specs) + 1}",
                kind=kind,
                in_ch=cin,
                out_ch=cout,
                kh=k,
                kw=k,
                stride=s,
                ih=h,
                iw=w,
            )
        )
        h = -(-h // s)
        w = -(-w // s)

    conv("conv", 3, 64, 7, 2)  # 224 -> 112
    h, w = h // 2, w // 2      # maxpool -> 56
    ch = 64
    for bi, n_layers in enumerate(_BLOCKS):
        for _ in range(n_layers):
            conv("pw", ch, _BOTTLENECK * _GROWTH, 1, 1)
            conv("conv", _BOTTLENECK * _GROWTH, _GROWTH, 3, 1)
            ch += _GROWTH  # dense concatenation grows the input of the next layer
        if bi < len(_BLOCKS) - 1:
            conv("pw", ch, ch // 2, 1, 1)  # transition compression
            ch //= 2
            h, w = h // 2, w // 2          # avgpool /2
    net = make_network("densenet121", specs)
    return net, ch * 1000
