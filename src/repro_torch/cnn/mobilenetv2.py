"""MobileNetV2 layer generator (Sandler et al. [31]) — 52 convs, ~3.5M weights."""
from __future__ import annotations

from ..core.workload import Network, make_network

# (expansion t, out channels c, repeats n, stride s)
_CFG = [
    (1, 16, 1, 1),
    (6, 24, 2, 2),
    (6, 32, 3, 2),
    (6, 64, 4, 2),
    (6, 96, 3, 1),
    (6, 160, 3, 2),
    (6, 320, 1, 1),
]


def mobilenetv2() -> tuple[Network, int]:
    specs = []
    h = w = 224

    def conv(kind, cin, cout, k, s, residual=False):
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
                residual=residual,
            )
        )
        h = -(-h // s)
        w = -(-w // s)

    conv("conv", 3, 32, 3, 2)  # 224 -> 112
    in_ch = 32
    for t, c, n, s in _CFG:
        for b in range(n):
            stride = s if b == 0 else 1
            residual = stride == 1 and in_ch == c
            hidden = in_ch * t
            if t != 1:
                conv("pw", in_ch, hidden, 1, 1)
            conv("dw", hidden, hidden, 3, stride)
            conv("pw", hidden, c, 1, 1, residual=residual)
            in_ch = c
    conv("pw", in_ch, 1280, 1, 1)
    net = make_network("mobilenetv2", specs)
    return net, 1280 * 1000
