"""Xception layer generator (Chollet [10]) — 74 convs, ~22.9M weights.

Separable convs are modelled as depthwise + pointwise layer pairs (how the
paper counts them: 74 conv layers).
"""
from __future__ import annotations

from ..core.workload import Network, make_network


def xception() -> tuple[Network, int]:
    specs = []
    h = w = 299

    def conv(kind, cin, cout, k, s, residual=False, at=None):
        nonlocal h, w
        ih, iw = at if at else (h, w)
        specs.append(
            dict(
                name=f"conv{len(specs) + 1}",
                kind=kind,
                in_ch=cin,
                out_ch=cout,
                kh=k,
                kw=k,
                stride=s,
                ih=ih,
                iw=iw,
                residual=residual,
            )
        )
        if at is None:
            h = -(-h // s)
            w = -(-w // s)

    def sep(cin, cout, residual=False):
        conv("dw", cin, cin, 3, 1)
        conv("pw", cin, cout, 1, 1, residual=residual)

    # Entry flow
    conv("conv", 3, 32, 3, 2)    # 299 -> 150
    conv("conv", 32, 64, 3, 1)
    for cin, cout in ((64, 128), (128, 256), (256, 728)):
        ih, iw = h, w
        sep(cin, cout)
        sep(cout, cout, residual=True)
        conv("pw", cin, cout, 1, 2, at=(ih, iw))  # strided shortcut
        h, w = -(-h // 2), -(-w // 2)             # maxpool /2

    # Middle flow: 8 blocks of 3 separable convs @ 19x19
    for _ in range(8):
        sep(728, 728)
        sep(728, 728)
        sep(728, 728, residual=True)

    # Exit flow
    ih, iw = h, w
    sep(728, 728)
    sep(728, 1024, residual=True)
    conv("pw", 728, 1024, 1, 2, at=(ih, iw))  # strided shortcut
    h, w = -(-h // 2), -(-w // 2)             # maxpool /2
    sep(1024, 1536)
    sep(1536, 2048)

    net = make_network("xception", specs)
    return net, 2048 * 1000
