"""ResNet-50 / 101 / 152 layer generators (He et al. [15]).

Conv layers only (53 / 104 / 155 convs; 50/152 match paper Table III,
ResNet-101 extends the zoo Table-III-style); the final FC is reported
separately for weight-count validation.
"""
from __future__ import annotations

from ..core.workload import Network, make_network

_BLOCKS = {"resnet50": (3, 4, 6, 3), "resnet101": (3, 4, 23, 3),
           "resnet152": (3, 8, 36, 3)}


def _resnet(name: str, blocks: tuple[int, ...]) -> tuple[Network, int]:
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

    conv("conv", 3, 64, 7, 2)      # conv1, 224 -> 112
    h, w = h // 2, w // 2          # maxpool /2 -> 56
    in_ch = 64
    widths = (64, 128, 256, 512)
    for stage, (n_blocks, mid) in enumerate(zip(blocks, widths)):
        out_ch = mid * 4
        for b in range(n_blocks):
            stride = 2 if (stage > 0 and b == 0) else 1
            ih, iw = h, w
            conv("pw", in_ch, mid, 1, 1)
            conv("conv", mid, mid, 3, stride)
            conv("pw", mid, out_ch, 1, 1, residual=True)
            if b == 0:
                # projection shortcut, same input FM as the block entry
                specs.append(
                    dict(
                        name=f"conv{len(specs) + 1}_sc",
                        kind="pw",
                        in_ch=in_ch,
                        out_ch=out_ch,
                        kh=1,
                        kw=1,
                        stride=stride,
                        ih=ih,
                        iw=iw,
                        residual=False,
                    )
                )
            in_ch = out_ch
    net = make_network(name, specs)
    fc_params = 512 * 4 * 1000
    return net, fc_params


def resnet50() -> tuple[Network, int]:
    return _resnet("resnet50", _BLOCKS["resnet50"])


def resnet101() -> tuple[Network, int]:
    return _resnet("resnet101", _BLOCKS["resnet101"])


def resnet152() -> tuple[Network, int]:
    return _resnet("resnet152", _BLOCKS["resnet152"])
