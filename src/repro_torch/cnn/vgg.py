"""VGG-16 layer generator (Simonyan & Zisserman).

13 conv layers (all 3x3 stride-1 'same', maxpool /2 between stages); the
three FC layers are reported separately for weight-count validation.  The
canonical 138.3M-parameter workload — the weight-heaviest net in the zoo,
which is exactly what makes it a useful multinet co-tenant (its weight
traffic punishes time-multiplexed deployments).
"""
from __future__ import annotations

from ..core.workload import Network, make_network

_STAGES = ((64, 2), (128, 2), (256, 3), (512, 3), (512, 3))


def vgg16() -> tuple[Network, int]:
    specs = []
    h = w = 224
    in_ch = 3
    for out_ch, n_convs in _STAGES:
        for _ in range(n_convs):
            specs.append(
                dict(
                    name=f"conv{len(specs) + 1}",
                    kind="conv",
                    in_ch=in_ch,
                    out_ch=out_ch,
                    kh=3,
                    kw=3,
                    stride=1,
                    ih=h,
                    iw=w,
                )
            )
            in_ch = out_ch
        h, w = h // 2, w // 2          # maxpool /2 after each stage
    net = make_network("vgg16", specs)
    fc_params = 512 * 7 * 7 * 4096 + 4096 * 4096 + 4096 * 1000
    return net, fc_params
