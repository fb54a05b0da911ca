"""DenseNet-BC layer generators (Huang et al. [16]): DenseNet-121 (120
convs, ~8.1M weights) and DenseNet-264 (264 convs, ~32.9M weights), the
deepest ImageNet network of the paper's Table 1."""
from __future__ import annotations

from ..core.workload import Network, make_network

_GROWTH = 32
_BOTTLENECK = 4  # 1x1 produces 4*growth channels


def densenet(name: str, blocks: tuple[int, ...]) -> tuple[Network, int]:
    """A DenseNet-BC with growth 32, a 4 x 32 bottleneck and compression
    0.5 at 224 x 224, ``blocks`` dense layers a block, and its classifier's
    weights (1000 classes).  The stem's max-pool and each transition's
    average-pool are spatial halvings; a dense layer's input is the
    block's concatenation so far (the growing ``in_ch``, no residual
    copy); the classifier is not a conv layer."""
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
    for bi, n_layers in enumerate(blocks):
        for _ in range(n_layers):
            conv("pw", ch, _BOTTLENECK * _GROWTH, 1, 1)
            conv("conv", _BOTTLENECK * _GROWTH, _GROWTH, 3, 1)
            ch += _GROWTH  # dense concatenation grows the input of the next layer
        if bi < len(blocks) - 1:
            conv("pw", ch, ch // 2, 1, 1)  # transition compression
            ch //= 2
            h, w = h // 2, w // 2          # avgpool /2
    return make_network(name, specs), ch * 1000


def densenet121() -> tuple[Network, int]:
    return densenet("densenet121", (6, 12, 24, 16))


def densenet264() -> tuple[Network, int]:
    return densenet("densenet264", (6, 12, 64, 48))
