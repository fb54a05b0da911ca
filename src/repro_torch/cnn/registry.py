"""CNN zoo registry — the paper's five workloads (Table III) plus the
ResNet-101 / VGG-16 extensions, and DenseNet-264 past the zoo's 160-row
layer axis, validated Table-III-style (total weights and conv layer
counts)."""
from __future__ import annotations

from functools import lru_cache

from ..core.workload import Network
from .densenet import densenet121, densenet264
from .mobilenetv2 import mobilenetv2
from .resnet import resnet50, resnet101, resnet152
from .vgg import vgg16
from .xception import xception

_ZOO = {
    "resnet152": resnet152,
    "resnet101": resnet101,
    "resnet50": resnet50,
    "vgg16": vgg16,
    "xception": xception,
    "densenet121": densenet121,
    "mobilenetv2": mobilenetv2,
}
#: networks beyond the zoo: DenseNet-264 (Huang et al., CVPR 2017, Table 1)
#: is the deepest ImageNet network of its family, 264 conv layers, which
#: the batch path pads to 288 rows
_DEEP = {
    "densenet264": densenet264,
}
_FACTORIES = {**_ZOO, **_DEEP}

# Paper Table III, extended in the same format:
# (abbrev, total weights in millions, conv layer count).
# resnet101 / vgg16 are not in the paper's table; their reference counts
# are the canonical torchvision parameter totals; densenet264's is its
# factory's own conv and classifier weights.
TABLE_III = {
    "resnet152": ("Res152", 60.4, 155),
    "resnet101": ("Res101", 44.5, 104),
    "resnet50": ("Res50", 25.6, 53),
    "vgg16": ("VGG16", 138.3, 13),
    "xception": ("XCp", 22.9, 74),
    "densenet121": ("Dns121", 8.1, 120),
    "mobilenetv2": ("MobV2", 3.5, 52),
    "densenet264": ("Dns264", 32.9, 264),
}

#: the zoo the JAX package holds, which the golden files cover
CNN_NAMES = tuple(_ZOO)
#: the networks past the zoo, which ``get_cnn`` builds as well
DEEP_CNN_NAMES = tuple(_DEEP)


@lru_cache(maxsize=None)
def get_cnn(name: str) -> Network:
    """Conv-layer network for MCCM evaluation."""
    if name not in _FACTORIES:
        raise KeyError(f"unknown CNN {name!r}; known: {sorted(_FACTORIES)}")
    return _FACTORIES[name]()[0]


@lru_cache(maxsize=None)
def total_params(name: str) -> int:
    """Conv weights + classifier weights (for Table III validation)."""
    net, fc = _FACTORIES[name]()
    return net.total_weights + fc
