"""The port's CNN registry: every network against its Table III row, the
zoo's layers equal to the JAX package's field for field, and DenseNet-264
as the JAX package's own DenseNet generator builds it with its blocks."""
from __future__ import annotations

import dataclasses
from collections import Counter

import pytest

import repro.cnn.densenet as jax_densenet
from repro.cnn.registry import get_cnn as jax_get_cnn
from repro_torch.cnn.registry import (CNN_NAMES, DEEP_CNN_NAMES, TABLE_III,
                                      get_cnn, total_params)
from repro_torch.core.batch_eval import bucket_max_L

DENSENET264_BLOCKS = (6, 12, 64, 48)


def _fields(net) -> list[dict]:
    return [dataclasses.asdict(l) for l in net]


@pytest.mark.parametrize("name", CNN_NAMES + DEEP_CNN_NAMES)
def test_counts_match_table3(name):
    _, weights_m, conv_layers = TABLE_III[name]
    assert len(get_cnn(name)) == conv_layers
    assert total_params(name) / 1e6 == pytest.approx(weights_m, rel=0.06)


@pytest.mark.parametrize("name", CNN_NAMES)
def test_zoo_equals_jax_field_for_field(name):
    """DenseNet-121 above all: its factory now takes the block counts,
    and the golden files hold its layers."""
    assert _fields(get_cnn(name)) == _fields(jax_get_cnn(name))
    assert get_cnn(name).name == name


def test_densenet264_is_the_jax_generator_at_its_blocks(monkeypatch):
    """The JAX package's DenseNet generator run at DenseNet-264's blocks
    gives the port's layers field for field."""
    monkeypatch.setattr(jax_densenet, "_BLOCKS", DENSENET264_BLOCKS)
    jnet, jfc = jax_densenet.densenet121()
    net = get_cnn("densenet264")
    assert _fields(net) == _fields(jnet)
    assert total_params("densenet264") == jnet.total_weights + jfc


def test_densenet264_shape():
    """Huang et al., Table 1 (k = 32): the stem, a 1x1 and a 3x3 a dense
    layer and three transitions; widths grow to 2,688 channels; the batch
    path pads the 264 rows to 288."""
    net = get_cnn("densenet264")
    assert net.name == "densenet264"
    assert len(net) == 1 + 2 * sum(DENSENET264_BLOCKS) + 3 == 264
    assert total_params("densenet264") == 32_938_176
    # the classifier reads the last block's 2,688 channels
    assert total_params("densenet264") - net.total_weights == 2688 * 1000
    assert max(l.in_ch for l in net) == 2688 - 32
    # each block and its transition at 56, 28, 14 and 7 rows
    assert Counter(l.ih for l in net) == {224: 1, 56: 13, 28: 25, 14: 129,
                                          7: 96}
    # the transitions, each halving the concatenation's channels
    assert [(net.layers[i].in_ch, net.layers[i].out_ch)
            for i in (13, 38, 167)] == [(256, 128), (512, 256), (2304, 1152)]
    assert not any(l.residual for l in net)
    assert bucket_max_L(len(net)) == 288


def test_unknown_network_lists_every_registered_one():
    with pytest.raises(KeyError, match="densenet264"):
        get_cnn("densenet999")
