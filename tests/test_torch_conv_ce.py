"""The port's conv_ce (``repro_torch.kernels.conv_ce``) against the JAX
package's, on the CPU.

The plain version (the route a CPU tensor takes) is held against the JAX
package's ``conv_ref`` (an XLA convolution) at ``tests/test_kernels.py``'s
cases, rtol = atol = 1e-4: the port adds each output's terms in (c, kh,
kw) order, XLA in its own.  The launch grid is held to Eq. 1 on every
ResNet-50 layer under the CE the port's Builder gives it.  The CUDA kernel
itself runs only on the card: ``tests/test_torch_cuda.py``.
"""
from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.conv_ce.ops import grid_size as jax_grid_size
from repro.kernels.conv_ce.ops import predicted_cycles as jax_predicted_cycles
from repro.kernels.conv_ce.ref import conv_ref as jax_conv_ref
from repro_torch.api import Session, get_board, get_cnn
from repro_torch.core.blocks import layer_cycles
from repro_torch.fpga.archs import ARCH_NAMES, make_arch
from repro_torch.kernels import launches, reset_launches
from repro_torch.kernels.conv_ce import (conv_ce, conv_ce_cuda, conv_ref,
                                         grid_size, predicted_cycles)

TOL = 1e-4

#: ``tests/test_kernels.py:43-49``: C, H, W, F, K, stride, tile
CASES = [
    (3, 16, 16, 8, 3, 1, (4, 4, 4)),
    (4, 15, 15, 6, 3, 2, (4, 3, 5)),
    (1, 12, 12, 5, 1, 1, (2, 4, 4)),
    (8, 10, 10, 16, 5, 1, (16, 2, 3)),
    (2, 9, 9, 3, 3, 1, (2, 2, 2)),      # ragged everything
]


def _inputs(C, H, W, F, K, seed=0):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((C, H, W), dtype=np.float32),
            rng.standard_normal((F, C, K, K), dtype=np.float32))


@pytest.mark.parametrize("C,H,W,F,K,stride,par", CASES)
def test_plain_conv_matches_jax_ref(C, H, W, F, K, stride, par):
    x, w = _inputs(C, H, W, F, K)
    want = np.asarray(jax_conv_ref(jnp.asarray(x), jnp.asarray(w), stride))
    got = conv_ce(torch.from_numpy(x), torch.from_numpy(w), stride=stride,
                  par_f=par[0], par_oh=par[1], par_ow=par[2])
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=TOL, atol=TOL)
    np.testing.assert_array_equal(
        got.numpy(), conv_ref(torch.from_numpy(x), torch.from_numpy(w),
                              stride).numpy())


def test_plain_conv_bf16_matches_jax_ref():
    """bf16 inputs accumulate in f32 and return bf16 in both packages;
    the two summation orders may round to neighbouring bf16 values, one
    bf16 ulp (2**-8 relative) apart."""
    x, w = _inputs(6, 13, 13, 10, 3, seed=3)
    xb = torch.from_numpy(x).to(torch.bfloat16)
    wb = torch.from_numpy(w).to(torch.bfloat16)
    want = np.asarray(jax_conv_ref(jnp.asarray(xb.float().numpy(),
                                               jnp.bfloat16),
                                   jnp.asarray(wb.float().numpy(),
                                               jnp.bfloat16), 2),
                      np.float32)
    got = conv_ce(xb, wb, stride=2, par_f=4, par_oh=3, par_ow=5)
    assert got.dtype == torch.bfloat16
    scale = np.abs(want).max()
    np.testing.assert_allclose(got.float().numpy(), want, rtol=2 ** -8,
                               atol=2 ** -8 * scale)


def test_grid_is_eq1_on_resnet50_builder_ces():
    """Every ResNet-50 layer on the CE the port's Builder gives it in each
    baseline arch with 11 CEs on ZCU102: the grid times C·KH·KW is the
    Builder's own Eq. 1 cycle count, and the JAX package's predictor
    agrees."""
    net = get_cnn("resnet50")
    ses = Session(get_board("zcu102"), device="cpu")
    runs = 0
    for arch in ARCH_NAMES:
        acc = ses.build(make_arch(arch, net, 11), net)
        for seg in acc.segments:
            for k, li in enumerate(range(seg.spec.layer_lo,
                                         seg.spec.layer_hi + 1)):
                l, ce = net[li], seg.ces[k % len(seg.ces)]
                par = (ce.par_of("f"), ce.par_of("oh"), ce.par_of("ow"))
                c = l.dims()["c"]
                assert grid_size(l.out_ch, l.oh, l.ow, *par) * c \
                    * l.kh * l.kw == layer_cycles(l, ce)
                args = (l.out_ch, c, l.kh, l.kw, l.oh, l.ow, *par)
                assert predicted_cycles(*args) == layer_cycles(l, ce) \
                    == jax_predicted_cycles(*args)
                assert grid_size(l.out_ch, l.oh, l.ow, *par) == \
                    jax_grid_size(l.out_ch, l.oh, l.ow, *par)
                runs += 1
    assert runs == 3 * len(net)


def test_routes():
    """A CPU tensor takes the plain version and launches nothing; a tensor
    on any other device that is not CUDA raises; the kernel wrapper checks
    its inputs before any build or launch."""
    x, w = (torch.from_numpy(a) for a in _inputs(2, 9, 9, 3, 3))
    reset_launches()
    conv_ce(x, w, stride=1, par_f=2, par_oh=2, par_ow=2)
    assert not any(launches().values())
    with pytest.raises(ValueError, match="no conv_ce route"):
        conv_ce(x.to("meta"), w.to("meta"))
    with pytest.raises(ValueError, match="one CUDA device"):
        conv_ce_cuda(x, w)
    with pytest.raises(ValueError, match="stride and tile"):
        conv_ce(x, w, par_f=0)
    assert not any(launches().values())
