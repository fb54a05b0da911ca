"""The port's conv_ce (``repro_torch.kernels.conv_ce``) against the JAX
package's, on the CPU.

The plain version (the route a CPU tensor takes) is held against the JAX
package's ``conv_ref`` (an XLA convolution) at ``tests/test_kernels.py``'s
cases, rtol = atol = 1e-4: the port adds each output's terms in (c, kh,
kw) order, XLA in its own.  The launch grid is held to Eq. 1 on every
ResNet-50 layer under the CE the port's Builder gives it.  The CUDA kernel
itself runs only on the card: ``tests/test_torch_cuda.py``; its launch
plan is held here, on every layer of ResNet-50, VGG-16 and MobileNetV2
(but its depthwise layers) under the CE the Builder gives it.
"""
from __future__ import annotations

import functools

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
from repro_torch.kernels.conv_ce import ops as conv_ops

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


def _stored(plan, nf, nh, nw):
    """The tile-local outputs a block stores under ``plan``, with nf x nh x
    nw of its tile inside the layer: thread t is (gf, gh, gw) = (t // (tw
    * th), t // tw % th, t % tw) and owns (gf*rf + i, gh + j*th, gw +
    k*tw), stored where inside that part (``csrc/conv_ce.cu``)."""
    t = np.arange(plan.tf * plan.th * plan.tw)
    gf, gh, gw = t // (plan.tw * plan.th), t // plan.tw % plan.th, \
        t % plan.tw
    i, j, k = np.meshgrid(np.arange(plan.rf), np.arange(plan.rh),
                          np.arange(plan.rw), indexing="ij")
    f = (gf * plan.rf)[:, None] + i.ravel()
    h = gh[:, None] + j.ravel() * plan.th
    w = gw[:, None] + k.ravel() * plan.tw
    keep = (f < nf) & (h < nh) & (w < nw)
    return np.stack([f[keep], h[keep], w[keep]], 1)


@functools.lru_cache(maxsize=None)
def _builder_layers(cnn, board):
    """(layer, its CE) of every non-depthwise layer of ``cnn`` in the
    Builder's design of each baseline arch with 2, 5, 9 and 11 CEs."""
    net = get_cnn(cnn)
    ses = Session(get_board(board), device="cpu")
    out = []
    for arch in ARCH_NAMES:
        for n in (2, 5, 9, 11):
            acc = ses.build(make_arch(arch, net, n), net)
            for seg in acc.segments:
                for k, li in enumerate(range(seg.spec.layer_lo,
                                             seg.spec.layer_hi + 1)):
                    if net[li].kind != "dw":
                        out.append((net[li], seg.ces[k % len(seg.ces)]))
    return out


@pytest.mark.parametrize("cnn", ["resnet50", "mobilenetv2", "vgg16"])
@pytest.mark.parametrize("board", ["zcu102", "zc706"])
def test_launch_plan_on_builder_tiles(cnn, board):
    """Every plan the kernel would get from the Builder's CEs: whole warps,
    at most 1024 threads, at most 227 KB of shared memory, pitches the
    kernel accepts, each output of the tile stored exactly once (an
    interior and the ragged last block), and the grid Eq. 1's."""
    seen = set()
    for l, ce in _builder_layers(cnn, board):
        par = (ce.par_of("f"), ce.par_of("oh"), ce.par_of("ow"))
        H = l.ih + max((l.oh - 1) * l.stride + l.kh - l.ih, 0)
        W = l.iw + max((l.ow - 1) * l.stride + l.kw - l.iw, 0)
        key = (l.in_ch, H, W, l.out_ch, l.kh, l.kw, l.stride, *par)
        p = conv_ops.launch_plan(*key)
        assert p.grid == (-(-l.out_ch // par[0]), -(-l.oh // par[1]),
                          -(-l.ow // par[2]))
        assert np.prod(p.grid) * l.in_ch * l.kh * l.kw \
            == layer_cycles(l, ce) == predicted_cycles(
                l.out_ch, l.in_ch, l.kh, l.kw, l.oh, l.ow, *par)
        if key in seen:
            continue
        seen.add(key)
        assert (p.rf, p.rh, p.rw) in conv_ops.REGISTER_TILES
        assert p.threads % 32 == 0 and p.threads <= 1024
        assert p.threads <= conv_ops.max_threads((p.rf, p.rh, p.rw))
        assert p.tf * p.th * p.tw <= p.threads
        assert p.smem_bytes <= 227 * 1024
        assert 1 <= p.cc <= l.in_ch
        assert p.row_pitch >= l.stride * p.wq >= p.ww
        assert p.f_pitch >= p.tf * p.rf and p.f_pitch % 4 == 0
        assert p.w_copy == (conv_ops.COPY_16 if l.out_ch % 4 == 0 and (
            par[0] % 4 == 0 or p.grid[0] == 1) else conv_ops.COPY_ELEMENT)
        assert conv_ops.launch_plan(*key, bf16=True).w_copy \
            == conv_ops.COPY_ELEMENT
        last = [min(t, d - (g - 1) * t) for t, d, g in
                zip(par, (l.out_ch, l.oh, l.ow), p.grid)]
        for part in ([min(t, d) for t, d in zip(par, (l.out_ch, l.oh,
                                                       l.ow))], last):
            got = _stored(p, *part)
            want = np.stack(np.meshgrid(*map(np.arange, part),
                                        indexing="ij"), -1).reshape(-1, 3)
            assert len(got) == len(want)
            np.testing.assert_array_equal(np.unique(got, axis=0), want)
    assert seen


def test_every_register_tile_is_chosen():
    """Each register tile the kernel is built for is the plan's choice for
    some layer of test_launch_plan_on_builder_tiles, in f32 or bf16: the
    source instantiates no tile that those plans never launch."""
    chosen = set()
    for cnn in ("resnet50", "mobilenetv2", "vgg16"):
        for board in ("zcu102", "zc706"):
            for l, ce in _builder_layers(cnn, board):
                par = (ce.par_of("f"), ce.par_of("oh"), ce.par_of("ow"))
                H = l.ih + max((l.oh - 1) * l.stride + l.kh - l.ih, 0)
                W = l.iw + max((l.ow - 1) * l.stride + l.kw - l.iw, 0)
                for bf16 in (False, True):
                    p = conv_ops.launch_plan(l.in_ch, H, W, l.out_ch, l.kh,
                                             l.kw, l.stride, *par, bf16)
                    chosen.add((p.rf, p.rh, p.rw))
    assert chosen == set(conv_ops.REGISTER_TILES)


def test_launch_plan_refuses_what_no_block_holds():
    """A tile larger than any register tile's block holds, or a window
    and weight block whose two stages of one channel pass 227 KB, has no
    plan; a grid past CUDA's limit neither."""
    with pytest.raises(ValueError, match="no block"):
        conv_ops.launch_plan(1, 1, 40000, 1, 1, 1, 1, 1, 1, 40000)
    with pytest.raises(ValueError, match="shared memory"):
        conv_ops.launch_plan(1, 25, 25, 2520, 25, 25, 1, 2520, 1, 1)
    with pytest.raises(ValueError, match="65535"):
        conv_ops.launch_plan(1, 70000, 1, 1, 1, 1, 1, 1, 1, 1)


def test_register_tiles_match_the_kernel_source():
    """``ops.REGISTER_TILES`` lists the instantiations of the kernel's
    ``CONV_CE_TILES``, in order."""
    import re
    src = conv_ops.SOURCE.read_text()
    body = src.split("#define CONV_CE_TILES(X)")[1].split("\n\n")[0]
    tiles = tuple(tuple(map(int, m)) for m in
                  re.findall(r"X\((\d+), (\d+), (\d+)\)", body))
    assert tiles == conv_ops.REGISTER_TILES
