"""Port of the JAX package's ``tpu/cost_model.py``: the paper's
analytical cost model on one H100.

Maps the FPGA equations onto an (arch × shape × plan) cell on the card:

  Eq. 1  PE-underutilisation ceil-divs  -> tensor-core tile padding
                                           (``ChipSpec.mma_pad``, 64-wide)
  Eq. 4/5 on-chip buffer requirements   -> the card's HBM footprint
  Eq. 6/7 off-chip accesses             -> HBM traffic per step
  Eq. 8/9 inter-segment interfaces      -> NVLink collective wire bytes

Outputs the three roofline terms, in seconds, that a walk of the step
(``op_walk``) counts, plus a fits-in-HBM verdict -- analytically, in
microseconds per plan, which is what makes plan DSE (``autoplan``)
practical.  The arithmetic is the JAX function's, in its order, so that
on a chip with the TPU's figures the two give equal floats.
:meth:`PlanView.of` resolves a plan's axes to widths on a mesh (a
``DeviceMesh``, or anything whose ``.shape`` maps axis to width), or
without one to a single device; :func:`estimate_view` takes a
:class:`PlanView` as it is.

All quantities are PER DEVICE unless suffixed ``_global``.
"""
from __future__ import annotations

import math
from dataclasses import dataclass, field

from ..configs.base import ModelConfig, ShapeSpec
from ..launch.plans import mesh_shape
from .chip import H100, ChipSpec

BF16 = 2
F32 = 4


@dataclass
class PlanView:
    """The axis widths a plan resolves to: on a mesh, the JAX package's
    ``PlanView.of(plan, mesh)``; without one, one device."""

    n_dev: int
    dp: int                    # product of data axes (incl. pod)
    tp: int
    fsdp: int                  # 1 if no param sharding
    ep: int
    remat: bool = True
    remat_group: int = 1
    act_shard_seq: bool = False
    moe_impl: str = "ep_a2a"
    loss_chunk: int = 512
    opt_factored: bool = False
    opt_momentum: bool = True
    opt_bytes: int = F32

    @classmethod
    def of(cls, plan, mesh=None) -> "PlanView":
        """The widths ``plan`` resolves to on ``mesh``; without one, one
        device, where every axis has width 1 and the MoE dispatch is
        ``local`` (at width 1 the JAX package's ``ep_a2a`` takes the same
        arithmetic)."""
        opt = dict(opt_factored=plan.opt_factored,
                   opt_momentum=plan.opt_momentum,
                   opt_bytes=(2 if plan.opt_state_dtype == "bfloat16"
                              else F32))
        if mesh is None:
            return cls(n_dev=1, dp=1, tp=1, fsdp=1, ep=1,
                       remat=plan.remat, remat_group=plan.remat_group,
                       act_shard_seq=False, moe_impl="local",
                       loss_chunk=plan.loss_chunk, **opt)
        shape = mesh_shape(mesh)
        dp = 1
        for a in plan.dp_axes:
            dp *= shape.get(a, 1)
        tp = shape.get(plan.tp_axis, 1) if plan.tp_axis else 1
        fsdp = 1
        for a in (plan.fsdp_axes or ()):
            fsdp *= shape.get(a, 1)
        ep = shape.get(plan.ep_axis, 1) if plan.ep_axis else 1
        n = 1
        for v in shape.values():
            n *= v
        return cls(n_dev=n, dp=dp, tp=tp, fsdp=max(fsdp, 1), ep=ep,
                   remat=plan.remat, remat_group=plan.remat_group,
                   act_shard_seq=(plan.act_shard == "seq"),
                   moe_impl=plan.moe_impl, loss_chunk=plan.loss_chunk,
                   **opt)


@dataclass
class CostEstimate:
    flops: float               # per device, per step (tile-padded)
    useful_flops: float = 0.0  # unpadded (held against a walk)
    hbm_bytes: float = 0.0
    wire_bytes: float = 0.0
    hbm_capacity_bytes: float = 0.0  # resident footprint (params+opt+cache…)
    compute_s: float = 0.0
    memory_s: float = 0.0
    collective_s: float = 0.0
    fits: bool = True
    mxu_utilization: float = 1.0   # useful/padded flops (Eq. 1 analog)
    parts: dict = field(default_factory=dict)

    def dominant(self) -> str:
        terms = {"compute": self.compute_s, "memory": self.memory_s,
                 "collective": self.collective_s}
        return max(terms, key=terms.get)


def _pad(d: float, chip: ChipSpec) -> float:
    """Tensor-core tile inflation factor for one matmul dim (Eq. 1
    analog)."""
    return chip.mma_pad(int(math.ceil(d))) / max(d, 1.0)


def _matmul(tokens: float, d_in: int, d_out: int, chip: ChipSpec,
            bwd_mult: float = 1.0):
    """(useful_flops, padded_flops) of tokens × (d_in -> d_out)."""
    useful = 2.0 * tokens * d_in * d_out * bwd_mult
    padded = useful * _pad(d_in, chip) * _pad(d_out, chip)
    return useful, padded


def _attn_ctx(S: int, kind: str, window: int | None) -> float:
    """Attended context length per query token — *implementation-faithful*:
    the blocked flash path computes every (q_blk, kv_blk) pair, masked or
    not, so causal/SWA do NOT reduce FLOPs (kept as the JAX package's
    term, so the two models stay equal)."""
    return float(S)


class _Acc:
    """Accumulator for the three terms + capacity."""

    def __init__(self, chip: ChipSpec):
        self.chip = chip
        self.useful = 0.0
        self.padded = 0.0
        self.hbm = 0.0
        self.wire = 0.0
        self.cap = 0.0
        self.parts: dict[str, float] = {}

    def flops(self, useful: float, padded: float | None = None, tag=""):
        self.useful += useful
        self.padded += padded if padded is not None else useful
        if tag:
            self.parts[f"flops/{tag}"] = self.parts.get(f"flops/{tag}", 0.0) \
                + (padded if padded is not None else useful)

    def mem(self, b: float, tag=""):
        self.hbm += b
        if tag:
            self.parts[f"hbm/{tag}"] = self.parts.get(f"hbm/{tag}", 0.0) + b

    def coll(self, b: float, tag=""):
        self.wire += b
        if tag:
            self.parts[f"wire/{tag}"] = self.parts.get(f"wire/{tag}", 0.0) + b

    def capacity(self, b: float, tag=""):
        self.cap += b
        if tag:
            self.parts[f"cap/{tag}"] = self.parts.get(f"cap/{tag}", 0.0) + b


def _ar_wire(size: float, n: int) -> float:
    """ring all-reduce wire bytes per device."""
    return 2.0 * size * (n - 1) / n if n > 1 else 0.0


def _ag_wire(size_out: float, n: int) -> float:
    return size_out * (n - 1) / n if n > 1 else 0.0


def estimate(cfg: ModelConfig, shape: ShapeSpec, plan,
             chip: ChipSpec = H100, *, mesh=None) -> CostEstimate:
    """Analytical per-device cost of one step of this cell under one of the
    port's plans, on ``mesh`` (one card without one)."""
    return estimate_view(cfg, shape, PlanView.of(plan, mesh), chip)


def estimate_view(cfg: ModelConfig, shape: ShapeSpec, pv: PlanView,
                  chip: ChipSpec = H100) -> CostEstimate:
    """Analytical per-device cost of one step of this cell at the widths
    ``pv`` gives."""
    kind = shape.kind
    B, S = shape.global_batch, shape.seq_len
    d, V = cfg.d_model, cfg.padded_vocab
    hd = cfg.head_dim
    nq, nkv = max(cfg.n_heads, 1), max(cfg.n_kv_heads, 1)
    a = _Acc(chip)

    # backward multiplier: fwd=1; train adds bwd(2) + remat recompute(~1)
    if kind == "train":
        bwd = 3.0 + (1.0 if pv.remat else 0.0)
        if pv.remat and pv.remat_group > 1:
            bwd += (pv.remat_group - 1) / pv.remat_group  # interior recompute
    else:
        bwd = 1.0

    # tokens entering the dense stack, per device
    if kind == "decode":
        tok_global = float(B)              # one new token each
        ctx = _attn_ctx(S, "decode", cfg.sliding_window)
    else:
        tok_global = float(B) * S
        ctx = _attn_ctx(S, kind, cfg.sliding_window)
    tok = tok_global / pv.dp               # activations sharded over dp only

    # ---- per-layer compute, per device ------------------------------------
    # TP shards the head/ff dimension; each device computes 1/tp of it.
    def attn_layer(n_layers: int, seq_ctx: float, heads_q=None):
        hq = heads_q or nq
        u, p = _matmul(tok, d, (hq + 2 * nkv) * hd / pv.tp, chip, bwd)
        a.flops(u * n_layers, p * n_layers, "qkv")
        # scores + pv: per device hq/tp heads
        sc = 2.0 * tok * seq_ctx * (hq / pv.tp) * hd * 2 * bwd
        a.flops(sc * n_layers, sc * _pad(hd, chip) * n_layers, "attn")
        u, p = _matmul(tok, hq * hd / pv.tp, d, chip, bwd)
        a.flops(u * n_layers, p * n_layers, "attn_out")
        # flash working set: q,k,v,o read/write per layer
        qkvo = tok * (2 * hq + 2 * nkv) * hd * BF16 / pv.tp * 2
        a.mem(qkvo * (2 if kind == "train" else 1) * n_layers, "attn_io")
        if kind == "decode":
            # read the KV cache once per step (the decode bottleneck)
            kv_read = (2.0 * (B / pv.dp) * ctx * nkv * hd * BF16
                       / (pv.tp if (nkv % pv.tp == 0) else
                          (pv.tp if hd % pv.tp == 0 else 1)))
            a.mem(kv_read * n_layers, "kv_read")
        # TP collective: fwd+bwd all-reduce of the residual activation
        if pv.tp > 1:
            # fwd (bf16) + remat recompute (bf16) + bwd cotangent (f32 — the
            # einsums set preferred_element_type=f32)
            size = tok * d * BF16
            mult = (1 + (1 if pv.remat else 0) + 2) if kind == "train" else 1
            a.coll(_ar_wire(size, pv.tp) * mult * n_layers, "tp_ar_attn")

    def mlp_layer(n_layers: int, f: int, n_mats: int = 3):
        u, p = _matmul(tok, d, f / pv.tp, chip, bwd)
        a.flops(u * (n_mats - 1) * n_layers, p * (n_mats - 1) * n_layers,
                "mlp_in")
        u, p = _matmul(tok, f / pv.tp, d, chip, bwd)
        a.flops(u * n_layers, p * n_layers, "mlp_out")
        a.mem(tok * f / pv.tp * BF16 * 2 * (2 if kind == "train" else 1)
              * n_layers, "mlp_io")
        if pv.tp > 1:
            size = tok * d * BF16
            mult = (1 + (1 if pv.remat else 0) + 2) if kind == "train" else 1
            a.coll(_ar_wire(size, pv.tp) * mult * n_layers, "tp_ar_mlp")

    def moe_layer(n_layers: int):
        k, f = cfg.experts_per_token, cfg.moe_d_ff
        E = cfg.n_experts
        # implementation-faithful: both dispatch variants compute E_local
        # capacity-padded buckets — cap = ceil8(k·n_local·cf/E), floor 8
        # (moe.py _capacity), so small decode batches pay the bucket floor.
        a2a = (pv.moe_impl == "ep_a2a"
               and (S if kind != "decode" else 1) % pv.ep == 0)
        n_local = tok / pv.ep if a2a else tok
        cap = max(8.0, math.ceil(k * n_local * cfg.capacity_factor / E
                                 / 8.0) * 8.0)
        e_local = -(-E // pv.ep)
        tok_e = e_local * cap * (pv.ep if a2a else 1)  # a2a: each expert
        # sees ep source shards' buckets
        if not a2a:
            tok_e = e_local * cap
        u, p = _matmul(tok_e, d, f, chip, bwd)
        a.flops(u * 2 * n_layers, p * 2 * n_layers, "moe_in")
        u, p = _matmul(tok_e, f, d, chip, bwd)
        a.flops(u * n_layers, p * n_layers, "moe_out")
        # router
        u, p = _matmul(tok, d, cfg.n_experts, chip, bwd)
        a.flops(u * n_layers, p * n_layers, "router")
        if cfg.n_shared_experts:
            fs = f * cfg.n_shared_experts
            u, p = _matmul(tok, d, fs / pv.tp, chip, bwd)
            a.flops(u * 2 * n_layers, p * 2 * n_layers, "moe_shared")
            u, p = _matmul(tok, fs / pv.tp, d, chip, bwd)
            a.flops(u * n_layers, p * n_layers, "moe_shared")
        # dispatch/combine gathers + buffers
        a.mem(tok_e * d * BF16 * 4 * (2 if kind == "train" else 1)
              * n_layers, "moe_io")
        if pv.ep > 1:
            if a2a:
                # one a2a moves the full (E, cap, d) dispatch buffer;
                # 2 per pass (dispatch + combine); bwd of an a2a is an a2a
                sz = e_local * pv.ep * cap * d * BF16
                a.coll(2 * sz * (pv.ep - 1) / pv.ep
                       * (4 if kind == "train" else 1) * n_layers, "moe_a2a")
            else:
                size = tok * d * BF16
                a.coll(_ar_wire(size, pv.ep)
                       * (4 if kind == "train" else 1) * n_layers, "moe_psum")

    def mamba_layer(n_layers: int):
        di, g, n_ssm = cfg.d_inner, cfg.n_ssm_groups, cfg.ssm_state
        h = cfg.n_ssm_heads
        proj_out = 2 * di + 2 * g * n_ssm + h
        u, p = _matmul(tok, d, proj_out / pv.tp, chip, bwd)
        a.flops(u * n_layers, p * n_layers, "ssm_proj")
        # conv1d
        conv = 2.0 * tok * (di + 2 * g * n_ssm) * cfg.ssm_conv * bwd / pv.tp
        a.flops(conv * n_layers, conv * n_layers, "ssm_conv")
        # SSD (chunked): intra-chunk attention-like + state update
        c = 256 if kind != "decode" else 1
        ssd = (2.0 * tok * c * di / pv.tp            # intra-chunk qk-like
               + 2.0 * tok * c * di / pv.tp          # pv-like
               + 4.0 * tok * di * n_ssm / pv.tp) * bwd
        a.flops(ssd * n_layers, ssd * n_layers, "ssd")
        u, p = _matmul(tok, di / pv.tp, d, chip, bwd)
        a.flops(u * n_layers, p * n_layers, "ssm_out")
        a.mem(tok * di / pv.tp * BF16 * 6 * (2 if kind == "train" else 1)
              * n_layers, "ssm_io")
        if kind == "decode":
            st = ((B / pv.dp) * (h * (di // max(h, 1)) * n_ssm)
                  * F32 / pv.tp)
            a.mem(2 * st * n_layers, "ssm_state_io")
        if pv.tp > 1:
            size = tok * d * BF16
            a.coll(_ar_wire(size, pv.tp) * (2 if kind == "train" else 1)
                   * n_layers, "tp_ar_ssm")

    # ---- assemble the stack ------------------------------------------------
    fam = cfg.family
    if fam in ("dense", "moe", "vlm"):
        attn_layer(cfg.n_layers, ctx)
        if cfg.n_experts:
            moe_layer(cfg.n_layers)
        else:
            mlp_layer(cfg.n_layers, cfg.d_ff)
    elif fam == "encdec":
        S_dec = max(S // cfg.dec_ratio, 8)
        tok_enc = (B * S / pv.dp) if kind != "decode" else 0.0
        tok_dec = (B * S_dec / pv.dp) if kind != "decode" else B / pv.dp
        # encoder (skipped at decode: cached)
        tok_save = tok
        if kind != "decode":
            tok = tok_enc
            attn_layer(cfg.n_enc_layers, (S + 1) / 2 if False else S)
            mlp_layer(cfg.n_enc_layers, cfg.d_ff, n_mats=2)
        tok = tok_dec
        attn_layer(cfg.n_dec_layers,
                   _attn_ctx(S_dec, kind, None) if kind != "decode" else S_dec)
        # cross attention reads the encoder states
        u, p = _matmul(tok, d, (nq + 2 * nkv) * hd // pv.tp, chip, bwd)
        a.flops(u * cfg.n_dec_layers, p * cfg.n_dec_layers, "xattn_qkv")
        xa = 2.0 * tok * S * (nq / pv.tp) * hd * 2 * bwd
        a.flops(xa * cfg.n_dec_layers, xa * cfg.n_dec_layers, "xattn")
        mlp_layer(cfg.n_dec_layers, cfg.d_ff, n_mats=2)
        tok = tok_save
    elif fam == "ssm":
        mamba_layer(cfg.n_layers)
    elif fam == "hybrid":
        mamba_layer(cfg.n_layers)
        n_shared = cfg.n_layers // max(cfg.attn_every, 1)
        attn_layer(n_shared, ctx)
        mlp_layer(n_shared, cfg.d_ff)

    # ---- head / embedding --------------------------------------------------
    head_tok = tok if kind == "train" else (B / pv.dp)
    u, p = _matmul(head_tok, d, V / pv.tp, chip,
                   bwd if kind == "train" else 1)
    a.flops(u, p, "head")
    a.mem(head_tok * d * BF16, "embed_io")

    # ---- parameters: capacity + HBM traffic + FSDP collectives -------------
    n_params = cfg.param_count()
    p_local = n_params * BF16 / (pv.fsdp * pv.tp if pv.fsdp > 1 else pv.tp)
    if pv.fsdp == 1:
        p_local = n_params * BF16 / pv.tp  # TP-sharded, DP-replicated
    a.capacity(p_local, "params")
    # reads: fwd + bwd (+ recompute); the *gathered* stream passes HBM once
    reads = (3.0 if kind == "train" else 1.0) + \
        (1.0 if (kind == "train" and pv.remat) else 0.0)
    if kind == "decode" and cfg.n_experts:
        # only active experts are touched per token-batch (capacity-bound)
        active_frac = min(1.0, (B / pv.dp) * cfg.experts_per_token
                          / cfg.n_experts * 4)
        dense_p = cfg.param_count(active_only=True)
        expert_p = n_params - dense_p
        reads_bytes = (dense_p + active_frac * expert_p) * BF16 / pv.tp
        a.mem(reads_bytes, "param_read")
    else:
        a.mem(p_local * pv.fsdp * reads if pv.fsdp > 1 else
              n_params * BF16 / pv.tp * reads, "param_read")
    if kind == "train":
        # grads write+read, optimizer state read+write
        g_local = p_local
        a.capacity(g_local, "grads")
        a.mem(2 * g_local * (pv.fsdp if False else 1), "grad_io")
        opt_mult = (1 if pv.opt_momentum else 0) + (0.05 if pv.opt_factored
                                                    else 1)
        opt_local = n_params * pv.opt_bytes * opt_mult / (pv.fsdp * pv.tp)
        a.capacity(opt_local, "opt")
        a.mem(2 * opt_local, "opt_io")
        if pv.fsdp > 1:
            # ZeRO-3: all-gather params fwd + bwd(recompute), reduce-scatter
            ag = _ag_wire(n_params * BF16 / pv.tp, pv.fsdp)
            rs = _ag_wire(n_params * BF16 / pv.tp, pv.fsdp)
            a.coll(2 * ag + rs, "fsdp")
        elif pv.dp > 1:
            a.coll(_ar_wire(n_params * BF16 / pv.tp, pv.dp), "dp_ar")

    # ---- activations / residuals / caches ----------------------------------
    if kind == "train":
        resid_tok = tok / (pv.tp if pv.act_shard_seq else 1)
        n_resid = (cfg.n_layers / pv.remat_group if pv.remat
                   else cfg.n_layers)
        resid = resid_tok * d * BF16 * n_resid
        a.capacity(resid, "residuals")
        a.mem(2 * resid, "resid_io")
        # loss logits chunked
        chunk = pv.loss_chunk or S
        a.capacity((B / pv.dp) * chunk * V * F32 / pv.tp, "logits_chunk")
    if kind != "train":
        # KV / state cache resident
        if fam in ("dense", "moe", "vlm"):
            kv = 2.0 * (B / pv.dp) * min(S, 10**9) * nkv * hd * BF16 \
                * cfg.n_layers
            shard = pv.tp if (nkv % pv.tp == 0 or hd % pv.tp == 0) else 1
            a.capacity(kv / shard, "kv_cache")
        elif fam == "encdec":
            kv = 2.0 * (B / pv.dp) * S * nkv * hd * BF16 * cfg.n_dec_layers
            a.capacity(kv + (B / pv.dp) * S * d * BF16, "kv+enc")
        elif fam in ("ssm", "hybrid"):
            st = (B / pv.dp) * cfg.d_inner * cfg.ssm_state * F32 \
                * cfg.n_layers / pv.tp
            a.capacity(st, "ssm_state")
            if fam == "hybrid":
                n_g = cfg.n_layers // max(cfg.attn_every, 1)
                kv = 2.0 * (B / pv.dp) * S * nkv * hd * BF16 * n_g
                a.capacity(kv / (pv.tp if nkv % pv.tp == 0 else 1),
                           "shared_kv")

    # ---- roofline terms -----------------------------------------------------
    # embedding table gather (tp/fsdp-sharded -> full table per lookup)
    if pv.tp * pv.fsdp > 1:
        emb = V * d * BF16
        a.coll(_ag_wire(emb, pv.tp * pv.fsdp)
               * (2 if kind == "train" else 1), "embed_ag")

    est = CostEstimate(
        flops=a.padded, useful_flops=a.useful, hbm_bytes=a.hbm,
        wire_bytes=a.wire,
        hbm_capacity_bytes=a.cap,
        compute_s=a.padded / chip.peak_flops_bf16,
        memory_s=a.hbm / chip.hbm_bytes_per_s,
        collective_s=a.wire / (chip.link_bytes_per_s * chip.links),
        fits=a.cap <= chip.hbm_capacity * 0.92,   # the JAX model's headroom
        mxu_utilization=a.useful / max(a.padded, 1.0),
        parts=a.parts,
    )
    return est
