"""The golden values that ``chip_smoke.py`` holds the PyTorch port's paths
against on the card, computed by the JAX package on the CPU.

The machine with the card has no JAX, so the files are committed:
``src/repro_torch/data/golden_mccm.npz`` (the MCCM paths),
``src/repro_torch/data/golden_lm.npz`` (the LM serving path),
``src/repro_torch/data/golden_lm_families.npz`` (the LM families past
dense),
``src/repro_torch/data/golden_dse.npz`` (the DSE path),
``src/repro_torch/data/golden_schedule.npz`` (the schedule layer),
``src/repro_torch/data/golden_multinet.npz`` (multinet co-scheduling) and
``src/repro_torch/data/golden_islands.npz`` (the island search) and
``src/repro_torch/data/golden_train.npz`` (the training losses and
gradients) and ``src/repro_torch/data/golden_mesh.npz`` (the LM mesh) and
``src/repro_torch/data/golden_mesh_families.npz`` (the other families on
the LM mesh).
Regenerate them after a change to the JAX package's model with::

    PYTHONPATH=src JAX_PLATFORMS=cpu python tests/torch_golden.py

``tests/test_torch_session.py``, ``tests/test_torch_lm.py``,
``tests/test_torch_dse.py``, ``tests/test_torch_schedule.py``,
``tests/test_torch_multinet.py``, ``tests/test_torch_islands.py``,
``tests/test_torch_moe.py``, ``tests/test_torch_ssm.py`` and
``tests/test_torch_encdec_vlm.py`` and ``tests/test_torch_train_models.py``
check that the committed files still equal what this computes.

Contents: for every CNN x board, the 12 baseline templates (3 archs x
n in {2, 5, 9, 11}) under ``tmpl/<cnn>/<board>/<metric>``, and 256
``sample_mixed`` rows (seed 0) of ResNet-50 on ZCU102 under
``mixed/resnet50/zcu102/<metric>``: the batch path's metrics.  And the
scalar Builder's ``Metrics`` of the same templates under
``scalar/<cnn>/<board>/<field>``, float64: the seven scalar fields of
``SCALAR_FIELDS``, and ``ce_busy_s`` as a (12, 16) array indexed by CE id,
NaN where a design has no such CE.

``golden_lm.npz``: the reduced Llama-3.2-1B config in f32 (``arch``,
``dtype``), its params from ``init(jax.random.key(0))`` flattened under
``params/<path>`` (per-layer leaves stacked on the leading layer axis), and
two request batches generated greedily by the JAX package's
``ServeEngine`` (default runtime, so ``auto`` attention): ``long`` (one
prompt past 2048 tokens, so prefill takes the chunked path) and ``short``
(the dense path).  Per batch: ``n_prompts``, ``prompt/<i>``, the
``new_tokens`` greedy ``tokens`` (n_prompts, new_tokens), and prefill's
``last_logits`` (n_prompts, padded vocab).

``golden_lm_families.npz``: per arch of ``FAMILY_ARCHS`` (MoE with drops,
MoE with a shared expert, Mamba2, the Zamba2 hybrid, Whisper, InternVL2),
under ``<arch>/``: the reduced config's overrides beside ``reduced()`` and
``dtype="float32"`` as JSON (``overrides``; Whisper's 2560 positions let
2100 frames through), ``new_tokens``, the params of ``init(jax.random.key(0))`` under
``params/<path>``, and two batches (``FAMILY_BATCHES``: ``long`` past 2048
positions somewhere, so prefill takes the chunked path; ``short``, dense):
``n_prompts``, ``prompt/<i>``, the stub ``frames`` (enc-dec, values k/4 in
float16, exact in f32) or ``patches`` (VLM, f32), the ``new_tokens``
greedy ``tokens`` and prefill's ``last_logits``.  The tokens are the JAX
package's ``ServeEngine.generate``'s, except the VLM's: its engine sizes
the cache without the patches, so its last steps overwrite the cache's
last slot; the VLM's tokens are the same greedy loop over the JAX
package's ``prefill`` (cache sized for patches and text) and
``decode_step``.

``golden_dse.npz``: the JAX package's DSE of MobileNetV2 on the default
board, on the CPU, at the two configurations of ``DSE_RUNS``: a random
sweep (``Session.explore``) and a guided search (``search``, the function
``Session.explore(strategy="search")`` runs, which also returns its
history).  Per run under ``<run>/``: the evaluated designs (``seg_end``,
``seg_pipe``, ``seg_nce``, ``inter_pipe``, in evaluation order), ``ok``
(valid and finite, as the search's archive screens), the ``front``
indices, the front rows' metrics under ``front/<metric>``, and (search)
``history`` as JSON; ``config`` holds ``DSE_RUNS`` as JSON.

``golden_schedule.npz``: the JAX package's ``schedule_specs`` on the CPU
over the 12 baseline templates of every CNN on ZC706 and of ResNet-50 on
every board (``SCHEDULE_GROUPS``): under ``sched/<cnn>/<board>/<field>``
every field it returns, the per-layer ones (``SCHEDULE_LAYER_FIELDS``) cut
to the net's own layer count; and under ``artifact/<cnn>`` the
``ScheduleArtifact.to_json()`` of ``Session.schedule`` on each CNN's
``hybrid`` design with 6 CEs on ZC706.

``golden_multinet.npz``: the JAX package's multinet on the CPU at the
configurations of ``MULTINET_EVAL`` and ``MULTINET_DEPLOY`` (``config``
holds both as JSON).  Per ``joint_evaluate`` mode under ``eval/<mode>/``:
the seeded inputs (``in/<design field>``, ``in/pes``, ``in/buf``,
``in/bw``, ``in/time``, ``in/assign``) and every output
(``out/<key>``).  Per ``Session.deploy`` arm under ``deploy/<arm>/``: the
evaluated designs in evaluation order, the raw share genomes
(``shares/<gene>``), the ``front`` indices, the front rows' metrics
(``front/<metric>``) and the ``objectives`` as JSON.

``golden_islands.npz``: the JAX package's ``search()`` of MobileNetV2 on
the default board, on the CPU, in its serial island model at the two
configurations of ``ISLAND_RUNS`` (``config`` holds them as JSON).  Per
run under ``<run>/``: every evaluated design in evaluation order, its
oriented ``points``, every metric (``metric/<name>``), the merged
``front`` indices, each island's front (``island/<i>``) and the
``history`` as JSON.

``golden_train.npz``: per arch of ``TRAIN_ARCHS`` (the reduced f32
Llama, Granite MoE, Mamba2, Zamba2, Whisper and InternVL2), under
``<arch>/``: ``params_file`` and ``params_prefix``, where the params of
``init(jax.random.key(0))`` already stand (``golden_lm.npz`` or
``golden_lm_families.npz``, not stored twice), the config's
``overrides`` (JSON, as there), the ``runtime`` of the loss (JSON: the
Llama, Zamba2, Whisper and InternVL2 cases take the chunked attention
path), the ``synth_batch`` of step 0 at ``TRAIN_SHAPE`` (``batch/<k>``),
and ``jax.value_and_grad(api.loss)``'s ``loss``, its metrics
(``nll``, ``aux``) and every gradient leaf in the JAX layout
(``grads/<path>``, per-layer leaves stacked).

``golden_mesh.npz``: the JAX package on a 2 x 2 (data, model) host mesh
(four CPU devices, ``REPRO_MESH_DEVICES=4``, in a subprocess: the test
process keeps one device), per arch of ``MESH_ARCHS`` (the reduced f32
Llama and Granite MoE) under ``<arch>/``, the params being those of
``params_file``/``params_prefix`` (``init(jax.random.key(0))``, not stored
twice): the ``synth_batch`` of step 0 at ``MESH_SHAPE`` (``batch/<k>``);
per plan of ``MESH_PLANS`` (``MESH_MOE_PLANS`` for the MoE; overrides of
``default_plan`` on the mesh, the chunked attention path) the loss, its
metrics and every gradient leaf (``train/<plan>/...``); the first plan's
one ``build_train`` step
(``step/loss``, ``step/grad_norm``, ``step/params/<path>``); prefill's last
logits with a cache of ``MESH_NEW`` more positions and that many greedy
decode steps (``prefill/logits``, ``decode/tokens``, ``decode/logits0``);
and the compressed data-parallel step over ``data``
(``make_compressed_train_step``, as ``launch/train.py --compress`` runs
it): the first step's averaged gradients, each data shard's residuals and
the shared scales (``compress/grads``, ``compress/residuals/<shard>``,
``compress/scales``) and ``MESH_COMPRESS_STEPS`` losses
(``compress/losses``) on the ``synth_batch`` of each step
(``compress/batch/<step>/<k>``: stored, since numpy's generators may
draw other tokens elsewhere).  Granite's layer-0 MoE on a correlated input whose
routing overflows the capacity (``moe/x``) through ``moe_ep`` and
``moe_ep_a2a`` (``moe/<impl>/y``, ``moe/<impl>/aux``).  On a 1 x 4 mesh,
for each case of ``MESH_ODD_HEADS`` (heads that do not divide the model
axis) under ``odd/<case>/``: its params (``init/<path>``,
``init(jax.random.key(0))`` of the case's config) and, on Llama's batch,
prefill, greedy decode and the loss with its gradients as above
(``mesh/...``).  ``config`` holds the settings as JSON.  Each arch and
the 1 x 4 cases run in a subprocess of their own, the three at once.

``golden_mesh_families.npz``: the JAX package on four host devices (one
subprocess), per arch of ``MESH_FAMILY_ARCHS`` (the reduced f32 Mamba2,
Zamba2, Whisper and InternVL2 of ``TRAIN_ARCHS``, whose params stand in
``golden_lm_families.npz``): the ``synth_batch`` of step 0 at
``MESH_FAMILY_SHAPE`` (``<arch>/batch/<k>``), and on each mesh of
``MESH_FAMILY_MESHES`` (2 x 2; 1 x 4, where the 4-wide model axis does not
divide the kv heads) under ``<mesh>/<arch>/``: ``default_plan``'s loss,
its metrics and every gradient leaf (``train/...``, the arch's attention
path of ``TRAIN_ARCHS``), and on the serving plan (the chunked attention)
prefill's last logits with a cache of ``MESH_NEW`` more positions and that
many greedy decode steps (``prefill/logits``, ``decode/logits0``,
``decode/tokens``).  ``config`` holds the settings as JSON.
"""
from __future__ import annotations

import json
import os

import numpy as np

DATA = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), "src", "repro_torch", "data")
GOLDEN = os.path.join(DATA, "golden_mccm.npz")
GOLDEN_LM = os.path.join(DATA, "golden_lm.npz")
GOLDEN_LM_FAMILIES = os.path.join(DATA, "golden_lm_families.npz")
GOLDEN_DSE = os.path.join(DATA, "golden_dse.npz")
GOLDEN_SCHEDULE = os.path.join(DATA, "golden_schedule.npz")

TEMPLATE_NS = (2, 5, 9, 11)
MIXED = ("resnet50", "zcu102", 256, 0)     # cnn, board, rows, seed

#: the scalar Metrics fields kept per design (besides ce_busy_s)
SCALAR_FIELDS = ("latency_s", "throughput_ips", "buffer_bytes",
                 "buffer_alloc_bytes", "access_bytes", "weight_access_bytes",
                 "fm_access_bytes")
#: columns of the ce_busy_s rows: one per CE id (the encoding's NC)
CE_IDS = 16


def scalar_rows(metrics) -> dict[str, np.ndarray]:
    """A list of scalar ``Metrics`` as float64 arrays keyed by field."""
    out = {k: np.array([float(getattr(m, k)) for m in metrics], np.float64)
           for k in SCALAR_FIELDS}
    busy = np.full((len(metrics), CE_IDS), np.nan)
    for i, m in enumerate(metrics):
        for ce, b in m.ce_busy_s.items():
            busy[i, ce] = b
    out["ce_busy_s"] = busy
    return out


def compute_golden() -> dict[str, np.ndarray]:
    """Metric arrays of the JAX package's batch path (plain backend) and
    of its scalar Builder."""
    from repro.cnn.registry import CNN_NAMES, get_cnn
    from repro.core.batch_eval import encode_specs, evaluate_batch, \
        make_tables
    from repro.core.dse import sample_mixed
    from repro.core.evaluator import _evaluate_design
    from repro.fpga.archs import ARCH_NAMES, make_arch
    from repro.fpga.boards import BOARD_NAMES, get_board

    out = {}
    for cnn in CNN_NAMES:
        net = get_cnn(cnn)
        tables = make_tables(net)
        specs = [make_arch(a, net, n) for a in ARCH_NAMES
                 for n in TEMPLATE_NS]
        db = encode_specs(specs, len(net))
        for board in BOARD_NAMES:
            dev = get_board(board)
            res = evaluate_batch(db, tables, dev, backend="ref")
            for k, v in res.items():
                out[f"tmpl/{cnn}/{board}/{k}"] = np.asarray(v)
            rows = scalar_rows([_evaluate_design(s, net, dev)
                                for s in specs])
            for k, v in rows.items():
                out[f"scalar/{cnn}/{board}/{k}"] = v
    cnn, board, rows, seed = MIXED
    net = get_cnn(cnn)
    db = sample_mixed(np.random.default_rng(seed), len(net), rows)
    res = evaluate_batch(db, make_tables(net), get_board(board),
                         backend="ref")
    for k, v in res.items():
        out[f"mixed/{cnn}/{board}/{k}"] = np.asarray(v)
    return out


#: the LM golden run: config, dtype, new tokens, and per batch the prompt
#: lengths (random tokens from seed 0)
LM_ARCH, LM_DTYPE, LM_NEW_TOKENS = "llama3.2-1b", "float32", 8
LM_BATCHES = {"long": (2100, 300), "short": (9, 23, 16)}


def compute_golden_lm() -> dict[str, np.ndarray]:
    """The JAX package's params and greedy generations of the reduced
    Llama config (see the module docstring)."""
    import jax
    import jax.numpy as jnp
    from repro.configs import get_config
    from repro.serve.engine import ServeEngine
    from repro_torch.models.convert import flatten

    cfg = get_config(LM_ARCH).reduced().replace(dtype=LM_DTYPE)
    engine = ServeEngine(cfg)
    params = engine.api.init(jax.random.key(0))
    out = {"arch": np.array(LM_ARCH), "dtype": np.array(LM_DTYPE),
           "new_tokens": np.array(LM_NEW_TOKENS),
           **flatten(params, "params/")}
    rng = np.random.default_rng(0)
    for batch, lens in LM_BATCHES.items():
        prompts = [rng.integers(1, cfg.vocab_size, n).astype(np.int32)
                   for n in lens]
        res = engine.generate(params, [p.tolist() for p in prompts],
                              max_new_tokens=LM_NEW_TOKENS)
        Lp = max(lens)
        toks = np.zeros((len(lens), Lp), np.int32)
        for i, p in enumerate(prompts):
            toks[i, Lp - len(p):] = p
        logits, _ = engine.api.prefill(params, {"tokens": jnp.asarray(toks)},
                                       engine.rt)
        out[f"{batch}/n_prompts"] = np.array(len(lens))
        for i, p in enumerate(prompts):
            out[f"{batch}/prompt/{i}"] = p
        out[f"{batch}/tokens"] = np.array(res.tokens, np.int32)
        out[f"{batch}/last_logits"] = np.asarray(logits[:, -1], np.float32)
    return out


#: the LM families' golden runs: each arch's overrides of its reduced f32
#: config, the prompt lengths of its batches (random tokens from seed 0),
#: the enc-dec's frames a batch, and the greedy new tokens
FAMILY_ARCHS = {"granite-moe-1b-a400m": {}, "kimi-k2-1t-a32b": {},
                "mamba2-370m": {}, "zamba2-1.2b": {},
                "whisper-base": {"max_abs_positions": 2560},
                "internvl2-2b": {}}
FAMILY_BATCHES = {"long": (2100, 300), "short": (9, 23, 16)}
#: Whisper's decoder prompts stay short; its long batch is the 2100 frames
ENCDEC_BATCHES = {"long": (300,), "short": (9, 23, 16)}
ENCDEC_FRAMES = {"long": 2100, "short": 64}
FAMILY_NEW_TOKENS = 8


def family_cfg(get_config, arch: str, overrides: dict):
    """The golden run's config of ``arch``, from either package's
    ``get_config``."""
    return get_config(arch).reduced().replace(dtype="float32", **overrides)


def family_batches(cfg) -> dict:
    return ENCDEC_BATCHES if cfg.family == "encdec" else FAMILY_BATCHES


def jax_greedy(api, params, batch: dict, rt, max_len: int, new: int,
               vocab: int) -> tuple[list, np.ndarray]:
    """The JAX package's ``ServeEngine`` greedy loop over its model's
    ``prefill`` and ``decode_step`` with a cache of ``max_len`` positions:
    the first token from prefill, then a decode step after each.  Returns
    the tokens and prefill's last logits."""
    import jax
    import jax.numpy as jnp
    prefill = jax.jit(lambda p, b: api.prefill(p, b, rt, max_len=max_len))
    decode = jax.jit(lambda p, c, t: api.decode_step(p, c, t, rt))
    logits, cache = prefill(params, batch)
    last = np.asarray(logits[:, -1], np.float32)
    tok = jnp.argmax(logits[:, -1, :vocab], -1).astype(jnp.int32)
    out = []
    for _ in range(new):
        out.append(np.asarray(tok))
        logits, cache = decode(params, cache, tok[:, None])
        tok = jnp.argmax(logits[:, -1, :vocab], -1).astype(jnp.int32)
    return np.stack(out, 1).tolist(), last


def compute_golden_lm_family(arch: str) -> dict[str, np.ndarray]:
    """One arch's entries of ``golden_lm_families.npz`` (see the module
    docstring), keys under ``<arch>/``."""
    import jax
    import jax.numpy as jnp
    from repro.configs import get_config
    from repro.serve.engine import ServeEngine
    from repro_torch.models.convert import flatten

    overrides = FAMILY_ARCHS[arch]
    cfg = family_cfg(get_config, arch, overrides)
    engine = ServeEngine(cfg)
    params = engine.api.init(jax.random.key(0))
    out = {"overrides": np.array(json.dumps(overrides)),
           "new_tokens": np.array(FAMILY_NEW_TOKENS),
           **flatten(params, "params/")}
    rng = np.random.default_rng(0)
    for batch, lens in family_batches(cfg).items():
        prompts = [rng.integers(1, cfg.vocab_size, n).astype(np.int32)
                   for n in lens]
        B, Lp = len(lens), max(lens)
        extra = {}
        if cfg.family == "encdec":
            shape = (B, ENCDEC_FRAMES[batch], cfg.frontend_dim)
            extra["frames"] = (rng.integers(-4, 4, shape) / 4).astype(
                np.float16)
        if cfg.family == "vlm":
            extra["patches"] = rng.standard_normal(
                (B, cfg.n_patches, cfg.frontend_dim), dtype=np.float32)
        jextra = {k: jnp.asarray(v, jnp.float32) for k, v in extra.items()}
        toks = np.zeros((B, Lp), np.int32)
        for i, p in enumerate(prompts):
            toks[i, Lp - len(p):] = p
        inputs = {"tokens": jnp.asarray(toks), **jextra}
        max_len = Lp + FAMILY_NEW_TOKENS + 1
        if cfg.family == "vlm":
            tokens, logits = jax_greedy(
                engine.api, params, inputs, engine.rt,
                cfg.n_patches + max_len, FAMILY_NEW_TOKENS, cfg.vocab_size)
        else:
            tokens = engine.generate(
                params, [p.tolist() for p in prompts],
                max_new_tokens=FAMILY_NEW_TOKENS,
                extra_inputs=jextra or None).tokens
            # the engine's own compiled prefill, on the same inputs
            logits = np.asarray(engine._prefill(params, inputs, max_len)[0]
                                [:, -1], np.float32)
        pre = f"{batch}/"
        out[pre + "n_prompts"] = np.array(B)
        for i, p in enumerate(prompts):
            out[f"{pre}prompt/{i}"] = p
        for k, v in extra.items():
            out[pre + k] = v
        out[pre + "tokens"] = np.array(tokens, np.int32)
        out[pre + "last_logits"] = logits
    return {f"{arch}/{k}": v for k, v in out.items()}


#: the DSE golden runs: MobileNetV2 on the default board
DSE_CNN = "mobilenetv2"
DSE_RUNS = {"random": dict(n=8192, seed=7, chunk=4096),
            "search": dict(n=4096, seed=3, pop_size=1024)}
DESIGN_FIELDS = ("seg_end", "seg_pipe", "seg_nce", "inter_pipe")


def compute_golden_dse() -> dict[str, np.ndarray]:
    """The JAX package's random sweep and guided search (see the module
    docstring)."""
    from repro.api import Session
    from repro.cnn.registry import get_cnn
    from repro.core.dse import orient, validate_batch
    from repro.core.dse.search import SearchConfig, search
    from repro.fpga.boards import get_board

    net, dev = get_cnn(DSE_CNN), get_board()
    rnd = DSE_RUNS["random"]
    res = Session(dev).explore(net, n=rnd["n"], seed=rnd["seed"],
                               chunk=rnd["chunk"])
    runs = {"random": (res.batch, res.metrics, res.front, None)}
    srch = DSE_RUNS["search"]
    res = search(net, dev, SearchConfig(budget=srch["n"], seed=srch["seed"],
                                        pop_size=srch["pop_size"]))
    runs["search"] = (res.batch, res.metrics, res.front_idx, res.history)
    out = {"config": np.array(json.dumps({"cnn": DSE_CNN, **DSE_RUNS}))}
    for run, (batch, metrics, front, history) in runs.items():
        for k, v in zip(DESIGN_FIELDS, batch.to_numpy()):
            out[f"{run}/{k}"] = v
        pts = orient(metrics, ("latency_s", "buffer_bytes"))
        out[f"{run}/ok"] = validate_batch(batch, len(net), min_ces=2,
                                          max_ces=11) \
            & np.isfinite(pts).all(1)
        out[f"{run}/front"] = np.asarray(front, np.int64)
        for k, v in metrics.items():
            out[f"{run}/front/{k}"] = np.asarray(v)[front]
        if history is not None:
            out[f"{run}/history"] = np.array(json.dumps(history))
    return out


#: the schedule golden designs' (cnn, board) groups, and each CNN's
#: artifact design (arch, CEs) on ARTIFACT_BOARD
SCHEDULE_BOARD, ARTIFACT_DESIGN = "zc706", ("hybrid", 6)
#: the (B, max_L) fields of schedule_specs, kept cut to the net's layers
SCHEDULE_LAYER_FIELDS = (
    "choice", "phi", "tile_bytes", "companion_bytes", "floor_bytes",
    "budget_bytes", "lat_ref_l", "lat_coarse_l", "acc_ref_l",
    "acc_coarse_l", "pf_l", "ph_l", "pw_l", "ce_of_layer", "seg_of_layer",
    "pipe_l", "valid_l", "n_tiles_l", "ce_buf_l", "buf_l")


def schedule_groups() -> list[tuple[str, str]]:
    """(cnn, board) of every golden schedule group."""
    from repro.cnn.registry import CNN_NAMES
    from repro.fpga.boards import BOARD_NAMES
    return [(c, SCHEDULE_BOARD) for c in CNN_NAMES] + [
        ("resnet50", b) for b in BOARD_NAMES if b != SCHEDULE_BOARD]


def compute_golden_schedule() -> dict[str, np.ndarray]:
    """The JAX package's schedule search (see the module docstring)."""
    from repro.api import Session
    from repro.cnn.registry import CNN_NAMES, get_cnn
    from repro.fpga.archs import ARCH_NAMES, make_arch
    from repro.fpga.boards import get_board
    from repro.schedule import schedule_specs

    out = {}
    for cnn, board in schedule_groups():
        net = get_cnn(cnn)
        specs = [make_arch(a, net, n) for a in ARCH_NAMES
                 for n in TEMPLATE_NS]
        res = schedule_specs(specs, net, get_board(board), backend="ref")
        for k, v in res.items():
            v = np.asarray(v)
            out[f"sched/{cnn}/{board}/{k}"] = \
                v[:, :len(net)] if k in SCHEDULE_LAYER_FIELDS else v
    ses = Session(get_board(SCHEDULE_BOARD))
    arch, n = ARTIFACT_DESIGN
    for cnn in CNN_NAMES:
        net = get_cnn(cnn)
        out[f"artifact/{cnn}"] = np.array(
            ses.schedule(make_arch(arch, net, n), net).to_json())
    ses.close()
    return out


GOLDEN_MULTINET = os.path.join(DATA, "golden_multinet.npz")
#: the multinet golden inputs: ``joint_evaluate`` per mode on 256 seeded
#: deployments (spatial and temporal: the ResNet-50 + MobileNetV2 study of
#: benchmarks/multinet_fronts.py on ZC706; hybrid: the 3-model study of
#: benchmarks/multinet_hybrid.py, its SLOs and 1:2:1 request mix), and one
#: ``Session.deploy`` per arm at the studies' quick budget (768, pop 256,
#: seed 3): the hybrid arm on the 3-model study with ``objective="slo"``
MULTINET_PAIR = ["resnet50", "mobilenetv2"]
MULTINET_TRIO = ["resnet50", "mobilenetv2", "densenet121"]
MULTINET_SLO = [0.120, 0.030, 0.130]
MULTINET_WEIGHTS = [1.0, 2.0, 1.0]
MULTINET_EVAL = {
    "spatial": dict(nets=MULTINET_PAIR, board="zc706", n=256, seed=0,
                    weights=None, slo_s=None, reconfig_s=0.0),
    "temporal": dict(nets=MULTINET_PAIR, board="zc706", n=256, seed=0,
                     weights=None, slo_s=None, reconfig_s=0.002),
    "hybrid": dict(nets=MULTINET_TRIO, board="zc706", n=256, seed=1,
                   weights=MULTINET_WEIGHTS, slo_s=MULTINET_SLO,
                   reconfig_s=0.002)}
MULTINET_DEPLOY = {
    "budget": 768, "pop_size": 256, "seed": 3, "board": "zc706",
    "arms": {"search": dict(nets=MULTINET_PAIR),
             "equal_split": dict(nets=MULTINET_PAIR),
             "temporal": dict(nets=MULTINET_PAIR),
             "hybrid": dict(nets=MULTINET_TRIO, objective="slo",
                            slo_s=MULTINET_SLO, weights=MULTINET_WEIGHTS),
             "random": dict(nets=MULTINET_PAIR)}}


def multinet_inputs(mode: str, sample_mixed, stack_designs, sample_shares,
                    sample_assign, get_cnn, max_m: int = 4):
    """The seeded inputs of one golden ``joint_evaluate`` mode, drawn with
    the given package's samplers (both packages draw the same): the
    stacked designs and ``{pes, buf, bw, time, assign}`` planes."""
    c = MULTINET_EVAL[mode]
    rng = np.random.default_rng(c["seed"])
    nets = [get_cnn(n) for n in c["nets"]]
    md = stack_designs([sample_mixed(rng, len(n), c["n"]) for n in nets],
                       max_m)
    m = len(nets)
    planes = {r: sample_shares(rng, c["n"], max_m, m)
              for r in ("pes", "buf", "bw", "time")}
    planes["assign"] = sample_assign(rng, c["n"], max_m, m)
    return md, planes


def multinet_mode_kw(mode: str, planes: dict) -> dict:
    """``joint_evaluate``'s keyword arguments for a golden mode."""
    c = MULTINET_EVAL[mode]
    if mode == "spatial":
        return dict(pes_shares=planes["pes"], buf_shares=planes["buf"],
                    bw_shares=planes["bw"])
    if mode == "temporal":
        return dict(time_shares=planes["time"], reconfig_s=c["reconfig_s"])
    return dict(assign=planes["assign"], pes_shares=planes["pes"],
                buf_shares=planes["buf"], bw_shares=planes["bw"],
                time_shares=planes["time"], reconfig_s=c["reconfig_s"])


def compute_golden_multinet() -> dict[str, np.ndarray]:
    """The JAX package's joint evaluator and ``Session.deploy`` arms (see
    the module docstring)."""
    from repro.api import Session
    from repro.cnn.registry import get_cnn
    from repro.core.dse import sample_assign, stack_designs
    from repro.core.dse.samplers import sample_mixed
    from repro.core.multinet import (MultinetSearchConfig, joint_evaluate,
                                     make_multi_tables, sample_shares)
    from repro.fpga.boards import get_board

    out = {"config": np.array(json.dumps({"eval": MULTINET_EVAL,
                                          "deploy": MULTINET_DEPLOY}))}
    for mode, c in MULTINET_EVAL.items():
        md, planes = multinet_inputs(mode, sample_mixed, stack_designs,
                                     sample_shares, sample_assign, get_cnn)
        mt = make_multi_tables([get_cnn(n) for n in c["nets"]],
                               weights=c["weights"], slo_s=c["slo_s"])
        res = joint_evaluate(md, mt, get_board(c["board"]), mode=mode,
                             **multinet_mode_kw(mode, planes))
        for k, v in zip(DESIGN_FIELDS, md.to_numpy()):
            out[f"eval/{mode}/in/{k}"] = v
        for k, v in planes.items():
            out[f"eval/{mode}/in/{k}"] = v
        for k, v in res.items():
            out[f"eval/{mode}/out/{k}"] = np.asarray(v)
    d = MULTINET_DEPLOY
    ses = Session(get_board(d["board"]))
    for arm, c in d["arms"].items():
        nets = [get_cnn(n) for n in c["nets"]]
        if arm == "random":
            res = ses.deploy(nets, d["budget"], strategy="random",
                             seed=d["seed"], chunk=d["pop_size"])
        else:
            extra = {k: v for k, v in c.items() if k != "nets"}
            res = ses.deploy(nets, d["budget"], strategy=arm,
                             config=MultinetSearchConfig(
                                 pop_size=d["pop_size"], seed=d["seed"],
                                 **extra))
        p = f"deploy/{arm}"
        for k, v in zip(DESIGN_FIELDS, res.designs.to_numpy()):
            out[f"{p}/{k}"] = v
        for k, v in res.shares.items():
            out[f"{p}/shares/{k}"] = v
        out[f"{p}/front"] = np.asarray(res.front, np.int64)
        for k, v in res.metrics.items():
            out[f"{p}/front/{k}"] = np.asarray(v)[res.front]
        out[f"{p}/objectives"] = np.array(json.dumps(list(res.objectives)))
    ses.close()
    return out


GOLDEN_ISLANDS = os.path.join(DATA, "golden_islands.npz")
#: A: tests/test_shard.py's island configuration; B: three islands whose
#: final generation (57/57/56 rows) runs in two sub-rounds of pop 40
ISLAND_CNN = "mobilenetv2"
ISLAND_RUNS = {
    "A": dict(n_islands=4, pop_size=64, budget=1300, migration_interval=2,
              migration_elites=4, seed=3),
    "B": dict(n_islands=3, pop_size=40, budget=530, migration_interval=1,
              migration_elites=3, seed=5)}


def compute_golden_islands() -> dict[str, np.ndarray]:
    """The JAX package's island search (see the module docstring)."""
    from repro.cnn.registry import get_cnn
    from repro.core.dse.search import SearchConfig, search
    from repro.fpga.boards import get_board

    out = {"config": np.array(json.dumps({"cnn": ISLAND_CNN,
                                          **ISLAND_RUNS}))}
    for run, kw in ISLAND_RUNS.items():
        res = search(get_cnn(ISLAND_CNN), get_board(), SearchConfig(**kw))
        for k, v in zip(DESIGN_FIELDS, res.batch.to_numpy()):
            out[f"{run}/{k}"] = np.asarray(v)
        out[f"{run}/points"] = np.asarray(res.points)
        for k, v in res.metrics.items():
            out[f"{run}/metric/{k}"] = np.asarray(v)
        out[f"{run}/front"] = np.asarray(res.front_idx, np.int64)
        for i, f in enumerate(res.island_fronts):
            out[f"{run}/island/{i}"] = np.asarray(f, np.int64)
        out[f"{run}/history"] = np.array(json.dumps(res.history))
    return out


GOLDEN_TRAIN = os.path.join(DATA, "golden_train.npz")
#: the training golden runs: per arch, the golden file and key prefix of
#: its params, its overrides (those of that file) and the runtime's
#: attention path
TRAIN_ARCHS = {
    "llama3.2-1b": ("golden_lm.npz", "params/", {}, "chunked"),
    "granite-moe-1b-a400m": ("golden_lm_families.npz",
                             "granite-moe-1b-a400m/params/", {}, "auto"),
    "mamba2-370m": ("golden_lm_families.npz", "mamba2-370m/params/", {},
                    "auto"),
    "zamba2-1.2b": ("golden_lm_families.npz", "zamba2-1.2b/params/", {},
                    "chunked"),
    "whisper-base": ("golden_lm_families.npz", "whisper-base/params/",
                     FAMILY_ARCHS["whisper-base"], "chunked"),
    "internvl2-2b": ("golden_lm_families.npz", "internvl2-2b/params/", {},
                     "chunked"),
}
#: (seq_len, batch) of the training golden batches: Whisper's 64 frames
#: (8 decoder tokens); InternVL2's 4 patches and 28 text tokens
TRAIN_SHAPE = {"whisper-base": (64, 2)}
TRAIN_SHAPE_DEFAULT = (32, 2)


def train_case(get_config, arch: str):
    """(config, ShapeSpec, runtime fields) of an arch's training golden
    run, from either package's ``get_config``."""
    from repro.configs.base import ShapeSpec
    _, _, overrides, attn = TRAIN_ARCHS[arch]
    S, B = TRAIN_SHAPE.get(arch, TRAIN_SHAPE_DEFAULT)
    return (family_cfg(get_config, arch, overrides),
            ShapeSpec("golden_train", "train", S, B), {"attn_mode": attn})


def compute_golden_train() -> dict[str, np.ndarray]:
    """The JAX package's training losses and gradients (see the module
    docstring)."""
    import jax
    import jax.numpy as jnp
    from repro.configs import get_config
    from repro.data.pipeline import synth_batch
    from repro.models.registry import get_model
    from repro.models.runtime import Runtime
    from repro_torch.models.convert import flatten

    out = {}
    for arch, (pfile, prefix, overrides, _) in TRAIN_ARCHS.items():
        cfg, shape, rt_kw = train_case(get_config, arch)
        api = get_model(cfg)
        params = api.init(jax.random.key(0))
        batch = synth_batch(cfg, shape, 0)
        rt = Runtime(**rt_kw)
        (loss, metrics), grads = jax.jit(jax.value_and_grad(
            lambda p, b: api.loss(p, b, rt), has_aux=True))(
                params, {k: jnp.asarray(v) for k, v in batch.items()})
        pre = f"{arch}/"
        out.update({pre + "params_file": np.array(pfile),
                    pre + "params_prefix": np.array(prefix),
                    pre + "overrides": np.array(json.dumps(overrides)),
                    pre + "runtime": np.array(json.dumps(rt_kw)),
                    pre + "loss": np.asarray(loss, np.float32),
                    pre + "nll": np.asarray(metrics["nll"], np.float32),
                    pre + "aux": np.asarray(metrics["aux"], np.float32)})
        out.update({f"{pre}batch/{k}": v for k, v in batch.items()})
        out.update(flatten(jax.tree.map(np.asarray, grads),
                           pre + "grads/"))
    return out


GOLDEN_MESH = os.path.join(DATA, "golden_mesh.npz")
#: the mesh golden runs: per arch, where its params stand (file, prefix)
MESH_ARCHS = {"llama3.2-1b": ("golden_lm.npz", "params/"),
              "granite-moe-1b-a400m": ("golden_lm_families.npz",
                                       "granite-moe-1b-a400m/params/")}
#: (seq_len, batch) of the mesh batches, the greedy decode steps, the
#: compressed steps and their optimizer (the train launcher's)
MESH_SHAPE = (16, 4)
MESH_NEW = 4
MESH_COMPRESS_STEPS = 12
MESH_COMPRESS_OPT = dict(peak_lr=3e-3, warmup=20, total_steps=100)
#: the train plans on the mesh: overrides of default_plan (ZeRO-3 over
#: data, tp over model); every one takes the chunked attention path.  The
#: MoE family takes the first two.  The first is the one-step plan: data
#: and tensor parallelism without ZeRO-3, whose backward needs no
#: reduce-scatter
MESH_PLANS = {"tp_dp": {"fsdp_axes": ()}, "fsdp": {},
              "seq": {"act_shard": "seq"}}
MESH_MOE_PLANS = ("tp_dp", "fsdp")
MESH_MOE_SHAPE = (2, 64)
#: the 1 x 4 cases, where the 4-wide model axis does not divide the
#: reduced Llama's heads: config overrides (``kv``: its 2 kv heads
#: repeated to its 4 heads, the decode cache sharded on its sequence;
#: ``pad``: 6 heads of 16 padded to 8)
MESH_ODD_HEADS = {"kv": {}, "pad": dict(n_heads=6, n_kv_heads=2,
                                        head_dim=16)}


def mesh_moe_input(cfg) -> np.ndarray:
    """(B, S, d) f32 MoE input whose tokens share one direction, so the
    router sends most of them to the same experts and each shard's
    capacity drops some (seed 0)."""
    rng = np.random.default_rng(0)
    B, S = MESH_MOE_SHAPE
    base = rng.standard_normal(cfg.d_model).astype(np.float32)
    noise = rng.standard_normal((B, S, cfg.d_model)).astype(np.float32)
    return (base * 4.0 + 0.5 * noise).astype(np.float32)


#: the parts of the mesh golden run, one subprocess each
MESH_PARTS = (*MESH_ARCHS, "odd")

GOLDEN_MESH_FAMILIES = os.path.join(DATA, "golden_mesh_families.npz")
#: the families' mesh golden run: the archs (their configs, params and
#: attention paths those of TRAIN_ARCHS), (seq_len, batch) of the batch,
#: and the meshes
MESH_FAMILY_ARCHS = ("mamba2-370m", "zamba2-1.2b", "whisper-base",
                     "internvl2-2b")
MESH_FAMILY_SHAPE = {"whisper-base": (64, 4)}
MESH_FAMILY_SHAPE_DEFAULT = (32, 4)
MESH_FAMILY_MESHES = {"2x2": (2, 2), "1x4": (1, 4)}
#: the serving plans of each case: (key, overrides of the serving plan,
#: the meshes and archs it runs on); ``long`` is default_plan's long_500k
#: branch (the cache's sequence over data, no dp axes), whose 1 x 4
#: Zamba2 cache shards its shared block's head dim over model
MESH_FAMILY_SERVE = (("", {}, None),
                     ("long/", {"seq_shard_cache": True, "dp_axes": []},
                      {"1x4": ["zamba2-1.2b"]}))


def mesh_family_case(get_config, arch: str):
    """(config, train ShapeSpec, train attention path) of an arch's case
    in ``golden_mesh_families.npz``, from either package's
    ``get_config``."""
    cfg, _, rt_kw = train_case(get_config, arch)
    S, B = MESH_FAMILY_SHAPE.get(arch, MESH_FAMILY_SHAPE_DEFAULT)
    from repro_torch.configs.base import ShapeSpec
    return cfg, ShapeSpec("mesh", "train", S, B), rt_kw["attn_mode"]


def serve_inputs(cfg, batch: dict) -> dict:
    """A family's prefill inputs of a train batch: the tokens and the
    frontend stub's frames or patches."""
    return {k: v for k, v in batch.items() if k != "labels"}


class GoldenMeshRun:
    """:func:`compute_golden_mesh` started in the background: one
    subprocess with four host devices for each of ``parts``
    (``MESH_PARTS``, or ``("families",)`` for
    ``golden_mesh_families.npz``), all at once; :meth:`result` waits and
    merges them, :meth:`stop` kills what still runs."""

    def __init__(self, parts: tuple = MESH_PARTS):
        import subprocess
        import sys
        import tempfile
        self._dir = tempfile.TemporaryDirectory()
        env = dict(os.environ, REPRO_MESH_DEVICES="4", JAX_PLATFORMS="cpu")
        self._jobs = {}
        for i, part in enumerate(parts):
            out = os.path.join(self._dir.name, f"{i}.npz")
            self._jobs[out] = subprocess.Popen(
                [sys.executable, os.path.abspath(__file__), "--mesh-inner",
                 out, part], env=env, stdout=subprocess.PIPE,
                stderr=subprocess.PIPE, text=True)

    def result(self, timeout: float = 600) -> dict[str, np.ndarray]:
        out: dict[str, np.ndarray] = {}
        try:
            for path, job in self._jobs.items():
                stdout, stderr = job.communicate(timeout=timeout)
                if job.returncode:
                    raise RuntimeError(f"mesh golden subprocess failed:\n"
                                       f"{stdout[-2000:]}\n{stderr[-4000:]}")
                with np.load(path) as z:
                    out.update({k: z[k] for k in z.files})
        finally:
            self.stop()
        return out

    def stop(self) -> None:
        for job in self._jobs.values():
            if job.poll() is None:
                job.kill()
                job.wait()
        self._dir.cleanup()


def compute_golden_mesh() -> dict[str, np.ndarray]:
    """The JAX package's mesh values (see the module docstring), from
    subprocesses with four host devices."""
    return GoldenMeshRun().result()


def compute_golden_mesh_families() -> dict[str, np.ndarray]:
    """The JAX package's families on its meshes (see the module
    docstring), from one subprocess with four host devices."""
    return GoldenMeshRun(("families",)).result()


def _mesh_families_inner() -> dict[str, np.ndarray]:
    """``golden_mesh_families.npz``'s values (module docstring)."""
    import dataclasses

    import repro.core.shard  # noqa: F401  (four host devices first)
    import jax
    import jax.numpy as jnp
    from jax.sharding import NamedSharding
    from jax.sharding import PartitionSpec as P
    from repro.configs import get_config
    from repro.configs.base import ShapeSpec
    from repro.data.pipeline import synth_batch
    from repro.launch import plans as PL
    from repro.launch.mesh import make_mesh_spec
    from repro.models.registry import get_model
    from repro_torch.models.convert import flatten

    out = {"config": np.array(json.dumps(dict(
        archs=MESH_FAMILY_ARCHS, meshes=MESH_FAMILY_MESHES, new=MESH_NEW,
        shape=MESH_FAMILY_SHAPE, shape_default=MESH_FAMILY_SHAPE_DEFAULT,
        serve=MESH_FAMILY_SERVE)))}

    def named(tree, mesh):
        return jax.tree.map(lambda s: NamedSharding(mesh, s), tree,
                            is_leaf=lambda x: isinstance(x, P))

    def np32(t):
        return jax.tree.map(lambda a: np.asarray(a, np.float32), t)

    def serve(cfg, api, params, inputs, mesh, S, pre, ov):
        """Prefill and MESH_NEW greedy decode steps on the serving plan
        (the chunked attention, ``ov``'s overrides): ``pre`` +
        prefill/logits, decode/logits0 and decode/tokens."""
        sshape = ShapeSpec("mesh", "prefill", S, inputs["tokens"].shape[0])
        splan = dataclasses.replace(
            PL.default_plan(cfg, sshape, mesh), attn_mode="chunked",
            **{k: tuple(v) if isinstance(v, list) else v
               for k, v in ov.items()})
        srt = splan.runtime(mesh)
        sp_specs = PL.sanitize_pspecs(
            PL.param_pspecs(params, splan), params, mesh)
        # the JAX VLM's cache counts the patches in max_len
        max_len = S + MESH_NEW + (cfg.n_patches
                                  if cfg.family == "vlm" else 0)
        pf = jax.jit(lambda p, b: api.prefill(p, b, srt,
                                              max_len=max_len),
                     in_shardings=(named(sp_specs, mesh), None))
        logits, cache = pf(params, inputs)
        out[pre + "prefill/logits"] = np.asarray(logits[:, -1],
                                                 np.float32)
        c_specs = PL.sanitize_pspecs(
            PL.cache_pspecs(cache, splan, cfg, mesh), cache, mesh)
        cache = jax.device_put(cache, named(c_specs, mesh))
        dec = jax.jit(lambda p, c, t: api.decode_step(p, c, t, srt),
                      in_shardings=(named(sp_specs, mesh),
                                    named(c_specs, mesh), None))
        tok = jnp.argmax(logits[:, -1, :cfg.vocab_size],
                         -1).astype(jnp.int32)
        toks = []
        for i in range(MESH_NEW):
            toks.append(np.asarray(tok))
            logits, cache = dec(params, cache, tok[:, None])
            if i == 0:
                out[pre + "decode/logits0"] = np.asarray(
                    logits[:, -1], np.float32)
            tok = jnp.argmax(logits[:, -1, :cfg.vocab_size],
                             -1).astype(jnp.int32)
        out[pre + "decode/tokens"] = np.stack(toks, 1).astype(
            np.int32)

    for arch in MESH_FAMILY_ARCHS:
        cfg, tshape, attn = mesh_family_case(get_config, arch)
        shape = ShapeSpec("mesh", "train", tshape.seq_len,
                          tshape.global_batch)
        api = get_model(cfg)
        params = api.init(jax.random.key(0))
        batch = synth_batch(cfg, shape, 0)
        out.update({f"{arch}/batch/{k}": v for k, v in batch.items()})
        jb = {k: jnp.asarray(v) for k, v in batch.items()}
        inputs = serve_inputs(cfg, jb)
        S = inputs["tokens"].shape[1]
        for mname, dims in MESH_FAMILY_MESHES.items():
            mesh = make_mesh_spec(*dims)
            pre = f"{mname}/{arch}/"
            with mesh:
                plan = dataclasses.replace(PL.default_plan(cfg, shape, mesh),
                                           attn_mode=attn)
                rt = plan.runtime(mesh)
                p_specs = PL.sanitize_pspecs(PL.param_pspecs(params, plan),
                                             params, mesh)
                fn = jax.jit(jax.value_and_grad(
                    lambda p, b: api.loss(p, b, rt), has_aux=True),
                    in_shardings=(named(p_specs, mesh),
                                  named(PL.batch_pspecs(jb, plan), mesh)))
                (loss, met), grads = fn(params, jb)
                out.update({pre + "train/loss": np.asarray(loss, np.float32),
                            pre + "train/nll": np.asarray(met["nll"],
                                                          np.float32),
                            pre + "train/aux": np.asarray(met["aux"],
                                                          np.float32)})
                out.update(flatten(np32(grads), pre + "train/grads/"))
                for key, ov, where in MESH_FAMILY_SERVE:
                    if where is None or arch in where.get(mname, ()):
                        serve(cfg, api, params, inputs, mesh, S,
                              f"{pre}{key}", ov)
    return out


def _mesh_golden_inner(part: str) -> dict[str, np.ndarray]:
    """``part`` of the mesh golden values: an arch of ``MESH_ARCHS`` on
    the 2 x 2 mesh, ``odd``, the 1 x 4 cases, or ``families``
    (``golden_mesh_families.npz``); each with ``config``."""
    import dataclasses
    if part == "families":
        return _mesh_families_inner()

    import repro.core.shard  # noqa: F401  (splits the host into
    #                          REPRO_MESH_DEVICES devices before jax starts)
    import jax
    import jax.numpy as jnp
    from jax import lax
    from jax.sharding import NamedSharding
    from jax.sharding import PartitionSpec as P
    from repro.compat import shard_map
    from repro.configs import get_config
    from repro.configs.base import ShapeSpec
    from repro.data.pipeline import synth_batch
    from repro.launch import plans as PL
    from repro.launch import steps as ST
    from repro.launch.mesh import make_mesh_spec
    from repro.models import moe as M
    from repro.models.registry import get_model
    from repro.train.optimizer import make_optimizer
    from repro.train.train_step import (TrainState, compressed_psum,
                                        init_residuals,
                                        make_compressed_train_step)
    from repro_torch.models.convert import flatten

    mesh = make_mesh_spec(2, 2)
    S, B = MESH_SHAPE
    shape = ShapeSpec("mesh", "train", S, B)
    out = {"config": np.array(json.dumps(dict(
        mesh=[2, 2], shape=MESH_SHAPE, new=MESH_NEW,
        compress_steps=MESH_COMPRESS_STEPS, compress_opt=MESH_COMPRESS_OPT,
        plans=MESH_PLANS, moe_plans=MESH_MOE_PLANS,
        moe_shape=MESH_MOE_SHAPE, odd_heads=MESH_ODD_HEADS)))}

    def named(tree, mesh):
        return jax.tree.map(lambda s: NamedSharding(mesh, s), tree,
                            is_leaf=lambda x: isinstance(x, P))

    def np_tree(t):
        return jax.tree.map(lambda a: np.asarray(a, np.float32), t)

    def loss_grads(api, params, jb, plan, mesh, pre):
        """``pre`` + loss, nll, aux and grads/<path> under ``plan``."""
        rt = plan.runtime(mesh)
        p_specs = PL.sanitize_pspecs(PL.param_pspecs(params, plan), params,
                                     mesh)
        b_specs = PL.batch_pspecs(jb, plan)
        fn = jax.jit(jax.value_and_grad(
            lambda p, b: api.loss(p, b, rt), has_aux=True),
            in_shardings=(named(p_specs, mesh), named(b_specs, mesh)))
        (loss, met), grads = fn(params, jb)
        out.update({pre + "loss": np.asarray(loss, np.float32),
                    pre + "nll": np.asarray(met["nll"], np.float32),
                    pre + "aux": np.asarray(met["aux"], np.float32)})
        out.update(flatten(np_tree(grads), pre + "grads/"))

    def greedy(cfg, api, params, tokens, mesh, pre):
        """Prefill and MESH_NEW greedy decode steps on the serving plan:
        ``pre`` + prefill/logits, decode/logits0 and decode/tokens."""
        sshape = ShapeSpec("mesh", "prefill", S, B)
        splan = dataclasses.replace(PL.default_plan(cfg, sshape, mesh),
                                    attn_mode="chunked")
        srt = splan.runtime(mesh)
        p_specs = PL.sanitize_pspecs(PL.param_pspecs(params, splan),
                                     params, mesh)
        pf = jax.jit(lambda p, t: api.prefill(p, {"tokens": t}, srt,
                                              max_len=S + MESH_NEW),
                     in_shardings=(named(p_specs, mesh), None))
        logits, cache = pf(params, tokens)
        out[pre + "prefill/logits"] = np.asarray(logits[:, -1], np.float32)
        c_specs = PL.sanitize_pspecs(
            PL.cache_pspecs(cache, splan, cfg, mesh), cache, mesh)
        # onto the cache's own specs (a sequence-sharded cache where the
        # kv heads do not divide the model axis; else where it already is)
        cache = jax.device_put(cache, named(c_specs, mesh))
        dec = jax.jit(lambda p, c, t: api.decode_step(p, c, t, srt),
                      in_shardings=(named(p_specs, mesh),
                                    named(c_specs, mesh), None))
        tok = jnp.argmax(logits[:, -1, :cfg.vocab_size], -1).astype(
            jnp.int32)
        toks = []
        for i in range(MESH_NEW):
            toks.append(np.asarray(tok))
            logits, cache = dec(params, cache, tok[:, None])
            if i == 0:
                out[pre + "decode/logits0"] = np.asarray(logits[:, -1],
                                                         np.float32)
            tok = jnp.argmax(logits[:, -1, :cfg.vocab_size],
                             -1).astype(jnp.int32)
        out[pre + "decode/tokens"] = np.stack(toks, 1).astype(np.int32)

    for arch, (pfile, prefix) in MESH_ARCHS.items():
        if arch != part:
            continue
        pre = f"{arch}/"
        cfg = family_cfg(get_config, arch, {})
        api = get_model(cfg)
        params = api.init(jax.random.key(0))
        batch = synth_batch(cfg, shape, 0)
        jb = {k: jnp.asarray(v) for k, v in batch.items()}
        out.update({pre + "params_file": np.array(pfile),
                    pre + "params_prefix": np.array(prefix)})
        out.update({f"{pre}batch/{k}": v for k, v in batch.items()})
        base = dataclasses.replace(PL.default_plan(cfg, shape, mesh),
                                   attn_mode="chunked")
        plans = MESH_PLANS if cfg.family == "dense" else {
            k: MESH_PLANS[k] for k in MESH_MOE_PLANS}
        with mesh:
            for name, ov in plans.items():
                loss_grads(api, params, jb, dataclasses.replace(base, **ov),
                           mesh, f"{pre}train/{name}/")
            # one build_train step of the first plan
            plan = dataclasses.replace(base, **next(iter(plans.values())))
            built = ST.build_train(cfg, shape, mesh, plan)
            opt = ST.make_optimizer_for(plan, cfg)
            mine = jax.tree.map(jnp.copy, params)    # the step donates it
            state = TrainState(params=mine, opt=opt.init(mine),
                               step=jnp.zeros((), jnp.int32))
            new, met = built.fn(state, jb)
            out.update({pre + "step/loss": np.asarray(met["loss"],
                                                      np.float32),
                        pre + "step/grad_norm": np.asarray(met["grad_norm"],
                                                           np.float32)})
            out.update(flatten(np_tree(new.params), pre + "step/params/"))
            # prefill + greedy decode on the serving plans
            greedy(cfg, api, params, jb["tokens"], mesh, pre)
            # the compressed data-parallel step over "data"
            copt = make_optimizer("adamw", **MESH_COMPRESS_OPT)
            crt = dataclasses.replace(base.runtime(mesh), mesh=None)

            def first(p, r, b):
                (loss, _), g = jax.value_and_grad(
                    lambda p, b: api.loss(p, b, crt), has_aux=True)(p, b)
                pair = jax.tree.map(
                    lambda g, r: compressed_psum(g, "data", r, 2), g, r)
                mean = jax.tree.map(lambda t: t[0], pair,
                                    is_leaf=lambda x: isinstance(x, tuple))
                res = jax.tree.map(lambda t: t[1][None], pair,
                                   is_leaf=lambda x: isinstance(x, tuple))
                sc = jax.tree.map(lambda g, r: lax.pmax(jnp.max(jnp.abs(
                    g.astype(jnp.float32) + r)), "data") / 127.0 + 1e-30,
                    g, r)
                return mean, res, sc, lax.pmean(loss, "data")
            res0 = init_residuals(params)
            mean, res, sc, _ = jax.jit(shard_map(
                first, mesh=mesh, in_specs=(P(), P(), P("data")),
                out_specs=(P(), P("data"), P(), P()), check_vma=False))(
                params, res0, jb)
            out.update(flatten(np_tree(mean), pre + "compress/grads/"))
            out.update(flatten(np_tree(sc), pre + "compress/scales/"))
            for s in range(2):
                out.update(flatten(np_tree(jax.tree.map(lambda a: a[s],
                                                        res)),
                                   f"{pre}compress/residuals/{s}/"))
            step = make_compressed_train_step(api, base.runtime(mesh), copt,
                                              axis="data", n_shards=2)
            jstep = jax.jit(shard_map(
                step, mesh=mesh, in_specs=(P(), P(), P("data")),
                out_specs=(P(), P(), P()), check_vma=False))
            mine = jax.tree.map(jnp.copy, params)
            state = TrainState(params=mine, opt=copt.init(mine),
                               step=jnp.zeros((), jnp.int32))
            residuals = init_residuals(mine)
            losses = []
            for i in range(MESH_COMPRESS_STEPS):
                nb = synth_batch(cfg, shape, i)
                out.update({f"{pre}compress/batch/{i}/{k}": v
                            for k, v in nb.items()})
                b = {k: jnp.asarray(v) for k, v in nb.items()}
                state, residuals, met = jstep(state, residuals, b)
                losses.append(float(met["loss"]))
            out[pre + "compress/losses"] = np.asarray(losses, np.float32)
            if cfg.n_experts:
                x = jnp.asarray(mesh_moe_input(cfg))
                lp = jax.tree.map(lambda a: a[0], params["layers"]["moe"])
                for impl, f in (("ep", M.moe_ep), ("ep_a2a", M.moe_ep_a2a)):
                    y, aux = jax.jit(lambda p, x: f(
                        p, x, cfg, mesh, ep_axis="model",
                        dp_axes=("data",)))(lp, x)
                    out[f"{pre}moe/{impl}/y"] = np.asarray(y, np.float32)
                    out[f"{pre}moe/{impl}/aux"] = np.asarray(aux,
                                                             np.float32)
                out[pre + "moe/x"] = np.asarray(x)
    if part != "odd":
        return out
    # heads that do not divide the model axis, on a 1 x 4 mesh: the
    # reduced Llama's batch, each case's own params (odd/<case>/init/)
    mesh14 = make_mesh_spec(1, 4)
    arch = next(iter(MESH_ARCHS))
    jb = {k: jnp.asarray(v) for k, v in synth_batch(
        family_cfg(get_config, arch, {}), shape, 0).items()}
    for case, ov in MESH_ODD_HEADS.items():
        cfg = family_cfg(get_config, arch, ov)
        api = get_model(cfg)
        params = api.init(jax.random.key(0))
        out.update(flatten(np_tree(params), f"odd/{case}/init/"))
        pre = f"odd/{case}/mesh/"
        with mesh14:
            greedy(cfg, api, params, jb["tokens"], mesh14, pre)
            loss_grads(api, params, jb, dataclasses.replace(
                PL.default_plan(cfg, shape, mesh14), attn_mode="chunked"),
                mesh14, pre)
    return out


if __name__ == "__main__" and "--mesh-inner" in __import__("sys").argv:
    import sys
    i = sys.argv.index("--mesh-inner")
    np.savez(sys.argv[i + 1], **_mesh_golden_inner(sys.argv[i + 2]))
elif __name__ == "__main__":
    os.makedirs(DATA, exist_ok=True)
    np.savez_compressed(GOLDEN, **compute_golden())
    print(f"wrote {GOLDEN} ({os.path.getsize(GOLDEN)} bytes)")
    np.savez_compressed(GOLDEN_LM, **compute_golden_lm())
    print(f"wrote {GOLDEN_LM} ({os.path.getsize(GOLDEN_LM)} bytes)")
    families = {}
    for arch in FAMILY_ARCHS:
        families.update(compute_golden_lm_family(arch))
    np.savez_compressed(GOLDEN_LM_FAMILIES, **families)
    print(f"wrote {GOLDEN_LM_FAMILIES} "
          f"({os.path.getsize(GOLDEN_LM_FAMILIES)} bytes)")
    np.savez_compressed(GOLDEN_DSE, **compute_golden_dse())
    print(f"wrote {GOLDEN_DSE} ({os.path.getsize(GOLDEN_DSE)} bytes)")
    np.savez_compressed(GOLDEN_SCHEDULE, **compute_golden_schedule())
    print(f"wrote {GOLDEN_SCHEDULE} "
          f"({os.path.getsize(GOLDEN_SCHEDULE)} bytes)")
    np.savez_compressed(GOLDEN_MULTINET, **compute_golden_multinet())
    print(f"wrote {GOLDEN_MULTINET} "
          f"({os.path.getsize(GOLDEN_MULTINET)} bytes)")
    np.savez_compressed(GOLDEN_ISLANDS, **compute_golden_islands())
    print(f"wrote {GOLDEN_ISLANDS} "
          f"({os.path.getsize(GOLDEN_ISLANDS)} bytes)")
    np.savez_compressed(GOLDEN_TRAIN, **compute_golden_train())
    print(f"wrote {GOLDEN_TRAIN} ({os.path.getsize(GOLDEN_TRAIN)} bytes)")
    np.savez_compressed(GOLDEN_MESH, **compute_golden_mesh())
    print(f"wrote {GOLDEN_MESH} ({os.path.getsize(GOLDEN_MESH)} bytes)")
    np.savez_compressed(GOLDEN_MESH_FAMILIES,
                        **compute_golden_mesh_families())
    print(f"wrote {GOLDEN_MESH_FAMILIES} "
          f"({os.path.getsize(GOLDEN_MESH_FAMILIES)} bytes)")
