"""The golden metrics that ``chip_smoke.py`` holds the PyTorch port's main
path against on the card, computed by the JAX package on the CPU.

The machine with the card has no JAX, so the file is committed:
``src/repro_torch/data/golden_mccm.npz``.  Regenerate it after a change to
the JAX package's model with::

    PYTHONPATH=src JAX_PLATFORMS=cpu python tests/torch_golden.py

``tests/test_torch_session.py`` checks that the committed file still equals
what this computes.

Contents: for every CNN x board, the 12 baseline templates (3 archs x
n in {2, 5, 9, 11}) under ``tmpl/<cnn>/<board>/<metric>``, and 256
``sample_mixed`` rows (seed 0) of ResNet-50 on ZCU102 under
``mixed/resnet50/zcu102/<metric>``: the batch path's metrics.  And the
scalar Builder's ``Metrics`` of the same templates under
``scalar/<cnn>/<board>/<field>``, float64: the seven scalar fields of
``SCALAR_FIELDS``, and ``ce_busy_s`` as a (12, 16) array indexed by CE id,
NaN where a design has no such CE.
"""
from __future__ import annotations

import os

import numpy as np

GOLDEN = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), "src", "repro_torch", "data", "golden_mccm.npz")

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


if __name__ == "__main__":
    os.makedirs(os.path.dirname(GOLDEN), exist_ok=True)
    np.savez_compressed(GOLDEN, **compute_golden())
    print(f"wrote {GOLDEN} ({os.path.getsize(GOLDEN)} bytes)")
