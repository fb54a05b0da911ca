"""The system under test: ``repro_torch.Session.evaluate`` on a batch of
designs, with the metrics pulled to the host as a user reads them.

This is the only module of the benchmark that imports the program.
"""
from __future__ import annotations

import time
from contextlib import nullcontext

import numpy as np

#: the program's layer fields that the configuration's layers carry
LAYER_FIELDS = ("name", "kind", "in_ch", "out_ch", "kh", "kw", "stride",
                "ih", "iw", "residual", "padding")
BOARD_FIELDS = ("pes", "on_chip_bytes", "off_chip_gbps", "clock_hz",
                "wordbytes")


def check_inputs(cfg: dict, net, board) -> None:
    """Raise unless the program's network and board are the
    configuration's, field for field: the program and the reference then
    read the same inputs."""
    want = cfg["network"]["layers"]
    got = [{k: getattr(l, k) for k in LAYER_FIELDS} for l in net]
    if len(got) != len(want):
        raise ValueError(f"{cfg['name']}: the program's network has "
                         f"{len(got)} layers, the configuration {len(want)}")
    for i, (g, w) in enumerate(zip(got, want)):
        if g != {k: w[k] for k in LAYER_FIELDS}:
            raise ValueError(f"{cfg['name']}: layer {i} differs: program "
                             f"{g}, configuration {w}")
    for k in BOARD_FIELDS:
        if getattr(board, k) != cfg["board"][k]:
            raise ValueError(f"{cfg['name']}: board {k} is "
                             f"{getattr(board, k)} in the program, "
                             f"{cfg['board'][k]} in the configuration")


class System:
    """A Session on ``device`` with the mix's session settings, for the
    configuration's network and board."""

    def __init__(self, cfg: dict, mix: dict, device: str):
        from repro_torch.api import EvalConfig, Session, get_board, get_cnn
        from repro_torch.core.dse.encoding import DesignBatch
        self.net = get_cnn(cfg["program"]["cnn"])
        self.board = get_board(cfg["program"]["board"])
        check_inputs(cfg, self.net, self.board)
        self.session = Session(self.board, config=EvalConfig(
            device=device, **mix.get("session", {})))
        self._batch = DesignBatch.from_numpy

    def designs(self, arrays: tuple):
        """A user's batch: the host arrays as a DesignBatch on the host."""
        return self._batch(*arrays, device="cpu")

    def call(self, designs, mark=None) -> tuple[dict, float]:
        """One evaluation: returns the metrics as host arrays and the
        seconds spent inside ``evaluate`` (the enqueue; the pull follows).
        ``mark(name)``, when given, opens a named span of the call."""
        t0 = time.perf_counter()
        span = mark or (lambda _: nullcontext())
        with span("bench.evaluate"):
            out = self.session.evaluate(designs, self.net)
        t1 = time.perf_counter()
        with span("bench.pull"):
            host = {k: v.cpu().numpy() for k, v in out.items()}
        return host, t1 - t0

    def close(self) -> None:
        self.session.close()


def well_formed(out: dict, n: int, names) -> bool:
    """Every metric present, ``n`` long and finite."""
    return all(k in out and out[k].shape == (n,)
               and bool(np.isfinite(out[k]).all()) for k in names)
