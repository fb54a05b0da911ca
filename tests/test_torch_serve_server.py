"""The port's serving front (``repro_torch.serve.EvalServer`` /
``ServeClient``) over a real loopback socket, on the CPU.

Every case of the JAX package's ``tests/test_serve_server.py`` runs here on
the port's server and client over a CPU session: round-trips, concurrent
mixed traffic, the EvalError taxonomy on the wire, deadline / queue-full
codes end to end, DSE ops at tiny budgets, interactive-lane latency under
a running batch job, and graceful shutdown that drains in-flight work.

Then the two packages across the wire: the JAX package's client against
the port's server and the port's client against the JAX package's server
on one request script (keys and shapes equal, ``n_ces`` and fronts exact,
floats within rtol 1e-5), and the same error code from both servers for
each bad line.
"""
from __future__ import annotations

import json
import os
import socket
import subprocess
import sys
import threading
import time

import numpy as np
import pytest
import torch

from repro.api import Session as JaxSession
from repro.fpga.boards import get_board as jax_get_board
from repro.serve import EvalServer as JaxEvalServer
from repro.serve import ServeClient as JaxServeClient
from repro.serve import server as jserver
from repro_torch.api import EvalError, Session
from repro_torch.cnn.registry import get_cnn
from repro_torch.fpga.boards import get_board
from repro_torch.serve import EvalServer, ServeClient
from repro_torch.serve import server as tserver

NET = "mobilenetv2"
BOARD = "zc706"
SPEC = "{L1-Last:CE1-CE4}"
RTOL = 1e-5
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _session(**kw) -> Session:
    return Session(get_board(BOARD), device="cpu", **kw)


@pytest.fixture(scope="module")
def served():
    """One warmed CPU session + server shared by the whole module."""
    ses = _session(linger_s=0.005)
    ses.evaluate([SPEC], get_cnn(NET))       # warm tables
    with EvalServer(ses) as srv:
        yield srv
    ses.close()


@pytest.fixture(scope="module")
def jax_served():
    """The JAX package's server on a warmed session, for the cross-wire
    cases."""
    from repro.cnn.registry import get_cnn as jax_get_cnn
    ses = JaxSession(jax_get_board(BOARD), linger_s=0.005)
    ses.evaluate([SPEC], jax_get_cnn(NET))
    with JaxEvalServer(ses) as srv:
        yield srv
    ses.close()


def _client(srv) -> ServeClient:
    return ServeClient(*srv.address)


# --------------------------------------------------------------------------
# round-trips
# --------------------------------------------------------------------------
def test_ping_and_scalar_roundtrip(served):
    with _client(served) as cli:
        assert cli.ping() == {"pong": True}
        m = cli.evaluate(SPEC, NET)
        want = served.session.evaluate(SPEC, get_cnn(NET))
        assert m["latency_s"] == pytest.approx(want.latency_s)
        # the reply is the batch path's f32 value, exactly
        batch = served.session.evaluate([SPEC], get_cnn(NET))
        assert {k: m[k] for k in batch} == {k: float(v[0])
                                            for k, v in batch.items()}


def test_list_roundtrip_bit_identical(served):
    specs = [SPEC, "{L1-Last:CE1-CE2}", "{L1-L4:CE1, L5-Last:CE2}"]
    with _client(served) as cli:
        out = cli.evaluate(specs, NET, board=BOARD)
    want = served.session.evaluate(specs, get_cnn(NET))
    for k, v in want.items():
        np.testing.assert_array_equal(np.asarray(out[k], v.dtype),
                                      np.asarray(v))


def test_observability_over_wire(served):
    with _client(served) as cli:
        obs = cli.observability()
    assert {"compile", "stats", "caches", "breaker"} <= obs.keys()
    assert obs["caches"]["net_tables"]["size"] >= 1


def test_pipelined_out_of_order_completion(served):
    """Many async requests on one connection resolve to the right
    futures regardless of server completion order."""
    with _client(served) as cli:
        futs = {i: cli.evaluate_async([f"{{L1-Last:CE1-CE{1 + i % 6}}}"],
                                      NET)
                for i in range(12)}
        for i, f in futs.items():
            want = served.session.evaluate(
                [f"{{L1-Last:CE1-CE{1 + i % 6}}}"], get_cnn(NET))
            got = f.result(timeout=300)
            np.testing.assert_array_equal(
                np.asarray(got["latency_s"], np.float32),
                np.asarray(want["latency_s"]))


def test_concurrent_mixed_traffic_hammer(served):
    """Several client connections at once, mixed scalar/list and
    interactive/batch: every reply correct, none dropped."""
    errors: list = []

    def worker(seed: int) -> None:
        try:
            with _client(served) as cli:
                for j in range(4):
                    k = 1 + (seed + j) % 6
                    spec = f"{{L1-Last:CE1-CE{k}}}"
                    out = cli.evaluate(
                        [spec], NET,
                        priority="batch" if j % 2 else "interactive")
                    want = served.session.evaluate([spec], get_cnn(NET))
                    np.testing.assert_array_equal(
                        np.asarray(out["latency_s"], np.float32),
                        np.asarray(want["latency_s"]))
        except Exception as e:  # noqa: BLE001 — collected for the assert
            errors.append(e)

    threads = [threading.Thread(target=worker, args=(i,))
               for i in range(6)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=300)
    assert not any(t.is_alive() for t in threads)
    assert errors == []


# --------------------------------------------------------------------------
# the taxonomy on the wire
# --------------------------------------------------------------------------
def test_malformed_line_fails_only_that_line(served):
    """Raw socket: garbage JSON gets an INVALID_INPUT error envelope and
    the connection stays usable for the next request."""
    host, port = served.address
    with socket.create_connection((host, port)) as s:
        f = s.makefile("rw", encoding="utf-8")
        f.write("this is not json\n")
        f.flush()
        err = json.loads(f.readline())
        assert err["ok"] is False
        assert err["error"]["code"] == EvalError.INVALID_INPUT
        f.write(json.dumps({"id": 1, "op": "ping"}) + "\n")
        f.flush()
        ok = json.loads(f.readline())
        assert ok == {"id": 1, "ok": True, "result": {"pong": True}}


@pytest.mark.parametrize("msg", [
    {"op": "warp_drive"},                       # unknown op
    {"op": "evaluate", "designs": [SPEC], "net": "nope"},
    {"op": "evaluate", "designs": [], "net": NET},
    {"op": "evaluate", "designs": ["{not notation"], "net": NET},
    {"op": "evaluate", "designs": [SPEC], "net": NET, "board": "nope"},
    {"op": "deploy", "nets": [NET], "n": 8},    # needs >= 2 nets
    {"op": "evaluate", "designs": [SPEC], "net": NET,
     "priority": "vip"},
])
def test_invalid_requests_return_invalid_input(served, msg):
    msg = dict(msg)
    with _client(served) as cli:
        with pytest.raises(EvalError) as ei:
            cli.request(msg.pop("op"), **msg)
        assert ei.value.code == EvalError.INVALID_INPUT


def test_deadline_exceeded_over_wire():
    """A deadline shorter than the linger window comes back as a wire
    DEADLINE_EXCEEDED, reconstructed as EvalError client-side."""
    ses = _session(linger_s=0.5)
    with EvalServer(ses) as srv, _client(srv) as cli:
        with pytest.raises(EvalError) as ei:
            cli.evaluate(SPEC, NET, deadline_s=0.01)
        assert ei.value.code == EvalError.DEADLINE_EXCEEDED
    ses.close()


def test_client_side_timeout_raises_deadline_exceeded():
    """A client-side timeout (server still lingering, no reply yet)
    surfaces as the SAME taxonomy code as a server-expired deadline and
    abandons the request id, so the late server reply is dropped instead
    of leaking a pending future."""
    ses = _session(linger_s=0.5)
    with EvalServer(ses) as srv, _client(srv) as cli:
        with pytest.raises(EvalError) as ei:
            cli.evaluate(SPEC, NET, timeout_s=0.01)
        assert ei.value.code == EvalError.DEADLINE_EXCEEDED
        with cli._plock:
            assert not cli._pending          # id abandoned, not leaked
        # the connection stays usable: the next (patient) request lands
        m = cli.evaluate(SPEC, NET, timeout_s=300.0)
        assert np.isfinite(m["latency_s"])
    ses.close()


def test_queue_full_over_wire():
    """Admission control crosses the wire: with max_queue=1 and a long
    linger, the second concurrent request is refused as QUEUE_FULL."""
    ses = _session(linger_s=1.0, max_queue=1)
    with EvalServer(ses) as srv, _client(srv) as cli:
        first = cli.evaluate_async(SPEC, NET)     # parks in the queue
        time.sleep(0.1)
        with pytest.raises(EvalError) as ei:
            cli.evaluate(SPEC, NET)
        assert ei.value.code == EvalError.QUEUE_FULL
        first.result(timeout=300)                 # still delivered
    ses.close()


# --------------------------------------------------------------------------
# DSE over the wire, and lane isolation
# --------------------------------------------------------------------------
def test_explore_over_wire_matches_local(served):
    with _client(served) as cli:
        r = cli.explore(NET, n=128, strategy="random", seed=5)
    local = served.session.explore(get_cnn(NET), 128, strategy="random",
                                   seed=5)
    assert r["n_evals"] == local.n_evals == 128
    assert r["front"] == local.front.tolist()
    np.testing.assert_allclose(np.asarray(r["front_points"]),
                               local.front_points())
    want = tserver.summarize_search(local)
    assert {k: v for k, v in r.items() if k not in ("seconds",
                                                    "per_design_us")} \
        == {k: v for k, v in want.items() if k not in ("seconds",
                                                       "per_design_us")}


def test_deploy_over_wire(served):
    with _client(served) as cli:
        r = cli.deploy([NET, "resnet50"], n=48, seed=2)
    assert r["n_evals"] > 0
    assert r["front_size"] >= 1
    assert set(r["front_metrics"]) >= {"makespan_s"} \
        or len(r["front_metrics"]) > 0


def test_interactive_not_starved_by_batch_job(served):
    """An interactive probe lands within its deadline while an explore
    job holds the batch lane."""
    with _client(served) as cli:
        job = cli.request_async("explore", net=NET, n=2048,
                                strategy="random", seed=0)
        t0 = time.monotonic()
        cli.evaluate(SPEC, NET, deadline_s=30.0, priority="interactive")
        assert time.monotonic() - t0 < 30.0
        assert job.result(timeout=600)["n_evals"] == 2048


def test_server_bounded_under_key_churn():
    """The whole zoo (> 2x the table bound in distinct nets) through the
    wire: live tables never exceed the bound, evictions surface in the
    wire observability, answers stay correct."""
    from repro_torch.cnn.registry import CNN_NAMES

    ses = _session(linger_s=0.005, max_cached_tables=2)
    with EvalServer(ses) as srv, _client(srv) as cli:
        for name in CNN_NAMES:
            out = cli.evaluate([SPEC], name)
            want = ses.evaluate([SPEC], get_cnn(name))
            np.testing.assert_array_equal(
                np.asarray(out["latency_s"], np.float32),
                np.asarray(want["latency_s"]))
        caches = cli.observability()["caches"]
    assert caches["net_tables"]["size"] <= 2
    assert caches["net_tables"]["evictions"] >= len(CNN_NAMES) - 2
    ses.close()


# --------------------------------------------------------------------------
# lifecycle
# --------------------------------------------------------------------------
def test_graceful_shutdown_drains_inflight():
    """stop(drain=True) (the shutdown op) delivers every accepted
    response before closing the sockets."""
    ses = _session(linger_s=0.3)
    ses.evaluate([SPEC], get_cnn(NET))
    srv = EvalServer(ses).start()
    addr = srv.address
    with _client(srv) as cli:
        fut = cli.evaluate_async(SPEC, NET)    # parked in the linger
        time.sleep(0.05)
        cli.shutdown(drain=True)
        out = fut.result(timeout=300)          # delivered, not dropped
        assert np.isfinite(out["latency_s"])
    # the listener is gone
    time.sleep(0.3)                            # shutdown thread finishes
    with pytest.raises(OSError):
        socket.create_connection(addr, timeout=0.5)
    srv.stop()                                 # idempotent
    ses.close()


def test_stop_is_idempotent_and_session_survives():
    ses = _session(linger_s=0.005)
    srv = EvalServer(ses).start()
    srv.stop()
    srv.stop()
    # the server never owns the session
    m = ses.evaluate(SPEC, get_cnn(NET))
    assert np.isfinite(m.latency_s)
    ses.close()


# --------------------------------------------------------------------------
# the two packages across the wire
# --------------------------------------------------------------------------
#: one request script: every op that returns a result (shutdown aside)
SCRIPT = (
    ("ping", {}),
    ("evaluate", {"designs": SPEC, "net": NET}),
    ("evaluate", {"designs": [SPEC, "{L1-Last:CE1-CE2}",
                              "{L1-L4:CE1, L5-Last:CE2}"],
                  "net": "resnet50", "board": "zcu102"}),
    ("explore", {"net": NET, "n": 96, "strategy": "random", "seed": 5,
                 "chunk": 32}),
    ("explore", {"net": NET, "n": 64, "strategy": "search", "seed": 3}),
    ("deploy", {"nets": [NET, "resnet50"], "n": 32, "seed": 2}),
)
#: the run counters of a summary: host-clock values, not compared
CLOCKS = ("seconds", "per_design_us", "per_eval_us")


def _assert_same_reply(got, want, path: str = "") -> None:
    """Keys and shapes equal, integers (``n_ces``, fronts, counts) exact,
    floats within RTOL."""
    if isinstance(want, dict):
        assert isinstance(got, dict) and got.keys() == want.keys(), path
        for k in want:
            if k not in CLOCKS:
                _assert_same_reply(got[k], want[k], f"{path}/{k}")
        return
    if isinstance(want, list) or isinstance(want, float):
        g, w = np.asarray(got), np.asarray(want)
        assert g.shape == w.shape, path
        if w.dtype.kind == "f" and not path.endswith("/n_ces"):
            np.testing.assert_allclose(g, w, rtol=RTOL, err_msg=path)
        else:
            np.testing.assert_array_equal(g, w, err_msg=path)
        return
    assert got == want, path


def test_cross_wire_script_gives_the_same_replies(served, jax_served):
    """repro's client against the port's server, the port's client
    against repro's server: one script, the same replies."""
    with JaxServeClient(*served.address) as jc, \
            ServeClient(*jax_served.address) as tc:
        for op, params in SCRIPT:
            from_port = jc.request(op, **params)
            from_jax = tc.request(op, **params)
            _assert_same_reply(from_port, from_jax, op)
            if op in ("explore", "deploy"):
                assert from_port["front"] == from_jax["front"]
                assert from_port["front_size"] >= 1


#: one bad line per way a request fails validation: malformed JSON, a
#: line that is not an object, an unknown op, net and board, empty or
#: non-string designs, fewer than 2 nets, a non-integer n
BAD_LINES = {
    "malformed": b"{this is not json",
    "not_object": b"[1, 2, 3]",
    "unknown_op": json.dumps({"id": 1, "op": "warp_drive"}).encode(),
    "unknown_net": json.dumps({"id": 1, "op": "evaluate",
                               "designs": [SPEC], "net": "nope"}).encode(),
    "unknown_board": json.dumps({"id": 1, "op": "evaluate",
                                 "designs": [SPEC], "net": NET,
                                 "board": "nope"}).encode(),
    "designs_empty": json.dumps({"id": 1, "op": "evaluate", "designs": [],
                                 "net": NET}).encode(),
    "designs_not_strings": json.dumps({"id": 1, "op": "evaluate",
                                       "designs": [SPEC, 7],
                                       "net": NET}).encode(),
    "one_net": json.dumps({"id": 1, "op": "deploy", "nets": [NET],
                           "n": 8}).encode(),
    "n_not_integer": json.dumps({"id": 1, "op": "explore", "net": NET,
                                 "n": "many"}).encode(),
}


def _raw_reply(srv, line: bytes) -> dict:
    with socket.create_connection(srv.address, timeout=60) as s:
        s.sendall(line + b"\n")
        f = s.makefile("r", encoding="utf-8")
        return json.loads(f.readline())


@pytest.mark.parametrize("name", sorted(BAD_LINES))
def test_bad_line_gives_the_same_code_from_both_servers(served, jax_served,
                                                        name):
    got = _raw_reply(served, BAD_LINES[name])
    want = _raw_reply(jax_served, BAD_LINES[name])
    assert got["ok"] is False and want["ok"] is False
    assert got["id"] == want["id"]
    assert got["error"]["code"] == want["error"]["code"] \
        == EvalError.INVALID_INPUT


# --------------------------------------------------------------------------
# units: jsonify, summarize_search, the import boundary
# --------------------------------------------------------------------------
def test_jsonify_converts_tensors_and_numpy():
    obj = {1: torch.tensor([1.5, 2.0]), "a": (np.float32(0.25),
                                             np.arange(3)),
           "t": torch.tensor(3, dtype=torch.int32),
           "n": [np.int64(4), {"x": np.array([[1.0]])}], "s": "keep"}
    out = tserver.jsonify(obj)
    assert out == {"1": [1.5, 2.0], "a": [0.25, [0, 1, 2]], "t": 3,
                   "n": [4, {"x": [[1.0]]}], "s": "keep"}
    assert json.loads(json.dumps(out)) == out
    # f32 round-trips JSON exactly through Python floats
    v = np.float32(1) / np.float32(3)
    assert np.float32(json.loads(json.dumps(tserver.jsonify(v)))) == v
    # anything else JSON cannot encode still fails loudly
    with pytest.raises(TypeError):
        json.dumps(tserver.jsonify({"x": object()}))
    # without tensors, the JAX package's jsonify
    plain = {k: v for k, v in obj.items() if k not in (1, "t")}
    assert tserver.jsonify(plain) == jserver.jsonify(plain)


def test_summarize_search_on_both_result_kinds(served):
    ses = served.session
    res = ses.explore(get_cnn(NET), 64, strategy="random", seed=1)
    joint = ses.deploy([get_cnn(NET), get_cnn("resnet50")], 32, seed=2)
    for r in (res, joint):
        got = tserver.summarize_search(r)
        assert got == jserver.summarize_search(r)
        assert got["front"] == np.asarray(r.front).tolist()
        assert got["n_evals"] == r.n_evals
        json.dumps(got)
    assert "per_design_us" in tserver.summarize_search(res)
    assert tserver.summarize_search(joint)["mode"] == joint.mode


def _run(code: str) -> subprocess.CompletedProcess:
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"))
    return subprocess.run([sys.executable, "-c", code], env=env, cwd=REPO,
                          capture_output=True, text=True, timeout=120)


def test_server_import_leaves_models_and_jax_out():
    """Importing EvalServer/ServeClient pulls neither the LM model stack
    nor jax nor the JAX package; importing ServeEngine not the server."""
    code = (
        "import sys\n"
        "import repro_torch.serve as s\n"
        "s.EvalServer, s.ServeClient\n"
        "bad = [m for m in sys.modules if m in ('jax', 'repro') or "
        "m.startswith(('jax.', 'repro.', 'repro_torch.models'))]\n"
        "assert not bad, bad\n"
        "assert 'repro_torch.serve.server' in sys.modules\n"
        "assert 'repro_torch.serve.engine' not in sys.modules\n")
    out = _run(code)
    assert out.returncode == 0, out.stderr
    code = ("import sys\n"
            "from repro_torch.serve import ServeEngine\n"
            "assert 'repro_torch.serve.server' not in sys.modules\n")
    out = _run(code)
    assert out.returncode == 0, out.stderr
