"""The serving front: MCCM evaluation over a socket.

The port of the JAX package's ``serve/server.py``, bound to the port's
:class:`repro_torch.core.session.Session`: the same wire, ops, parameters
and error codes, so either package's :class:`ServeClient` talks to either
server.

One :class:`EvalServer` wraps one ``Session`` and speaks newline-delimited
JSON (NDJSON) over TCP.  Every request is one JSON object on one line::

    {"id": 7, "op": "evaluate", "net": "resnet50",
     "designs": ["{L1-Last:CE1-CE4}"], "board": "zc706"}

and every response echoes the id::

    {"id": 7, "ok": true, "result": {"latency_s": [...], ...}}
    {"id": 7, "ok": false,
     "error": {"code": "INVALID_INPUT", "message": "..."}}

Ops: ``ping``, ``evaluate``, ``explore``, ``deploy``, ``observability``,
``shutdown``.  Everything routes through ``Session.submit`` /
``Session.submit_search``: evaluations ride the interactive lane and
coalesce into shared megabatch chunks across connections (one
search-kernel launch a chunk on the card), long DSE jobs ride the batch
lane's worker thread, so a point probe is never starved by a 100k-budget
search.

Failure semantics mirror the session's :class:`EvalError` taxonomy: the
wire error object carries the taxonomy ``code`` verbatim
(``INVALID_INPUT`` for malformed JSON / unknown ops / unknown nets,
``DEADLINE_EXCEEDED`` / ``QUEUE_FULL`` straight from the session, and
``BACKEND_FAULT`` for a kernel fault, never a plain-version result), so a
remote caller branches exactly like a local one.  A malformed line fails
only that line: the connection stays usable.

Responses are written from whichever thread completes the future (the
session's drain thread, its job worker, or the reader itself) under a
per-connection write lock, so pipelined requests may complete out of
order: the id is the correlation key, never arrival order.  The drain
thread is also the one that launches the kernels, so a reply's encoding
and ``sendall`` run between its megabatches.
"""
from __future__ import annotations

import json
import socket
import threading

import numpy as np
import torch

from ..cnn.registry import get_cnn
from ..core.resilience import EvalError, wrap
from ..core.session import PRIORITIES, Session
from ..core.workload import Network
from ..fpga.boards import get_board

#: every operation the wire accepts
OPS = ("ping", "evaluate", "explore", "deploy", "observability",
       "shutdown")
#: newline-delimited JSON; one request or response object per line
ENCODING = "utf-8"


def jsonify(obj):
    """Recursively convert ``obj`` to JSON-encodable types: tensors and
    numpy arrays become lists, numpy scalars become Python numbers, tuples
    become lists.  Anything else non-encodable is left for ``json.dumps``
    to reject (better a loud server error than a silent drop)."""
    if isinstance(obj, dict):
        return {str(k): jsonify(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return [jsonify(v) for v in obj]
    if isinstance(obj, torch.Tensor):
        return obj.detach().cpu().tolist()
    if isinstance(obj, np.ndarray):
        return obj.tolist()
    if isinstance(obj, np.generic):
        return obj.item()
    return obj


def summarize_search(res) -> dict:
    """The wire form of a DSE result (``DSEResult`` / ``JointDSEResult``):
    the Pareto front plus run counters, NOT the full per-design metric
    arrays: a 100k-design sweep's front fits in one response line, its
    raw archive does not."""
    front = np.asarray(res.front)
    out = {
        "strategy": res.strategy,
        "n_evals": int(res.n_evals),
        "seconds": float(res.seconds),
        "objectives": list(res.objectives),
        "front_size": int(front.size),
        "front": front.tolist(),
        "front_points": res.front_points().tolist(),
        "front_metrics": {k: np.asarray(v)[front].tolist()
                          for k, v in res.metrics.items()},
    }
    if hasattr(res, "per_design_us"):
        out["per_design_us"] = float(res.per_design_us)
    if hasattr(res, "per_eval_us"):
        out["per_eval_us"] = float(res.per_eval_us)
    if hasattr(res, "mode"):
        out["mode"] = res.mode
    return out


def _error_obj(exc: BaseException) -> dict:
    e = exc if isinstance(exc, EvalError) else wrap(exc)
    return {"code": e.code, "message": e.message}


class _Connection:
    """One accepted client socket: a reader thread plus a write lock (the
    drain / job threads complete futures concurrently with the reader)."""

    def __init__(self, server: "EvalServer", sock: socket.socket):
        self.server = server
        self.sock = sock
        self.wlock = threading.Lock()
        self.closed = threading.Event()

    def send(self, obj: dict) -> None:
        data = (json.dumps(obj) + "\n").encode(ENCODING)
        try:
            with self.wlock:
                self.sock.sendall(data)
        except OSError:
            self.closed.set()    # client went away; nothing to deliver to

    def reply(self, rid, result) -> None:
        self.send({"id": rid, "ok": True, "result": jsonify(result)})

    def fail(self, rid, exc: BaseException) -> None:
        self.send({"id": rid, "ok": False, "error": _error_obj(exc)})

    def close(self) -> None:
        self.closed.set()
        try:
            self.sock.shutdown(socket.SHUT_RDWR)
        except OSError:
            pass
        self.sock.close()


class EvalServer:
    """Serve one :class:`Session` over NDJSON/TCP.

    >>> ses = Session(get_board("zc706"))      # on the card
    >>> with EvalServer(ses) as srv:           # binds 127.0.0.1, any port
    ...     host, port = srv.address
    ...     ...                                # point ServeClient at it

    ``port=0`` (the default) binds an ephemeral port: read it back from
    :attr:`address`.  The server owns its sockets and threads but NOT the
    session: ``stop()`` drains in-flight requests and closes connections;
    closing the session is the caller's job (one session can outlive many
    servers, or serve local callers concurrently).
    """

    def __init__(self, session: Session, host: str = "127.0.0.1",
                 port: int = 0, *, default_priority: str = "interactive"):
        if default_priority not in PRIORITIES:
            raise ValueError(f"unknown priority {default_priority!r}; "
                             f"known: {PRIORITIES}")
        self.session = session
        self._host = host
        self._port = port
        self.default_priority = default_priority
        self._lsock: socket.socket | None = None
        self._accept_thread: threading.Thread | None = None
        self._lock = threading.Lock()
        self._conns: set[_Connection] = set()
        self._inflight: set = set()          # futures not yet delivered
        self._idle = threading.Condition(self._lock)
        self._stopping = threading.Event()
        self.requests_served = 0

    # ---- lifecycle -------------------------------------------------------
    def start(self) -> "EvalServer":
        if self._lsock is not None:
            return self
        ls = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        ls.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        ls.bind((self._host, self._port))
        ls.listen(64)
        self._lsock = ls
        self._accept_thread = threading.Thread(
            target=self._accept_loop, name="repro-torch-serve-accept",
            daemon=True)
        self._accept_thread.start()
        return self

    @property
    def address(self) -> tuple[str, int]:
        """``(host, port)`` actually bound (resolves ``port=0``)."""
        if self._lsock is None:
            raise RuntimeError("server not started; call start() first")
        addr = self._lsock.getsockname()
        return addr[0], addr[1]

    def stop(self, drain: bool = True, timeout: float = 60.0) -> None:
        """Stop accepting, optionally wait for in-flight requests to
        deliver their responses (graceful), then close every connection.
        Idempotent; does NOT close the session."""
        self._stopping.set()
        ls, self._lsock = self._lsock, None
        if ls is not None:
            try:
                # shutdown() wakes the thread blocked in accept();
                # close() alone leaves the listener alive in the kernel
                # until the next connection arrives
                ls.shutdown(socket.SHUT_RDWR)
            except OSError:
                pass
            try:
                ls.close()
            except OSError:
                pass
        if drain:
            with self._idle:
                self._idle.wait_for(lambda: not self._inflight,
                                    timeout=timeout)
        with self._lock:
            conns = list(self._conns)
            self._conns.clear()
        for c in conns:
            c.close()
        t = self._accept_thread
        if t is not None and t is not threading.current_thread():
            t.join(timeout=5.0)

    def __enter__(self) -> "EvalServer":
        return self.start()

    def __exit__(self, *exc) -> None:
        self.stop()

    # ---- accept / read ---------------------------------------------------
    def _accept_loop(self) -> None:
        ls = self._lsock
        while ls is not None and not self._stopping.is_set():
            try:
                sock, _ = ls.accept()
            except OSError:        # listener closed by stop()
                return
            conn = _Connection(self, sock)
            with self._lock:
                if self._stopping.is_set():
                    conn.close()
                    return
                self._conns.add(conn)
            threading.Thread(target=self._read_loop, args=(conn,),
                             name="repro-torch-serve-conn",
                             daemon=True).start()

    def _read_loop(self, conn: _Connection) -> None:
        buf = b""
        try:
            while not conn.closed.is_set():
                data = conn.sock.recv(65536)
                if not data:
                    break
                buf += data
                while b"\n" in buf:
                    line, buf = buf.split(b"\n", 1)
                    if line.strip():
                        self._handle_line(conn, line)
        except OSError:
            pass
        finally:
            conn.closed.set()
            with self._lock:
                self._conns.discard(conn)

    # ---- dispatch --------------------------------------------------------
    def _handle_line(self, conn: _Connection, line: bytes) -> None:
        rid = None
        try:
            try:
                msg = json.loads(line.decode(ENCODING))
            except (UnicodeDecodeError, json.JSONDecodeError) as e:
                raise EvalError(EvalError.INVALID_INPUT,
                                f"malformed request line: {e}") from e
            if not isinstance(msg, dict):
                raise EvalError(EvalError.INVALID_INPUT,
                                "request must be a JSON object")
            rid = msg.get("id")
            op = msg.get("op")
            if op not in OPS:
                raise EvalError(EvalError.INVALID_INPUT,
                                f"unknown op {op!r}; known: {OPS}")
            getattr(self, f"_op_{op}")(conn, rid, msg)
        except BaseException as e:  # noqa: BLE001 — wire error boundary
            conn.fail(rid, e)
            if not isinstance(e, Exception):
                raise

    def _track(self, conn: _Connection, rid, future, on_result) -> None:
        """Register ``future`` as in-flight and deliver its outcome to
        ``conn`` when it resolves, from whatever thread resolves it."""
        with self._lock:
            self._inflight.add(future)

        def done(f) -> None:
            # reply BEFORE leaving the in-flight set: stop(drain=True)
            # closes connections as soon as the set empties, and a
            # drained shutdown must deliver every accepted response
            try:
                try:
                    res = f.result()
                except BaseException as e:  # noqa: BLE001 — wire boundary
                    conn.fail(rid, e)
                    return
                try:
                    conn.reply(rid, on_result(res))
                    self.requests_served += 1
                except BaseException as e:  # noqa: BLE001
                    conn.fail(rid, e)
            finally:
                with self._idle:
                    self._inflight.discard(f)
                    self._idle.notify_all()

        future.add_done_callback(done)

    # ---- ops -------------------------------------------------------------
    @staticmethod
    def _net(msg, key: str = "net") -> Network:
        name = msg.get(key)
        if not isinstance(name, str):
            raise EvalError(EvalError.INVALID_INPUT,
                            f"{key!r} must be a CNN name string, "
                            f"got {name!r}")
        try:
            return get_cnn(name)
        except KeyError as e:
            raise EvalError(EvalError.INVALID_INPUT, str(e)) from e

    @staticmethod
    def _board(msg):
        name = msg.get("board")
        if name is None:
            return None          # session default board
        try:
            return get_board(name)
        except KeyError as e:
            raise EvalError(EvalError.INVALID_INPUT, str(e)) from e

    def _op_ping(self, conn, rid, msg) -> None:
        conn.reply(rid, {"pong": True})

    def _op_observability(self, conn, rid, msg) -> None:
        conn.reply(rid, self.session.observability())

    def _op_shutdown(self, conn, rid, msg) -> None:
        conn.reply(rid, {"stopping": True})
        threading.Thread(target=self.stop,
                         kwargs={"drain": bool(msg.get("drain", True))},
                         name="repro-torch-serve-shutdown",
                         daemon=True).start()

    def _op_evaluate(self, conn, rid, msg) -> None:
        designs = msg.get("designs")
        if isinstance(designs, str):
            designs = [designs]
        if not isinstance(designs, list) or not designs \
                or not all(isinstance(d, str) for d in designs):
            raise EvalError(EvalError.INVALID_INPUT,
                            "'designs' must be a notation string or a "
                            "non-empty list of notation strings")
        scalar = isinstance(msg.get("designs"), str)
        fut = self.session.submit(
            designs[0] if scalar else designs, self._net(msg),
            self._board(msg),
            deadline_s=msg.get("deadline_s"),
            priority=msg.get("priority", self.default_priority))
        self._track(conn, rid, fut, lambda m: m)

    def _op_explore(self, conn, rid, msg) -> None:
        fut = self.session.submit_search(
            self._net(msg), int(msg.get("n", 4096)), self._board(msg),
            deadline_s=msg.get("deadline_s"),
            checkpoint_path=msg.get("checkpoint_path"),
            checkpoint_interval=int(msg.get("checkpoint_interval", 8)),
            **{k: msg[k] for k in ("strategy", "family", "seed", "chunk")
               if k in msg})
        self._track(conn, rid, fut, summarize_search)

    def _op_deploy(self, conn, rid, msg) -> None:
        names = msg.get("nets")
        if not isinstance(names, list) or len(names) < 2:
            raise EvalError(EvalError.INVALID_INPUT,
                            "'nets' must be a list of >= 2 CNN names")
        nets = [self._net({"net": n}) for n in names]
        fut = self.session.submit_search(
            nets, int(msg.get("n", 512)), self._board(msg),
            deadline_s=msg.get("deadline_s"),
            checkpoint_path=msg.get("checkpoint_path"),
            checkpoint_interval=int(msg.get("checkpoint_interval", 8)),
            **{k: msg[k] for k in ("strategy", "seed", "chunk",
                                   "objective", "weights", "slo_s")
               if k in msg})
        self._track(conn, rid, fut, summarize_search)
