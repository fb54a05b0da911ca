"""Thin NDJSON/TCP client for :class:`repro_torch.serve.server.EvalServer`.

The port of the JAX package's ``serve/client.py``; the wire is the same,
so it also talks to the JAX package's server.  One socket, one background
reader thread: requests are written as JSON lines with a client-assigned
``id``, responses are matched back to their
:class:`~concurrent.futures.Future` by that id, so a client can pipeline
many requests (``request_async``) and the server's out-of-order
completions resolve the right futures.  Wire errors re-raise as
:class:`EvalError` with the server's taxonomy code, so remote callers
branch on ``err.code`` exactly like local ones.

>>> with ServeClient(host, port) as cli:
...     cli.ping()
...     cli.evaluate("{L1-Last:CE1-CE4}", "resnet50", board="zc706")
...     cli.explore("mobilenetv2", n=512, strategy="random")
"""
from __future__ import annotations

import itertools
import json
import socket
import threading
from concurrent.futures import Future
from concurrent.futures import TimeoutError as FutureTimeout

from ..core.resilience import EvalError
from .server import ENCODING

#: default wall-clock wait of the blocking ``request`` helper, seconds
DEFAULT_TIMEOUT_S = 600.0


class ServeClient:
    """Client for one :class:`EvalServer`; thread-safe, pipelining."""

    def __init__(self, host: str, port: int, *,
                 timeout_s: float = DEFAULT_TIMEOUT_S):
        self.timeout_s = timeout_s
        self._sock = socket.create_connection((host, port))
        self._wlock = threading.Lock()
        self._plock = threading.Lock()
        self._pending: dict[int, Future] = {}
        self._ids = itertools.count(1)
        self._closed = False
        self._reader = threading.Thread(
            target=self._read_loop, name="repro-torch-serve-client",
            daemon=True)
        self._reader.start()

    # ---- plumbing --------------------------------------------------------
    def request_async(self, op: str, **params) -> Future:
        """Send one request; the future resolves to the response's
        ``result`` or raises the reconstructed :class:`EvalError`."""
        rid = next(self._ids)
        fut: Future = Future()
        with self._plock:
            if self._closed:
                raise ConnectionError("client closed")
            self._pending[rid] = fut
        line = (json.dumps({"id": rid, "op": op, **params}) + "\n") \
            .encode(ENCODING)
        try:
            with self._wlock:
                self._sock.sendall(line)
        except OSError as e:
            with self._plock:
                self._pending.pop(rid, None)
            raise ConnectionError(f"send failed: {e}") from e
        return fut

    def request(self, op: str, *, timeout_s: float | None = None,
                **params):
        """Blocking :meth:`request_async`.

        ``timeout_s`` (or the client default) is a CLIENT-side deadline:
        when it passes the call raises ``EvalError(DEADLINE_EXCEEDED)``
        locally (the same taxonomy code the server uses for its own
        expired deadlines, so callers branch one way) and the request id
        is abandoned (a late server response is dropped by ``_dispatch``,
        never delivered to a caller that already gave up).
        """
        fut = self.request_async(op, **params)
        wait = self.timeout_s if timeout_s is None else timeout_s
        try:
            return fut.result(timeout=wait)
        except FutureTimeout:
            with self._plock:                  # abandon the id
                self._pending = {k: v for k, v in self._pending.items()
                                 if v is not fut}
            raise EvalError(
                EvalError.DEADLINE_EXCEEDED,
                f"no response to {op!r} within {wait}s "
                "(client-side deadline)") from None

    def _read_loop(self) -> None:
        buf = b""
        err: Exception = ConnectionError("server closed the connection")
        try:
            while True:
                data = self._sock.recv(65536)
                if not data:
                    break
                buf += data
                while b"\n" in buf:
                    line, buf = buf.split(b"\n", 1)
                    if line.strip():
                        self._dispatch(json.loads(line.decode(ENCODING)))
        except OSError as e:
            if not self._closed:
                err = ConnectionError(f"connection lost: {e}")
        finally:
            with self._plock:
                pending = list(self._pending.values())
                self._pending.clear()
            for fut in pending:     # never leave a caller hanging
                fut.set_exception(err)

    def _dispatch(self, msg: dict) -> None:
        with self._plock:
            fut = self._pending.pop(msg.get("id"), None)
        if fut is None:
            return                  # unsolicited / already-abandoned id
        if msg.get("ok"):
            fut.set_result(msg.get("result"))
            return
        e = msg.get("error") or {}
        code, detail = e.get("code"), e.get("message", "server error")
        fut.set_exception(
            EvalError(code, detail) if code in EvalError.CODES
            else ConnectionError(f"[{code}] {detail}"))

    def close(self) -> None:
        self._closed = True
        try:
            self._sock.shutdown(socket.SHUT_RDWR)
        except OSError:
            pass
        self._sock.close()
        self._reader.join(timeout=5.0)

    def __enter__(self) -> "ServeClient":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    # ---- convenience ops -------------------------------------------------
    def ping(self) -> dict:
        return self.request("ping")

    def observability(self) -> dict:
        return self.request("observability")

    def shutdown(self, drain: bool = True) -> dict:
        return self.request("shutdown", drain=drain)

    def evaluate(self, designs, net: str, *, board: str | None = None,
                 **kw):
        """Evaluate notation design(s) of CNN ``net``; a single string
        returns ``{metric: float}``, a list returns ``{metric: [...]}``.
        Extra keywords (``priority``, ``deadline_s``) ride through."""
        return self.request("evaluate", designs=designs, net=net,
                            board=board, **kw)

    def evaluate_async(self, designs, net: str, *,
                       board: str | None = None, **kw) -> Future:
        return self.request_async("evaluate", designs=designs, net=net,
                                  board=board, **kw)

    def explore(self, net: str, n: int = 4096, *,
                board: str | None = None, **kw) -> dict:
        """Single-model DSE on the server's batch lane; returns the
        Pareto-front summary (``server.summarize_search``)."""
        return self.request("explore", net=net, n=n, board=board, **kw)

    def deploy(self, nets, n: int = 512, *, board: str | None = None,
               **kw) -> dict:
        """Multi-CNN co-scheduling DSE; ``nets`` is a list of CNN names."""
        return self.request("deploy", nets=list(nets), n=n, board=board,
                            **kw)
