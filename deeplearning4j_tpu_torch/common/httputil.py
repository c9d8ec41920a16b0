"""Stdlib HTTP plumbing for the inference server.

Counterpart of ``deeplearning4j_tpu/common/httputil.py`` (a copy, not
an import): the zero-dependency ``ThreadingHTTPServer`` pattern with
silent request logging, explicit Content-Length framing, JSON bodies
and the Prometheus ``/metrics`` page, chunked transfer encoding for
the ``:generate`` token stream (:meth:`QuietHandler.begin_chunks` and
its siblings), plus the zero-copy ``.npy`` codec of the serving path
(:func:`npy_view`, :func:`npy_header`).

Bind host: ``DL4J_TORCH_HTTP_HOST`` (default ``127.0.0.1``).

Access log: ``DL4J_TORCH_ACCESS_LOG=<path>`` appends one JSON line per
completed request to ``path`` (method, path, status, response bytes,
duration and the request's trace id, the join key into the span tree
and the latency exemplars); ``DL4J_TORCH_ACCESS_LOG_SAMPLE`` (default
1.0) keeps every ``1/rate``-th request, counted deterministically
across the process's handlers. A failure to log never breaks a
response.
"""
from __future__ import annotations

import io
import itertools
import json
import os
import sys
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Optional, Sequence, Tuple

import numpy as np

from deeplearning4j_tpu_torch.common import telemetry

#: (path, log every n-th request), read once a process; the telemetry
#: reset hook drops it so tests can flip the environment variables
_access_conf: Optional[Tuple[str, int]] = None


def _access_log_conf() -> Tuple[str, int]:
    global _access_conf
    if _access_conf is None:
        path = os.environ.get("DL4J_TORCH_ACCESS_LOG", "")
        try:
            rate = float(os.environ.get("DL4J_TORCH_ACCESS_LOG_SAMPLE",
                                        "1"))
        except ValueError:
            rate = 1.0
        every = 0 if not path or rate <= 0 else \
            max(1, int(round(1.0 / min(1.0, rate))))
        _access_conf = (path, every)
    return _access_conf


def _reset_access_conf() -> None:
    global _access_conf
    _access_conf = None


telemetry.on_reset(_reset_access_conf)


def npy_view(buf) -> "np.ndarray":
    """An ndarray view over a raw ``.npy`` byte buffer (header parsed
    in place, data not copied). Object dtypes are refused: they would
    need pickle, never read off the network."""
    f = io.BytesIO(buf)
    try:
        version = np.lib.format.read_magic(f)
    except Exception as e:
        raise ValueError(f"not a .npy payload: {e}") from e
    if version == (1, 0):
        shape, fortran, dtype = np.lib.format.read_array_header_1_0(f)
    elif version == (2, 0):
        shape, fortran, dtype = np.lib.format.read_array_header_2_0(f)
    else:
        raise ValueError(f"unsupported .npy version {version}")
    if dtype.hasobject:
        raise ValueError("object-dtype .npy payloads are not served")
    count = 1
    for s in shape:
        count *= int(s)
    a = np.frombuffer(buf, dtype=dtype, count=count, offset=f.tell())
    return a.reshape(shape, order="F" if fortran else "C")


def npy_header(arr: "np.ndarray") -> bytes:
    """The ``.npy`` v1 magic and header that precede ``arr``'s data."""
    f = io.BytesIO()
    np.lib.format.write_array_header_1_0(
        f, np.lib.format.header_data_from_array_1_0(arr))
    return f.getvalue()


def bind_host() -> str:
    return os.environ.get("DL4J_TORCH_HTTP_HOST", "127.0.0.1")


class QuietHandler(BaseHTTPRequestHandler):
    """BaseHTTPRequestHandler without the stderr request log, plus the
    response/body helpers every endpoint needs."""

    daemon_threads = True
    protocol_version = "HTTP/1.1"

    def log_message(self, *args):
        pass

    # -- the sampled access log ------------------------------------------
    #: shared by every handler thread: the deterministic 1-in-N sampler
    _access_seq = itertools.count(1)
    _access_write_lock = threading.Lock()
    #: per-request state, reset in handle_one_request
    _t_req = 0.0
    _resp_status: Optional[int] = None
    _resp_bytes = 0
    #: set by the server or router while handling: the log's trace id
    _trace_id: Optional[str] = None

    def parse_request(self):
        self._t_req = time.monotonic()      # the request line is in
        return super().parse_request()

    def send_response(self, code, message=None):
        if self._resp_status is None:   # the first status is the verdict
            self._resp_status = int(code)
        super().send_response(code, message)

    def handle_one_request(self):
        # a handler serves many keep-alive requests, and the last call of
        # a connection reads no request at all: no status, byte count or
        # trace id may carry over from the previous one
        self._resp_status = None
        self._resp_bytes = 0
        self._trace_id = None
        super().handle_one_request()
        try:
            self._access_log()
        except Exception:       # noqa: BLE001  logging never breaks a
            pass                # response

    def _access_log(self) -> None:
        path, every = _access_log_conf()
        if not every or self._resp_status is None:
            return
        if next(QuietHandler._access_seq) % every:
            return
        line = json.dumps({
            "t": time.time(), "method": self.command, "path": self.path,
            "status": self._resp_status, "bytes": self._resp_bytes,
            "duration_ms": round((time.monotonic() - self._t_req) * 1e3,
                                 3),
            "trace_id": self._trace_id})
        with QuietHandler._access_write_lock:
            with open(path, "a") as f:
                f.write(line + "\n")

    # -- responses ---------------------------------------------------------
    def send_body(self, body: bytes, content_type: str,
                  code: int = 200, headers: Optional[dict] = None):
        self.send_response(code)
        self.send_header("Content-Type", content_type)
        self.send_header("Content-Length", str(len(body)))
        for k, v in (headers or {}).items():
            self.send_header(k, str(v))
        self.end_headers()
        self.wfile.write(body)
        self._resp_bytes += len(body)

    def send_body_parts(self, parts: Sequence, content_type: str,
                        code: int = 200,
                        headers: Optional[dict] = None):
        """Stream byte-like parts with one summed Content-Length and no
        join into an intermediate buffer."""
        views = [memoryview(p).cast("B") for p in parts]
        self.send_response(code)
        self.send_header("Content-Type", content_type)
        self.send_header("Content-Length",
                         str(sum(v.nbytes for v in views)))
        for k, v in (headers or {}).items():
            self.send_header(k, str(v))
        self.end_headers()
        for v in views:
            self.wfile.write(v)
            self._resp_bytes += v.nbytes

    def send_json(self, obj, code: int = 200,
                  headers: Optional[dict] = None):
        self.send_body(json.dumps(obj).encode(), "application/json",
                       code, headers)

    def send_metrics(self):
        self.send_body(
            telemetry.MetricsRegistry.get().render_prometheus().encode(),
            "text/plain; version=0.0.4; charset=utf-8")

    # -- chunked streaming (the :generate token stream) ------------------
    def begin_chunks(self, content_type: str, code: int = 200,
                     headers: Optional[dict] = None):
        """Open a chunked transfer-encoding response: status and headers
        now, the body in :meth:`send_chunk` pieces as they become
        available, closed by :meth:`end_chunks`."""
        self.send_response(code)
        self.send_header("Content-Type", content_type)
        self.send_header("Transfer-Encoding", "chunked")
        for k, v in (headers or {}).items():
            self.send_header(k, str(v))
        self.end_headers()

    def send_chunk(self, data: bytes):
        """One chunk frame (size line + payload), flushed at once so the
        client sees a token the moment it decodes. Raises ``OSError`` on
        a client disconnect: the caller's signal to cancel the stream."""
        if not data:
            return              # a zero-size frame would end the body
        self.wfile.write(b"%X\r\n" % len(data))
        self.wfile.write(data)
        self.wfile.write(b"\r\n")
        self.wfile.flush()
        self._resp_bytes += len(data)

    def end_chunks(self):
        """The terminal zero-length chunk: a well-formed end of body; the
        keep-alive connection stays usable."""
        self.wfile.write(b"0\r\n\r\n")
        self.wfile.flush()

    def abort_chunks(self):
        """End a chunk stream after a mid-stream failure WITHOUT the
        terminal chunk: the client's de-chunker sees a truncated body (a
        prompt protocol error), not a keep-alive connection that hangs.
        The socket closes after the handler returns."""
        self.close_connection = True
        try:
            self.wfile.flush()
        except OSError:
            pass                # the client may already be gone

    def read_body(self) -> bytes:
        n = int(self.headers.get("Content-Length") or 0)
        return self.rfile.read(n) if n > 0 else b""


class _Server(ThreadingHTTPServer):
    #: listen backlog; socketserver's default of 5 resets (or, after a
    #: SYN retry, delays by a second) the connections of a burst of
    #: concurrent clients before a handler thread ever sees them
    request_queue_size = 128

    def handle_error(self, request, client_address):
        # a client that went away (a reset between keep-alive requests,
        # a stream cancelled mid-way) is not a server fault
        if isinstance(sys.exc_info()[1], ConnectionError):
            return
        super().handle_error(request, client_address)


def start_http_server(handler_cls, port: int = 0
                      ) -> Tuple[ThreadingHTTPServer, threading.Thread]:
    """Serve ``handler_cls`` on (bind_host(), port) from a daemon
    thread; port 0 picks a free port."""
    httpd = _Server((bind_host(), port), handler_cls)
    thread = threading.Thread(target=httpd.serve_forever, daemon=True)
    thread.start()
    return httpd, thread
