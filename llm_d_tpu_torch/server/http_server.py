"""A small HTTP/1.1 server on asyncio streams, standard library only.

It serves what the port's OpenAI server needs, with the wire behaviour
of the aiohttp application the JAX package runs: a request line, headers
and a ``Content-Length`` body; persistent connections;
replies with a ``Content-Length`` body; and streamed replies in chunked
transfer encoding (server-sent events).  Unknown paths get 404, a known
path with another method 405, a handler that raises 500.

A handler is ``async def handler(request) -> Response``; a streaming
handler calls ``await request.stream(headers)``, writes through the
returned ``StreamResponse`` and returns it.  When the client closes its
connection while a handler runs, the handler's task is cancelled, so an
inference handler aborts its request instead of decoding for nobody.
"""

from __future__ import annotations

import asyncio
import http
import json
import logging
import urllib.parse
from typing import Any, Awaitable, Callable, Dict, Iterable, Optional, Tuple

logger = logging.getLogger(__name__)

MAX_BODY_BYTES = 64 << 20
# How long a stopping server waits for each connection's buffered bytes
# to reach the peer.
CLOSE_FLUSH_S = 10.0
MAX_HEADERS = 128


class BadRequest(Exception):
    """The bytes on the connection are not an HTTP/1.x request."""


class Response:
    def __init__(self, body: bytes = b"", status: int = 200,
                 headers: Optional[Dict[str, str]] = None,
                 content_type: str = "text/plain; charset=utf-8") -> None:
        self.status = status
        self.body = body
        self.headers = {"Content-Type": content_type, **(headers or {})}


def text_response(text: str, status: int = 200,
                  headers: Optional[Dict[str, str]] = None) -> Response:
    return Response(text.encode("utf-8"), status, headers)


def json_response(obj: Any, status: int = 200,
                  headers: Optional[Dict[str, str]] = None) -> Response:
    return Response(json.dumps(obj).encode("utf-8"), status, headers,
                    "application/json; charset=utf-8")


def _head(status: int, headers: Dict[str, str]) -> bytes:
    lines = [f"HTTP/1.1 {status} {http.HTTPStatus(status).phrase}"]
    lines += [f"{k}: {v}" for k, v in headers.items()]
    return ("\r\n".join(lines) + "\r\n\r\n").encode("latin-1")


class StreamResponse:
    """A reply whose body is written piece by piece, each write one chunk
    of chunked transfer encoding."""

    def __init__(self, writer: asyncio.StreamWriter) -> None:
        self._writer = writer
        self.finished = False

    async def _start(self, status: int, headers: Dict[str, str]) -> None:
        self._writer.write(_head(status, {
            **headers, "Transfer-Encoding": "chunked"}))
        await self._writer.drain()

    async def write(self, data: bytes) -> None:
        if data:
            self._writer.write(b"%x\r\n%s\r\n" % (len(data), data))
            await self._writer.drain()

    async def write_eof(self) -> None:
        self._writer.write(b"0\r\n\r\n")
        await self._writer.drain()
        self.finished = True


class Request:
    def __init__(self, method: str, target: str, version: str,
                 headers: Dict[str, str], body: bytes,
                 writer: asyncio.StreamWriter) -> None:
        self.method = method
        parts = urllib.parse.urlsplit(target)
        self.path = parts.path
        # The request target as sent: path and query (a proxy forwards it).
        self.path_qs = target
        # Query parameters; a repeated name keeps its last value.
        self.query = dict(urllib.parse.parse_qsl(parts.query))
        self.version = version
        # Header names lowercased; a repeated header keeps its last value.
        self.headers = headers
        self.body = body
        self._writer = writer
        self.streamed: Optional[StreamResponse] = None

    def json(self) -> Any:
        """The body as JSON; raises ``ValueError`` when it is not."""
        return json.loads(self.body.decode("utf-8"))

    async def stream(self, headers: Dict[str, str],
                     status: int = 200) -> StreamResponse:
        """Send the status line and ``headers`` now; the body follows
        through the returned response's writes."""
        self.streamed = StreamResponse(self._writer)
        await self.streamed._start(status, headers)
        return self.streamed

    @property
    def keep_alive(self) -> bool:
        conn = self.headers.get("connection", "").lower()
        if self.version == "HTTP/1.0":
            return conn == "keep-alive"
        return conn != "close"


Handler = Callable[[Request], Awaitable[Response]]


class _Protocol(asyncio.StreamReaderProtocol):
    """Stream protocol that also notes when the peer has gone (EOF or a
    lost connection)."""

    def __init__(self, reader, client_connected_cb) -> None:
        super().__init__(reader, client_connected_cb)
        self.gone = asyncio.Event()

    def eof_received(self):
        self.gone.set()
        return super().eof_received()

    def connection_lost(self, exc) -> None:
        self.gone.set()
        super().connection_lost(exc)


async def _read_request(reader: asyncio.StreamReader,
                        writer: asyncio.StreamWriter) -> Optional[Request]:
    line = await reader.readline()
    while line in (b"\r\n", b"\n"):
        line = await reader.readline()
    if not line:
        return None
    try:
        method, target, version = line.decode("latin-1").split()
    except ValueError as e:
        raise BadRequest(f"bad request line {line[:80]!r}") from e
    if not version.startswith("HTTP/1."):
        raise BadRequest(f"unsupported version {version!r}")
    headers: Dict[str, str] = {}
    while True:
        h = await reader.readline()
        if h in (b"\r\n", b"\n", b""):
            break
        if len(headers) >= MAX_HEADERS:
            raise BadRequest("too many headers")
        name, sep, value = h.decode("latin-1").partition(":")
        if not sep:
            raise BadRequest(f"bad header line {h[:80]!r}")
        headers[name.strip().lower()] = value.strip()
    if headers.get("expect", "").lower() == "100-continue":
        writer.write(b"HTTP/1.1 100 Continue\r\n\r\n")
        await writer.drain()
    if "transfer-encoding" in headers:
        raise BadRequest("request bodies need a Content-Length")
    try:
        n = int(headers.get("content-length", "0"))
    except ValueError as e:
        raise BadRequest("bad Content-Length") from e
    if n < 0 or n > MAX_BODY_BYTES:
        raise BadRequest(f"bad Content-Length {n}")
    body = await reader.readexactly(n) if n else b""
    return Request(method.upper(), target, version, headers, body, writer)


class HTTPServer:
    """Routes ``{(method, path): handler}`` served on one listening
    socket; ``fallback``, when given, serves every other method and path
    (a proxy's pass-through) instead of the 404 / 405.  ``start`` runs the
    startup hooks and binds; ``stop`` asks ``wait_stopped`` to return;
    ``close`` unbinds and runs the cleanup hooks."""

    def __init__(self, routes: Dict[Tuple[str, str], Handler],
                 on_startup: Iterable[Callable[[], Awaitable[None]]] = (),
                 on_cleanup: Iterable[Callable[[], Awaitable[None]]] = (),
                 fallback: Optional[Handler] = None) -> None:
        self.routes = dict(routes)
        self.fallback = fallback
        self._paths = {p for _, p in self.routes}
        self.on_startup = list(on_startup)
        self.on_cleanup = list(on_cleanup)
        self._server: Optional[asyncio.AbstractServer] = None
        self._stopped: Optional[asyncio.Event] = None
        self._conns: set = set()

    async def start(self, host: str, port: int) -> int:
        """Run the startup hooks, then listen; returns the bound port."""
        loop = asyncio.get_running_loop()
        self._stopped = asyncio.Event()
        for hook in self.on_startup:
            await hook()
        self._server = await loop.create_server(
            lambda: _Protocol(asyncio.StreamReader(), self._client),
            host, port)
        return self._server.sockets[0].getsockname()[1]

    def stop(self) -> None:
        if self._stopped is not None:
            self._stopped.set()

    async def wait_stopped(self) -> None:
        await self._stopped.wait()

    async def close(self) -> None:
        """Stop listening, end every connection and run the cleanup
        hooks.  A connection's task closes its socket after the bytes it
        wrote are flushed (``_client``), and this waits for them, up to
        ``CLOSE_FLUSH_S``: a reply finished just before a stop must not be
        cut off when the process exits."""
        if self._server is not None:
            self._server.close()
            tasks = list(self._conns)
            for task in tasks:
                task.cancel()
            if tasks:
                await asyncio.wait(tasks, timeout=CLOSE_FLUSH_S)
            await self._server.wait_closed()
        for hook in self.on_cleanup:
            await hook()

    async def _client(self, reader: asyncio.StreamReader,
                      writer: asyncio.StreamWriter) -> None:
        task = asyncio.current_task()
        self._conns.add(task)
        gone = writer.transport.get_protocol().gone
        try:
            while True:
                try:
                    req = await _read_request(reader, writer)
                except BadRequest as e:
                    writer.write(_head(400, {
                        "Content-Type": "text/plain; charset=utf-8",
                        "Content-Length": str(len(str(e))),
                        "Connection": "close"}) + str(e).encode())
                    await writer.drain()
                    return
                if req is None or not await self._respond(req, writer, gone):
                    return
        except (ConnectionError, asyncio.IncompleteReadError):
            pass
        finally:
            self._conns.discard(task)
            writer.close()
            # The transport flushes what it still buffers before the
            # socket closes; wait for that (a cancelled task may await
            # here once), so a stopping server does not drop the tail of
            # a reply.
            try:
                await asyncio.wait_for(writer.wait_closed(), CLOSE_FLUSH_S)
            except (Exception, asyncio.CancelledError):
                pass

    async def _respond(self, req: Request, writer: asyncio.StreamWriter,
                       gone: asyncio.Event) -> bool:
        """Serve one request; returns whether the connection stays open."""
        handler = self.routes.get((req.method, req.path), self.fallback)
        if handler is None:
            status = 405 if req.path in self._paths else 404
            resp = text_response(
                f"{status}: {http.HTTPStatus(status).phrase}", status)
        else:
            work = asyncio.ensure_future(handler(req))
            peer = asyncio.ensure_future(gone.wait())
            try:
                await asyncio.wait({work, peer},
                                   return_when=asyncio.FIRST_COMPLETED)
            except asyncio.CancelledError:
                work.cancel()
                raise
            finally:
                peer.cancel()
            if not work.done():
                # The client went away: cancel the handler (an inference
                # handler aborts its request) and drop the connection.
                work.cancel()
                await asyncio.gather(work, return_exceptions=True)
                return False
            try:
                resp = work.result()
            except (ConnectionError, asyncio.IncompleteReadError):
                return False
            except Exception:
                logger.exception("handler for %s %s failed", req.method,
                                 req.path)
                if req.streamed is not None:
                    return False
                resp = text_response("500: Internal Server Error", 500)
            if req.streamed is not None:
                return req.streamed.finished and req.keep_alive
        keep = req.keep_alive
        headers = dict(resp.headers, **{
            "Content-Length": str(len(resp.body)),
            "Connection": "keep-alive" if keep else "close"})
        writer.write(_head(resp.status, headers) + resp.body)
        await writer.drain()
        return keep


def run_app(app: HTTPServer, host: str, port: int) -> None:
    """Serve ``app`` until SIGTERM or SIGINT, then close it (what
    aiohttp's ``web.run_app`` does for the JAX package's services)."""
    import signal

    async def serve() -> None:
        bound = await app.start(host, port)
        logger.info("serving on %s:%d", host, bound)
        loop = asyncio.get_running_loop()
        for sig in (signal.SIGTERM, signal.SIGINT):
            loop.add_signal_handler(sig, app.stop)
        try:
            await app.wait_stopped()
        finally:
            await app.close()

    asyncio.run(serve())
