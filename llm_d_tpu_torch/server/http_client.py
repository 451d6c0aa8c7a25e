"""A small HTTP/1.1 client on asyncio streams, standard library only.

The DP leader's worker pool (``server/openai.py``), the EPP gateway and
its datastore (``epp/``) and the routing sidecar (``sidecar/proxy.py``)
talk to model servers with it: the card machine has no aiohttp.  One
call is one connection (``Connection: close``):

    async with await post_json("http://10.0.0.2:8200", "/v1/completions",
                               body, headers) as resp:
        resp.status, resp.headers        # as soon as they arrive
        while chunk := await resp.readany():
            ...                          # body bytes as they arrive

The body is decoded from ``Content-Length``, chunked transfer encoding
(the port's server streams SSE chunked) or the connection's end.  A
refused connection, a connect timeout, a reset, a read timeout, an
unparseable reply and a reply that ends early (inside a chunk, or before
its last chunk or its ``Content-Length``) all raise :class:`ClientError`:
the one failure the pool backs a worker off for.  :func:`get` and
:func:`request` make the other calls (a scrape, a probe, a proxied
method); :meth:`ClientResponse.read` and :meth:`ClientResponse.json` read
a whole body.
"""

from __future__ import annotations

import asyncio
import json
import ssl
import urllib.parse
from typing import Any, Dict, Optional

# The most body bytes one ``readany`` returns.
READ_BYTES = 1 << 16
MAX_HEADERS = 128


class ClientError(Exception):
    """The peer could not be reached, or its reply broke off or could not
    be parsed."""


class ClientResponse:
    """A reply whose status and headers have arrived; the body is read
    through :meth:`readany`.  ``headers`` has its names
    lowercased (a repeated header keeps its last value)."""

    def __init__(self, reader: asyncio.StreamReader,
                 writer: asyncio.StreamWriter, status: int, reason: str,
                 headers: Dict[str, str],
                 read_timeout: Optional[float]) -> None:
        self.status = status
        self.reason = reason
        self.headers = headers
        self._reader = reader
        self._writer = writer
        self._read_timeout = read_timeout
        self._chunked = "chunked" in headers.get(
            "transfer-encoding", "").lower()
        length = headers.get("content-length")
        self._left: Optional[int] = None      # bytes of the body (or chunk)
        if not self._chunked and length is not None:
            try:
                self._left = int(length)
            except ValueError as e:
                raise ClientError(f"bad Content-Length {length!r}") from e
        self._chunk_left = 0
        self._done = False

    async def _io(self, coro):
        """``coro`` (a read) with the per-read timeout, its transport
        failures as ``ClientError``."""
        try:
            if self._read_timeout is not None:
                return await asyncio.wait_for(coro, self._read_timeout)
            return await coro
        except asyncio.TimeoutError as e:
            raise ClientError(f"no bytes for {self._read_timeout} s") from e
        except asyncio.IncompleteReadError as e:
            raise ClientError("the peer closed the connection mid-reply") \
                from e
        except (ConnectionError, OSError) as e:
            raise ClientError(f"{type(e).__name__}: {e}") from e

    async def _line(self) -> bytes:
        line = await self._io(self._reader.readline())
        if not line.endswith(b"\n"):
            raise ClientError("the peer closed the connection mid-reply")
        return line

    async def readany(self) -> bytes:
        """The next body bytes as they arrive (at most ``READ_BYTES``);
        b"" once the body has ended."""
        if self._done:
            return b""
        if self._chunked:
            if self._chunk_left == 0:
                size = (await self._line()).split(b";", 1)[0].strip()
                try:
                    self._chunk_left = int(size, 16)
                except ValueError as e:
                    raise ClientError(f"bad chunk size {size[:20]!r}") from e
                if self._chunk_left == 0:
                    while (await self._line()).strip():
                        pass                  # trailers
                    self._done = True
                    return b""
            data = await self._io(self._reader.read(
                min(self._chunk_left, READ_BYTES)))
            if not data:
                raise ClientError("the peer closed the connection "
                                  "mid-chunk")
            self._chunk_left -= len(data)
            if self._chunk_left == 0 and \
                    await self._io(self._reader.readexactly(2)) != b"\r\n":
                raise ClientError("a chunk does not end in CRLF")
            return data
        if self._left is not None:
            if self._left == 0:
                self._done = True
                return b""
            data = await self._io(self._reader.read(
                min(self._left, READ_BYTES)))
            if not data:
                raise ClientError(f"the peer closed the connection "
                                  f"{self._left} bytes short of its "
                                  f"Content-Length")
            self._left -= len(data)
            return data
        data = await self._io(self._reader.read(READ_BYTES))
        if not data:
            self._done = True
        return data

    async def read(self) -> bytes:
        """The rest of the body."""
        parts = []
        while True:
            data = await self.readany()
            if not data:
                return b"".join(parts)
            parts.append(data)

    async def json(self) -> Any:
        """The rest of the body as JSON; ``ValueError`` when it is not."""
        return json.loads((await self.read()).decode("utf-8"))

    def close(self) -> None:
        self._writer.close()

    async def __aenter__(self) -> "ClientResponse":
        return self

    async def __aexit__(self, *exc) -> None:
        self.close()
        try:
            await self._writer.wait_closed()
        except (ConnectionError, OSError):
            pass


async def post_json(base_url: str, path: str, body: Any,
                    headers: Optional[Dict[str, str]] = None,
                    connect_timeout: float = 5.0,
                    read_timeout: Optional[float] = None
                    ) -> ClientResponse:
    """POST ``body`` as JSON to ``base_url`` + ``path`` (an ``http://``
    URL, or ``https://`` with the system's certificate check); returns once the reply's status and headers have arrived.
    ``headers`` are sent as given, but those this call sets itself (the
    host, the body's type and length, the connection)."""
    return await request("POST", base_url, path, json.dumps(body).encode(),
                         headers, connect_timeout, read_timeout,
                         content_type="application/json")


async def get(base_url: str, path: str,
              headers: Optional[Dict[str, str]] = None,
              connect_timeout: float = 5.0,
              read_timeout: Optional[float] = None) -> ClientResponse:
    """GET ``base_url`` + ``path``, as :func:`post_json` posts."""
    return await request("GET", base_url, path, None, headers,
                         connect_timeout, read_timeout)


async def request(method: str, base_url: str, path: str,
                  data: Optional[bytes] = None,
                  headers: Optional[Dict[str, str]] = None,
                  connect_timeout: float = 5.0,
                  read_timeout: Optional[float] = None,
                  content_type: Optional[str] = None) -> ClientResponse:
    """Send ``method`` with the body ``data`` (None: no body) to
    ``base_url`` + ``path``; returns once the reply's status and headers
    have arrived.  ``content_type`` replaces a ``Content-Type`` among
    ``headers``."""
    url = urllib.parse.urlsplit(base_url)
    if url.scheme not in ("http", "https") or not url.hostname:
        raise ValueError(f"not an http:// or https:// URL: {base_url!r}")
    tls = url.scheme == "https"
    host, port = url.hostname, url.port or (443 if tls else 80)
    own = {"host", "content-length", "connection", "transfer-encoding"}
    netloc = f"[{host}]:{port}" if ":" in host else f"{host}:{port}"
    lines = [f"{method} {path} HTTP/1.1", f"Host: {netloc}",
             "Connection: close"]
    if content_type is not None:
        own.add("content-type")
        lines.append(f"Content-Type: {content_type}")
    if data is not None:
        lines.append(f"Content-Length: {len(data)}")
    for k, v in (headers or {}).items():
        if k.lower() not in own:
            if any(c in f"{k}{v}" for c in "\r\n"):
                raise ValueError(f"header {k!r} holds a line break")
            lines.append(f"{k}: {v}")
    head = ("\r\n".join(lines) + "\r\n\r\n").encode("latin-1")
    try:
        reader, writer = await asyncio.wait_for(
            asyncio.open_connection(
                host, port, ssl=ssl.create_default_context() if tls
                else None), connect_timeout)
    except asyncio.TimeoutError as e:
        raise ClientError(f"connecting to {host}:{port} timed out after "
                          f"{connect_timeout} s") from e
    except OSError as e:
        raise ClientError(f"cannot connect to {host}:{port}: {e}") from e
    try:
        writer.write(head + (data or b""))
        await writer.drain()
        return await _read_head(reader, writer, read_timeout)
    except (ConnectionError, OSError) as e:
        writer.close()
        raise ClientError(f"{type(e).__name__}: {e}") from e
    except BaseException:
        writer.close()
        raise


async def _read_head(reader: asyncio.StreamReader,
                     writer: asyncio.StreamWriter,
                     read_timeout: Optional[float]) -> ClientResponse:
    """The status line and headers (interim 1xx replies skipped)."""
    while True:
        line = await reader.readline()
        if not line.endswith(b"\n"):
            raise ClientError("the peer closed the connection before its "
                              "reply")
        try:
            version, status, *reason = line.decode("latin-1").split(None, 2)
            status = int(status)
        except ValueError as e:
            raise ClientError(f"bad status line {line[:80]!r}") from e
        if not version.startswith("HTTP/1."):
            raise ClientError(f"unsupported version {version!r}")
        headers: Dict[str, str] = {}
        while True:
            h = await reader.readline()
            if not h.endswith(b"\n"):
                raise ClientError("the peer closed the connection in its "
                                  "headers")
            if h in (b"\r\n", b"\n"):
                break
            if len(headers) >= MAX_HEADERS:
                raise ClientError("too many headers")
            name, sep, value = h.decode("latin-1").partition(":")
            if not sep:
                raise ClientError(f"bad header line {h[:80]!r}")
            headers[name.strip().lower()] = value.strip()
        if status >= 200:
            return ClientResponse(reader, writer, status,
                                  reason[0].strip() if reason else "",
                                  headers, read_timeout)
