"""Host-buffer transport under the KV connector (the NIXL/UCX role; port of
``llm_d_tpu.transfer.transport``, the same wire).

The data plane is native C++ (``native/kv_transfer.cpp``), compiled with
``g++`` on first use into ``<repo>/build/llm_d_tpu_torch/kvtransfer-<hash>/``
(never into the package) and driven via ctypes: a registered-slab server
whose accept loop runs off the GIL, plus blocking fetch/release clients.
A pure-Python fallback with the identical wire protocol keeps the feature
alive on hosts without a toolchain (and doubles as a cross-check in
tests).  Either end speaks to the JAX package's servers and clients.

Reference roles mirrored here: NIXL point-to-point KV transfer without a
metadata side channel (docs/proposals/llm-d.md:60-68); the vLLM TPUConnector
contract's remote_host/remote_port/uuid addressing (README.tpu.md:182-189).
"""

from __future__ import annotations

import collections
import ctypes
import errno
import hashlib
import logging
import os
import pathlib
import socket
import struct
import subprocess
import threading
from typing import Deque, Dict, List, Optional

logger = logging.getLogger(__name__)

_PKG = pathlib.Path(__file__).resolve().parents[1]
_SRC = _PKG / "transfer" / "native" / "kv_transfer.cpp"
_CXX_FLAGS = ("-O2", "-shared", "-fPIC", "-std=c++17", "-pthread")
_build_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
_lib_failed = False


def _lib_path() -> pathlib.Path:
    """Where the library of this source and these flags is built."""
    h = hashlib.sha256(_SRC.read_bytes())
    h.update(" ".join(_CXX_FLAGS).encode())
    return (_PKG.parent / "build" / "llm_d_tpu_torch"
            / f"kvtransfer-{h.hexdigest()[:16]}" / "libkvtransfer.so")


def _load_native() -> Optional[ctypes.CDLL]:
    """Compile (once per source hash) and load the native transport;
    None on failure."""
    global _lib, _lib_failed
    if _lib is not None or _lib_failed:
        return _lib
    with _build_lock:
        if _lib is not None or _lib_failed:
            return _lib
        try:
            path = _lib_path()
            if not path.exists():
                path.parent.mkdir(parents=True, exist_ok=True)
                # Two processes may build at once: each writes its own
                # file and the rename is atomic.
                tmp = path.with_suffix(f".{os.getpid()}.tmp")
                subprocess.run(["g++", *_CXX_FLAGS, "-o", str(tmp),
                                str(_SRC)], check=True, capture_output=True)
                os.replace(tmp, path)
            lib = ctypes.CDLL(str(path), use_errno=True)
            lib.kvts_create.restype = ctypes.c_void_p
            lib.kvts_create.argtypes = [ctypes.c_char_p, ctypes.c_int]
            lib.kvts_port.restype = ctypes.c_int
            lib.kvts_port.argtypes = [ctypes.c_void_p]
            lib.kvts_register.argtypes = [
                ctypes.c_void_p, ctypes.c_char_p, ctypes.c_char_p,
                ctypes.c_uint64]
            lib.kvts_unregister.restype = ctypes.c_int
            lib.kvts_unregister.argtypes = [ctypes.c_void_p, ctypes.c_char_p]
            lib.kvts_next_released.restype = ctypes.c_int
            lib.kvts_next_released.argtypes = [
                ctypes.c_void_p, ctypes.c_char_p, ctypes.c_int]
            lib.kvts_destroy.argtypes = [ctypes.c_void_p]
            lib.kvts_fetch.restype = ctypes.c_int64
            lib.kvts_fetch.argtypes = [
                ctypes.c_char_p, ctypes.c_int, ctypes.c_char_p, ctypes.c_int,
                ctypes.POINTER(ctypes.POINTER(ctypes.c_char))]
            lib.kvts_free.argtypes = [ctypes.POINTER(ctypes.c_char)]
            lib.kvts_release.restype = ctypes.c_int
            lib.kvts_release.argtypes = [
                ctypes.c_char_p, ctypes.c_int, ctypes.c_char_p, ctypes.c_int]
            _lib = lib
        except (OSError, subprocess.CalledProcessError) as e:
            logger.warning(
                "native kv-transfer build failed (%s); using Python transport", e)
            _lib_failed = True
    return _lib


class TransferError(Exception):
    pass


class TransferNotFound(TransferError):
    pass


# ---------------------------------------------------------------------------
# Wire-level dtype tags, shared by every KV payload format riding this
# transport (the PD slab wire in transfer/connector.py and the offload
# tier's packed-block format in engine/offload.py).  A one-byte code per
# buffer segment lets a receiver REJECT a dtype-mismatched producer: an
# int8+scales cache must never be silently reinterpreted as bf16 rows.
# A bf16 row travels as its 2-byte bits.
# ---------------------------------------------------------------------------

WIRE_DTYPE_BF16 = 0
WIRE_DTYPE_INT8 = 1
WIRE_DTYPE_F32 = 2


def _torch_dtype(dtype):
    """A torch dtype, or a numpy dtype (or its name) as torch's."""
    import torch
    if isinstance(dtype, torch.dtype):
        return dtype
    import numpy as np
    name = np.dtype(dtype).name if not isinstance(dtype, str) else dtype
    return {"bfloat16": torch.bfloat16, "int8": torch.int8,
            "float32": torch.float32}.get(name)


def wire_dtype_code(dtype) -> int:
    """torch or numpy dtype -> wire code; raises on an unshippable dtype."""
    import torch
    code = {torch.bfloat16: WIRE_DTYPE_BF16, torch.int8: WIRE_DTYPE_INT8,
            torch.float32: WIRE_DTYPE_F32}.get(_torch_dtype(dtype))
    if code is None:
        raise TransferError(f"dtype {dtype} has no KV wire code")
    return code


def wire_dtype(code: int):
    """Wire code -> torch dtype; raises TransferError on unknown codes
    (a newer producer's format must fail loudly, not misparse)."""
    import torch
    table = {WIRE_DTYPE_BF16: torch.bfloat16, WIRE_DTYPE_INT8: torch.int8,
             WIRE_DTYPE_F32: torch.float32}
    if code not in table:
        raise TransferError(f"unknown KV wire dtype code {code}")
    return table[code]


def _resolve(host: str) -> str:
    """The native client only speaks dotted quads; resolve names here."""
    try:
        socket.inet_aton(host)
        return host
    except OSError:
        return socket.gethostbyname(host)


class NativeTransferServer:
    """Slab registry + TCP server backed by the C++ accept loop."""

    def __init__(self, host: str = "0.0.0.0", port: int = 0) -> None:
        lib = _load_native()
        if lib is None:
            raise TransferError("native transport unavailable")
        self._lib = lib
        self._handle = lib.kvts_create(_resolve(host).encode()
                                       if host != "0.0.0.0" else b"0.0.0.0",
                                       port)
        if not self._handle:
            raise TransferError(f"kvts_create failed on {host}:{port}")
        self.port = lib.kvts_port(self._handle)

    def register(self, uuid: str, blob: bytes) -> None:
        self._lib.kvts_register(self._handle, uuid.encode(), blob, len(blob))

    def unregister(self, uuid: str) -> bool:
        return bool(self._lib.kvts_unregister(self._handle, uuid.encode()))

    def drain_released(self) -> List[str]:
        out: List[str] = []
        buf = ctypes.create_string_buffer(4096)
        while True:
            n = self._lib.kvts_next_released(self._handle, buf, 4096)
            if n <= 0:
                break
            out.append(buf.raw[:n].decode())
        return out

    def close(self) -> None:
        if self._handle:
            self._lib.kvts_destroy(self._handle)
            self._handle = None


def native_fetch(host: str, port: int, uuid: str,
                 timeout_ms: int = 30000) -> bytes:
    lib = _load_native()
    if lib is None:
        raise TransferError("native transport unavailable")
    out = ctypes.POINTER(ctypes.c_char)()
    n = lib.kvts_fetch(_resolve(host).encode(), port, uuid.encode(),
                       timeout_ms, ctypes.byref(out))
    if n == -2:
        raise TransferNotFound(f"uuid {uuid!r} not registered on "
                               f"{host}:{port}")
    if n == -3:
        # No connection: the peer is down or unreachable (an OSError, as
        # the Python client raises, so callers can back off at once).
        err = ctypes.get_errno() or errno.ECONNREFUSED
        raise OSError(err, f"fetch {uuid!r}: no connection to {host}:{port} "
                      f"({os.strerror(err)})")
    if n < 0:
        raise TransferError(f"fetch {uuid!r} from {host}:{port} failed")
    try:
        return ctypes.string_at(out, n)
    finally:
        lib.kvts_free(out)


def native_release(host: str, port: int, uuid: str,
                   timeout_ms: int = 10000) -> bool:
    lib = _load_native()
    if lib is None:
        raise TransferError("native transport unavailable")
    return bool(lib.kvts_release(_resolve(host).encode(), port,
                                 uuid.encode(), timeout_ms))


# ---------------------------------------------------------------------------
# Pure-Python transport: identical wire protocol, used when the native build
# is unavailable and to cross-check the protocol in tests.
# ---------------------------------------------------------------------------

_NOT_FOUND = 0xFFFFFFFFFFFFFFFF


def _recv_full(sock: socket.socket, n: int) -> bytes:
    chunks = []
    while n > 0:
        b = sock.recv(min(n, 1 << 20))
        if not b:
            raise TransferError("connection closed mid-frame")
        chunks.append(b)
        n -= len(b)
    return b"".join(chunks)


class PyTransferServer:
    """threading-based fallback with the same interface as the native server."""

    def __init__(self, host: str = "0.0.0.0", port: int = 0) -> None:
        self._blobs: Dict[str, bytes] = {}
        self._released: Deque[str] = collections.deque()
        self._mu = threading.Lock()
        self._sock = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        self._sock.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        self._sock.bind((host, port))
        self._sock.listen(64)
        self.port = self._sock.getsockname()[1]
        self._stop = False
        self._thread = threading.Thread(
            target=self._accept_loop, name="kv-transfer", daemon=True)
        self._thread.start()

    def _accept_loop(self) -> None:
        while not self._stop:
            try:
                conn, _ = self._sock.accept()
            except OSError:
                break
            threading.Thread(
                target=self._handle, args=(conn,), daemon=True).start()

    def _handle(self, conn: socket.socket) -> None:
        try:
            op = _recv_full(conn, 1)[0]
            (uuid_len,) = struct.unpack("<I", _recv_full(conn, 4))
            uuid = _recv_full(conn, uuid_len).decode()
            if op == 1:
                with self._mu:
                    blob = self._blobs.get(uuid)
                if blob is None:
                    conn.sendall(struct.pack("<Q", _NOT_FOUND))
                else:
                    conn.sendall(struct.pack("<Q", len(blob)))
                    conn.sendall(blob)
            elif op == 2:
                with self._mu:
                    self._blobs.pop(uuid, None)
                    self._released.append(uuid)
                conn.sendall(b"\x01")
        except (TransferError, OSError):
            pass
        finally:
            conn.close()

    def register(self, uuid: str, blob: bytes) -> None:
        with self._mu:
            self._blobs[uuid] = blob

    def unregister(self, uuid: str) -> bool:
        with self._mu:
            return self._blobs.pop(uuid, None) is not None

    def drain_released(self) -> List[str]:
        out: List[str] = []
        with self._mu:
            while self._released:
                out.append(self._released.popleft())
        return out

    def close(self) -> None:
        self._stop = True
        try:
            self._sock.shutdown(socket.SHUT_RDWR)
        except OSError:
            pass
        self._sock.close()


def py_fetch(host: str, port: int, uuid: str, timeout_ms: int = 30000) -> bytes:
    with socket.create_connection((host, port), timeout=timeout_ms / 1000) as s:
        s.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
        u = uuid.encode()
        s.sendall(b"\x01" + struct.pack("<I", len(u)) + u)
        (size,) = struct.unpack("<Q", _recv_full(s, 8))
        if size == _NOT_FOUND:
            raise TransferNotFound(
                f"uuid {uuid!r} not registered on {host}:{port}")
        return _recv_full(s, size)


def py_release(host: str, port: int, uuid: str, timeout_ms: int = 10000) -> bool:
    try:
        with socket.create_connection(
                (host, port), timeout=timeout_ms / 1000) as s:
            u = uuid.encode()
            s.sendall(b"\x02" + struct.pack("<I", len(u)) + u)
            return _recv_full(s, 1) == b"\x01"
    except (OSError, TransferError):
        return False


# ---------------------------------------------------------------------------
# Facade: native when available, Python otherwise.
# ---------------------------------------------------------------------------

def make_server(host: str = "0.0.0.0", port: int = 0):
    if _load_native() is not None:
        try:
            return NativeTransferServer(host, port)
        except TransferError:
            pass
    return PyTransferServer(host, port)


def fetch(host: str, port: int, uuid: str, timeout_ms: int = 30000) -> bytes:
    # The native client speaks IPv4 only: an IPv6 literal goes through the
    # Python client.
    if ":" not in host and _load_native() is not None:
        return native_fetch(host, port, uuid, timeout_ms)
    return py_fetch(host, port, uuid, timeout_ms)


def release(host: str, port: int, uuid: str, timeout_ms: int = 10000) -> bool:
    if _load_native() is not None:
        return native_release(host, port, uuid, timeout_ms)
    return py_release(host, port, uuid, timeout_ms)
