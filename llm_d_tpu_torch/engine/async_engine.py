"""Async front-end over EngineCore (port of
``llm_d_tpu.engine.async_engine``).

The engine steps in a dedicated thread; the asyncio side submits
requests through a thread-safe inbox and receives streamed
``RequestOutput``s via per-request queues.

Every engine call (adding and aborting requests, steps, and so the
decode graphs' captures and replays) runs on the engine thread, so a
capture never races a step.  PyTorch keeps the current CUDA device per
thread: the thread selects the engine's device before its first step.

The engine is an ``EngineCore`` or a ``DPEngineGroup`` (its ranks'
engines behind one dispatcher, ``engine/dp_group.py``): both offer the
calls used here (``add_request``, ``abort_request``, ``has_work``,
``step``, ``scheduler.has_work``, ``device``).
"""

from __future__ import annotations

import asyncio
import logging
import queue
import threading
from typing import AsyncIterator, Dict, Optional, Union

import torch

from llm_d_tpu_torch.engine.dp_group import DPEngineGroup
from llm_d_tpu_torch.engine.engine import EngineCore
from llm_d_tpu_torch.engine.request import Request, RequestOutput

logger = logging.getLogger(__name__)


class AsyncEngine:
    def __init__(self, engine: Union[EngineCore, DPEngineGroup]) -> None:
        self.engine = engine
        self._inbox: "queue.Queue" = queue.Queue()
        self._streams: Dict[str, asyncio.Queue] = {}
        self._loop: Optional[asyncio.AbstractEventLoop] = None
        self._wake = threading.Event()
        self._stop = False
        self._thread: Optional[threading.Thread] = None
        self.dead: Optional[BaseException] = None
        # The card the engine's tensors live on: an unindexed "cuda" is
        # the current device of the thread that built the engine.
        dev = engine.device
        self._cuda_index = None
        if dev.type == "cuda":
            self._cuda_index = (dev.index if dev.index is not None
                                else torch.cuda.current_device())

    # ---------- lifecycle ----------

    async def start(self) -> None:
        self._loop = asyncio.get_running_loop()
        self._thread = threading.Thread(
            target=self._run, name="engine-loop", daemon=True)
        self._thread.start()

    def stop(self) -> None:
        self._stop = True
        self._wake.set()
        if self._thread is not None:
            self._thread.join(timeout=5)

    def _run(self) -> None:
        try:
            if self._cuda_index is not None:
                torch.cuda.set_device(self._cuda_index)
            while not self._stop:
                self._drain_inbox()
                if not self.engine.has_work():
                    self._wake.wait(timeout=0.05)
                    self._wake.clear()
                    continue
                outputs = self.engine.step()
                if outputs and self._loop is not None:
                    self._loop.call_soon_threadsafe(self._dispatch, outputs)
                if not self.engine.scheduler.has_work():
                    # Only connector work pending (KV pulls in flight /
                    # producer pins awaiting release): poll, don't spin.
                    self._wake.wait(timeout=0.01)
                    self._wake.clear()
        except BaseException as e:  # engine death must not hang clients
            logger.exception("engine loop died")
            self.dead = e
            if self._loop is not None:
                self._loop.call_soon_threadsafe(self._fail_all, e)

    def _drain_inbox(self) -> None:
        while True:
            try:
                kind, payload = self._inbox.get_nowait()
            except queue.Empty:
                return
            if kind == "add":
                self.engine.add_request(payload)
            elif kind == "abort":
                self.engine.abort_request(payload)

    # ---------- event-loop side ----------

    def abort(self, request_id: str, notify: bool = False) -> None:
        """Abort a request from the event-loop side (drain timeout, admin
        cancel).  ``notify=True`` also terminates the request's stream with
        a finished "abort" output, for a client that is still connected
        and would otherwise wait forever (the engine emits no output for
        aborts)."""
        self._inbox.put(("abort", request_id))
        self._wake.set()
        if notify and self._loop is not None:
            self._loop.call_soon_threadsafe(self._dispatch, [
                RequestOutput(request_id, [], True, finish_reason="abort")])

    def _dispatch(self, outputs) -> None:
        for out in outputs:
            q = self._streams.get(out.request_id)
            if q is not None:
                q.put_nowait(out)
                if out.finished:
                    self._streams.pop(out.request_id, None)

    def _fail_all(self, exc: BaseException) -> None:
        for q in self._streams.values():
            q.put_nowait(exc)
        self._streams.clear()

    async def generate(self, request: Request) -> AsyncIterator[RequestOutput]:
        """Submit a request and yield streamed outputs until finished."""
        if self.dead is not None:
            raise RuntimeError("engine is dead") from self.dead
        q: asyncio.Queue = asyncio.Queue()
        self._streams[request.request_id] = q
        self._inbox.put(("add", request))
        self._wake.set()
        try:
            while True:
                item = await q.get()
                if isinstance(item, BaseException):
                    raise RuntimeError("engine died mid-request") from item
                yield item
                if item.finished:
                    return
        finally:
            if request.request_id in self._streams:
                self._streams.pop(request.request_id, None)
                self._inbox.put(("abort", request.request_id))
                self._wake.set()
