"""Routing sidecar: per-decode-pod proxy executing P->D orchestration
(port of ``llm_d_tpu.sidecar.proxy``: the same flags, headers and
failover, on the standard library's asyncio through
``server/http_server.py`` and ``server/http_client.py``).

The reference runs ``llm-d-routing-sidecar`` in front of every decode vLLM
(:8000 proxying :8200) with ``--connector=nixlv2``; for each request it
first issues the prefill to the pod the EPP chose (the
``x-prefiller-host-port`` hint header), then forwards the original request
to the local engine with the returned ``kv_transfer_params`` so its
connector pulls the KV (reference: wide-ep decode.yaml:23-29, SURVEY §3.3).

This is that proxy for the TPU stack: same ports, same hint header, same
two-step orchestration, with the ``TpuConnector`` transfer underneath.
``--prefiller`` pins a static prefill target for setups without an EPP.

Resilience (P/D-Serve arxiv 2408.08147: per-request failover at the
routing layer, not pod restart): ``x-prefiller-host-port`` may carry a
comma-ranked list of prefillers; on 5xx/timeout the sidecar retries the
next one with capped exponential backoff between rounds, and when every
prefiller is down it falls back to a full LOCAL prefill on the decode pod
(the "recompute locally" path) instead of a 502.

    python -m llm_d_tpu_torch.sidecar.proxy --port 8000 \
        --decode-url http://127.0.0.1:8200 --connector tpu \
        --prefiller ms-pd-prefill:8200
"""

from __future__ import annotations

import argparse
import asyncio
import logging
from typing import List, Optional, Union

from llm_d_tpu_torch.server import http_client
from llm_d_tpu_torch.server.http_server import (
    HTTPServer, Request, Response, StreamResponse, json_response, run_app)
from llm_d_tpu_torch.utils import tracing
from llm_d_tpu_torch.utils.config import env_float, env_int
from llm_d_tpu_torch.utils.faultinject import FaultInjected, get_injector
from llm_d_tpu_torch.utils.lifecycle import (
    CRITICALITY_HEADER,
    DEADLINE_ABS_HEADER,
    DEADLINE_EXCEEDED_HEADER,
    PREFILL_FALLBACK_HEADER,
    PREFILLER_HEADER,
    REQUEST_ID_HEADER,
    RESUME_ATTEMPT_HEADER,
    RESUME_OFFSET_HEADER,
    parse_criticality,
    parse_deadline,
    remaining_s,
)

logger = logging.getLogger(__name__)

# Hop-by-hop headers a proxy must not forward verbatim.
_HOP_HEADERS = {"host", "content-length", "transfer-encoding", "connection",
                "keep-alive", "te", "upgrade"}
# A prefill's connect time limit (aiohttp's sock_connect in the JAX
# sidecar): a blackholed prefiller costs seconds, not the prefill budget.
CONNECT_TIMEOUT_S = 10.0


class RoutingSidecar:
    def __init__(self, decode_url: str,
                 static_prefiller: Optional[str] = None,
                 prefiller_use_tls: bool = False,
                 prefill_timeout_s: Optional[float] = None,
                 prefill_retries: Optional[int] = None,
                 prefill_backoff_s: Optional[float] = None) -> None:
        self.decode_url = decode_url.rstrip("/")
        self.static_prefiller = static_prefiller
        self.scheme = "https" if prefiller_use_tls else "http"
        self.prefill_timeout_s = (
            prefill_timeout_s if prefill_timeout_s is not None
            else env_float("LLMD_PREFILL_TIMEOUT_S", 600.0))
        # Failover budget: each ROUND tries every listed prefiller once;
        # between rounds the sidecar backs off exponentially (capped).
        self.prefill_retries = (
            prefill_retries if prefill_retries is not None
            else env_int("LLMD_PREFILL_RETRIES", 1))
        self.prefill_backoff_s = (
            prefill_backoff_s if prefill_backoff_s is not None
            else env_float("LLMD_PREFILL_BACKOFF_S", 0.1))

    # ---------- app ----------

    def build_app(self) -> HTTPServer:
        # Everything else (probes, /metrics, /v1/models, /tokenize) passes
        # straight through to the local engine.
        return HTTPServer({
            ("POST", "/v1/completions"): self.completions,
            ("POST", "/v1/chat/completions"): self.completions,
        }, fallback=self.passthrough)

    # ---------- handlers ----------

    async def passthrough(self, request: Request) -> StreamResponse:
        headers = {k: v for k, v in request.headers.items()
                   if k not in _HOP_HEADERS}
        async with await http_client.request(
                request.method, self.decode_url, request.path_qs,
                request.body if request.body else None,
                headers) as upstream:
            return await self._relay(request, upstream)

    async def completions(self, request: Request
                          ) -> Union[Response, StreamResponse]:
        try:
            body = request.json()
        except ValueError:
            return json_response({"error": "invalid json"}, status=400)

        rid = request.headers.get(REQUEST_ID_HEADER,
                                  str(body.get("request_id") or ""))
        in_headers = dict(request.headers)
        try:
            deadline_epoch = parse_deadline(in_headers, body)
            criticality = parse_criticality(in_headers, body)
        except ValueError as exc:
            return json_response(
                {"error": f"invalid request: {exc}", "request_id": rid},
                status=400)
        left = remaining_s(deadline_epoch)
        if left is not None and left <= 0:
            # Refuse before the (possibly expensive) remote prefill: the
            # budget is gone, no orchestration can bring it back.
            return json_response(
                {"error": "deadline exceeded", "request_id": rid},
                status=504, headers={DEADLINE_EXCEEDED_HEADER: "1"})
        span = tracing.get_tracer("sidecar").start_span(
            "sidecar.request",
            parent=tracing.parse_trace_headers(in_headers),
            request_id=rid or None, criticality=criticality)
        # Lifecycle + trace headers ride BOTH hops (prefill and local
        # decode): downstream spans parent on the sidecar span.
        fwd_headers = {CRITICALITY_HEADER: criticality}
        if deadline_epoch is not None:
            fwd_headers[DEADLINE_ABS_HEADER] = f"{deadline_epoch:.6f}"
        if rid:
            fwd_headers[REQUEST_ID_HEADER] = rid
        fwd_headers.update(tracing.trace_headers(span.ctx()))
        for h in (RESUME_OFFSET_HEADER, RESUME_ATTEMPT_HEADER):
            if h in in_headers:
                fwd_headers[h] = in_headers[h]
        hint = request.headers.get(PREFILLER_HEADER) or \
            self.static_prefiller or ""
        prefillers = [p.strip() for p in hint.split(",") if p.strip()]
        local_fallback = False
        try:
            # A mid-stream RESUME never goes through remote prefill: the
            # decode pod admits prompt+generated locally, restore-first
            # from its prefix cache / host tier (a remote prefill could
            # only cover the prompt region and would waste a prefill pod).
            if prefillers and not body.get("kv_transfer_params") \
                    and not body.get("resume"):
                decode_body = await self._prefill_with_failover(
                    request.path, body, prefillers, rid,
                    deadline_epoch=deadline_epoch,
                    fwd_headers=fwd_headers, span=span)
                if decode_body is None:
                    # Every prefiller is down: recompute locally on the
                    # decode pod (full local prefill — the request
                    # survives the prefill pool outage at the cost of the
                    # decode pod's compute) instead of the old
                    # immediate 502.
                    logger.error(
                        "all %d prefiller(s) failed (request_id=%s); "
                        "falling back to local prefill on the decode pod",
                        len(prefillers), rid or "-")
                    span.add_event("prefill.local_fallback",
                                   prefillers=len(prefillers))
                    local_fallback = True
                else:
                    body = decode_body

            async with await http_client.post_json(
                    self.decode_url, request.path, body,
                    fwd_headers) as upstream:
                resp = await self._relay(request, upstream, request_id=rid,
                                         extra_headers=(
                                             {PREFILL_FALLBACK_HEADER: "local"}
                                             if local_fallback else None))
                span.set(status=upstream.status,
                         local_fallback=local_fallback or None)
                return resp
        finally:
            span.end()

    async def _prefill_with_failover(self, path: str, body: dict,
                                     prefillers: List[str],
                                     request_id: str,
                                     deadline_epoch: Optional[float] = None,
                                     fwd_headers: Optional[dict] = None,
                                     span=None) -> Optional[dict]:
        """Try each prefiller in ranked order, up to ``prefill_retries + 1``
        rounds with capped exponential backoff between rounds.  Returns the
        decode body (kv_transfer_params attached) or None when every
        attempt failed.  Each attempt is a child span of ``span`` and
        each failure a ``prefill.retry`` event, so P->D failover chains
        read causally in the trace."""
        for rnd in range(max(0, self.prefill_retries) + 1):
            if rnd:
                # Cap the exponential so a long retry budget cannot park a
                # live request behind minutes of sleep.
                await asyncio.sleep(min(
                    self.prefill_backoff_s * (2 ** (rnd - 1)),
                    8 * self.prefill_backoff_s))
            left = remaining_s(deadline_epoch)
            if left is not None and left <= 0:
                # Budget gone mid-failover: stop — the decode hop renders
                # the authoritative 504.
                if span is not None:
                    span.add_event("prefill.deadline_exhausted", round=rnd)
                return None
            for prefiller in prefillers:
                try:
                    out = await self._run_prefill(
                        path, body, prefiller,
                        deadline_epoch=deadline_epoch, headers=fwd_headers,
                        span=span, rnd=rnd)
                    if rnd or prefiller != prefillers[0]:
                        logger.warning(
                            "prefill failover succeeded via %s "
                            "(round %d, request_id=%s)", prefiller, rnd,
                            request_id or "-")
                    return out
                except PrefillError as e:
                    logger.warning(
                        "prefill via %s failed (round %d, request_id=%s): "
                        "%s", prefiller, rnd, request_id or "-", e)
                    if span is not None:
                        span.add_event("prefill.retry",
                                       prefiller=prefiller, round=rnd,
                                       error=str(e),
                                       permanent=e.permanent or None)
                    if e.permanent:
                        # Request-level failure: skip the remaining
                        # failover budget, let the decode pod answer.
                        return None
        return None

    async def _run_prefill(self, path: str, body: dict, prefiller: str,
                           deadline_epoch: Optional[float] = None,
                           headers: Optional[dict] = None,
                           span=None, rnd: int = 0) -> dict:
        """Step 1 of the PD contract: remote prefill, returns the decode body.

        The prefill request mirrors the original but generates a single
        token under ``do_remote_decode`` — the producer stops after prefill,
        pins KV, and answers with ``kv_transfer_params`` which we attach for
        the local decode engine's connector pull
        (reference: README.tpu.md:182-189).
        """
        prefill_body = dict(body)
        prefill_body["stream"] = False
        prefill_body["max_tokens"] = 1
        prefill_body["kv_transfer_params"] = {"do_remote_decode": True}
        url = f"{self.scheme}://{prefiller}"
        # A request deadline caps the per-attempt budget: a prefill that
        # cannot finish inside the remaining budget is a miss either way,
        # so fail over (or give up) instead of sleeping past the deadline.
        timeout_s = self.prefill_timeout_s
        left = remaining_s(deadline_epoch)
        if left is not None:
            timeout_s = max(0.001, min(timeout_s, left))
        # One span per prefill ATTEMPT (phase "prefill": the remote-
        # prefill leg of the PD TTFT decomposition as the sidecar sees
        # it — engine-side compute + both wire directions).
        pspan = tracing.get_tracer("sidecar").start_span(
            "sidecar.prefill", parent=span, phase="prefill",
            prefiller=prefiller, round=rnd)
        if headers is not None:
            headers = dict(headers)
            headers.update(tracing.trace_headers(pspan.ctx()))
        try:
            await get_injector().acheck("sidecar.prefill", key=prefiller)
            # Connect bound: a blackholed prefiller (dead node, SYNs
            # dropped) must cost seconds before failover, not the full
            # prefill budget (same bound as the gateway's forward path).
            payload = await asyncio.wait_for(
                self._post_prefill(url, path, prefill_body, headers,
                                   min(CONNECT_TIMEOUT_S, timeout_s)),
                timeout_s)
        except PrefillError as e:
            pspan.end(error=str(e))
            raise
        except (http_client.ClientError, asyncio.TimeoutError,
                ValueError, FaultInjected) as e:
            # ValueError: a 200 with a garbled/truncated body (or a URL
            # the client cannot use) is a misbehaving prefiller like any
            # other — fail over, don't 500.
            pspan.end(error=str(e) or type(e).__name__)
            raise PrefillError(str(e) or type(e).__name__) from e
        params = payload.get("kv_transfer_params")
        if not params:
            pspan.end(error="missing kv_transfer_params")
            raise PrefillError("prefill response missing kv_transfer_params")
        pspan.end(blocks=len(params.get("remote_block_ids") or ()))
        decode_body = dict(body)
        decode_body["kv_transfer_params"] = params
        return decode_body

    @staticmethod
    async def _post_prefill(url: str, path: str, body: dict,
                            headers: Optional[dict],
                            connect_timeout: float) -> dict:
        """One prefill POST; its 200 body as JSON."""
        async with await http_client.post_json(
                url, path, body, headers,
                connect_timeout=connect_timeout) as resp:
            if resp.status != 200:
                # 4xx is a verdict on the REQUEST, not the prefiller:
                # every prefiller would answer the same, so failover
                # rounds are wasted work (the decode pod renders the
                # authoritative per-request error via local prefill).
                raise PrefillError(f"HTTP {resp.status}",
                                   permanent=400 <= resp.status < 500)
            return await resp.json()

    async def _relay(self, request: Request,
                     upstream: http_client.ClientResponse,
                     request_id: str = "",
                     extra_headers: Optional[dict] = None
                     ) -> StreamResponse:
        """Stream the upstream response back (SSE-safe chunked relay).

        A client that disconnects mid-stream must ABORT the upstream
        decode request — otherwise the engine keeps generating into a dead
        socket, holding its scheduler slot and KV blocks until max_tokens.
        ``upstream.close()`` hard-closes the connection, which the decode
        server sees as a peer disconnect and aborts the request."""
        headers = {k: v for k, v in upstream.headers.items()
                   if k not in _HOP_HEADERS}
        headers.update(extra_headers or {})
        resp = await request.stream(headers, status=upstream.status)
        try:
            while True:
                chunk = await upstream.readany()
                if not chunk:
                    break
                await resp.write(chunk)
        except (ConnectionResetError, BrokenPipeError):
            # resp.write raising means the CLIENT is gone (upstream-side
            # failures raise http_client.ClientError and must keep
            # propagating — an abrupt break is how the still-connected
            # client learns its stream was truncated).
            upstream.close()
            logger.warning("client disconnected mid-stream "
                           "(request_id=%s); aborted upstream decode",
                           request_id or "-")
            return resp
        except asyncio.CancelledError:
            # The server cancels the handler on client disconnect: free
            # the engine slot before propagating.
            upstream.close()
            logger.warning("client disconnected mid-stream "
                           "(request_id=%s); aborted upstream decode",
                           request_id or "-")
            raise
        await resp.write_eof()
        return resp


class PrefillError(Exception):
    """A failed prefill attempt.  ``permanent`` marks request-level
    verdicts (4xx) that no alternate prefiller can change."""

    def __init__(self, msg: str, permanent: bool = False) -> None:
        super().__init__(msg)
        self.permanent = permanent


def build_arg_parser() -> argparse.ArgumentParser:
    """The JAX ``main``'s flags, each with its default."""
    p = argparse.ArgumentParser("llmd-sidecar")
    p.add_argument("--host", default="0.0.0.0")
    p.add_argument("--port", type=int, default=8000,
                   help="listen port (the address the EPP routes to)")
    p.add_argument("--decode-url", default="http://127.0.0.1:8200",
                   help="local decode engine (vLLM-equivalent) base URL")
    p.add_argument("--prefiller", default=None,
                   help="static prefill host:port when no EPP hint header "
                        "is present")
    p.add_argument("--connector", default="tpu",
                   help="accepted for reference-flag compatibility "
                        "(--connector=nixlv2 analogue); only 'tpu' exists")
    p.add_argument("--prefiller-use-tls", action="store_true")
    p.add_argument("--prefill-timeout", type=float, default=None,
                   help="per-attempt prefill timeout in seconds "
                        "(default LLMD_PREFILL_TIMEOUT_S or 600)")
    p.add_argument("--prefill-retries", type=int, default=None,
                   help="extra failover rounds over the prefiller list "
                        "(default LLMD_PREFILL_RETRIES or 1)")
    p.add_argument("--prefill-backoff", type=float, default=None,
                   help="base backoff between failover rounds, seconds "
                        "(default LLMD_PREFILL_BACKOFF_S or 0.1)")
    return p


def sidecar_from_args(args) -> RoutingSidecar:
    return RoutingSidecar(args.decode_url, args.prefiller,
                          prefiller_use_tls=args.prefiller_use_tls,
                          prefill_timeout_s=args.prefill_timeout,
                          prefill_retries=args.prefill_retries,
                          prefill_backoff_s=args.prefill_backoff)


def main(argv=None) -> None:
    p = build_arg_parser()
    args = p.parse_args(argv)
    logging.basicConfig(level=logging.INFO)
    run_app(sidecar_from_args(args).build_app(), args.host, args.port)


if __name__ == "__main__":
    main()
