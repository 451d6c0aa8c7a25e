"""Dynamic discovery for the shared KV tier's peers and the EPP's
endpoints (port of the resolvers of ``llm_d_tpu.epp.discovery``: the
tier's refresh thread calls them, and the port's EPP datastore
(``epp/datastore.py``) runs them in an executor for ``--discover``).

The tiered-prefix-cache recipe names its peers by a discovery spec
(``deploy/tiered-prefix-cache/modelserver.yaml``: ``--kv-shared-tier-peers
dns:ms-tiered:8700``), so the shared tier follows pod churn: a restarted
pod with a new address rejoins on the next resolve.  The grammar is the
EPP's ``--discover`` one:

  ``dns:<name>:<port>[=role]``             A / AAAA records of a headless
                                           Service (one a ready pod);
  ``k8s:[<namespace>/]<service>:<port>[=role]``  the Service's
                                           ``discovery.k8s.io/v1``
                                           EndpointSlices, read through the
                                           in-cluster API.

The JAX package's resolvers are asyncio coroutines over aiohttp; the card
machine has no aiohttp, so these are synchronous and standard library
only (``socket.getaddrinfo``; ``urllib.request`` with an ``ssl`` context
from the service account's CA and its bearer token), called from the
tier's refresh thread.  They give the same answers: a lookup error is
``None`` (an outage: the caller keeps its last view), an empty answer
``[]``; IPv6 hosts are bracketed; unready EndpointSlice addresses are
still listed (candidacy is the caller's own health check's job); the
namespace defaults to the pod's own; ``MultiResolver`` serves a failing
resolver's last good answer.
"""

from __future__ import annotations

import json
import logging
import os
import socket
import ssl
import urllib.error
import urllib.request
from typing import Dict, List, Optional, Sequence, Tuple

logger = logging.getLogger(__name__)

# (address "host:port", role "prefill"|"decode"|"both")
Resolved = Tuple[str, str]

_SA_DIR = "/var/run/secrets/kubernetes.io/serviceaccount"
# The API call's time limit (the JAX resolver's aiohttp total timeout).
K8S_TIMEOUT_S = 5.0


class DnsResolver:
    """The A / AAAA records of a headless Service: one a ready pod."""

    def __init__(self, name: str, port: int, role: str = "both") -> None:
        self.name = name
        self.port = port
        self.role = role

    def resolve(self) -> Optional[List[Resolved]]:
        """A lookup error returns None (an outage); a lookup with no
        records returns []."""
        try:
            infos = socket.getaddrinfo(self.name, self.port,
                                       type=socket.SOCK_STREAM)
        except OSError as exc:
            logger.warning("dns resolve %s failed: %s", self.name, exc)
            return None
        hosts = {info[4][0] for info in infos}
        # Bracket IPv6 hosts so "host:port" splits unambiguously.
        addrs = sorted(
            f"[{h}]:{self.port}" if ":" in h else f"{h}:{self.port}"
            for h in hosts)
        return [(a, self.role) for a in addrs]


class K8sEndpointSliceResolver:
    """The EndpointSlices of a Service, listed through the Kubernetes API
    with the pod's mounted service-account credentials (``api_server``,
    ``token`` and ``ca_file`` can be given instead, as tests do).  Every
    address is listed, ready or not."""

    def __init__(self, service: str, port: int,
                 namespace: Optional[str] = None,
                 role: str = "both",
                 api_server: Optional[str] = None,
                 token: Optional[str] = None,
                 ca_file: Optional[str] = None) -> None:
        self.service = service
        self.port = port
        # In-cluster convention: the pod's own namespace (the recipe's
        # RBAC is namespaced).
        if namespace is None:
            namespace = "default"
            if os.path.exists(f"{_SA_DIR}/namespace"):
                with open(f"{_SA_DIR}/namespace") as f:
                    namespace = f.read().strip() or "default"
        self.namespace = namespace
        self.role = role
        host = os.environ.get("KUBERNETES_SERVICE_HOST")
        kport = os.environ.get("KUBERNETES_SERVICE_PORT", "443")
        self.api_server = api_server or (
            f"https://{host}:{kport}" if host else None)
        self._token = token
        self._cached_token: Optional[str] = None
        self._ca_file = ca_file if ca_file is not None else (
            f"{_SA_DIR}/ca.crt" if os.path.exists(f"{_SA_DIR}/ca.crt")
            else None)
        self._sslctx: Optional[ssl.SSLContext] = None

    def _auth_headers(self) -> Dict[str, str]:
        token = self._token
        if token is None:
            token = self._cached_token
            if token is None and os.path.exists(f"{_SA_DIR}/token"):
                with open(f"{_SA_DIR}/token") as f:
                    token = f.read().strip()
                self._cached_token = token
        return {"Authorization": f"Bearer {token}"} if token else {}

    def url(self) -> str:
        return (f"{self.api_server}/apis/discovery.k8s.io/v1/namespaces/"
                f"{self.namespace}/endpointslices"
                f"?labelSelector=kubernetes.io/service-name={self.service}")

    def resolve(self) -> Optional[List[Resolved]]:
        """An API error returns None (an outage); a list with no
        endpoints returns []."""
        if not self.api_server:
            logger.warning("k8s resolver: no API server (not in-cluster?)")
            return None
        if self._sslctx is None and self._ca_file:
            self._sslctx = ssl.create_default_context(cafile=self._ca_file)
        req = urllib.request.Request(self.url(),
                                     headers=self._auth_headers())
        # Straight to the API server, as aiohttp goes: no proxy from the
        # environment.
        opener = urllib.request.build_opener(
            urllib.request.ProxyHandler({}),
            urllib.request.HTTPSHandler(context=self._sslctx))
        try:
            with opener.open(req, timeout=K8S_TIMEOUT_S) as resp:
                body = json.loads(resp.read())
        except urllib.error.HTTPError as exc:
            if exc.code in (401, 403):
                # The token may have rotated: read it again next tick.
                self._cached_token = None
            logger.warning("k8s endpointslice list failed: %s", exc)
            return None
        except (OSError, ValueError) as exc:
            logger.warning("k8s endpointslice list failed: %s", exc)
            return None
        addrs = set()
        for es in body.get("items", []):
            for ep in es.get("endpoints", []):
                for a in ep.get("addresses", []):
                    addrs.add(f"{a}:{self.port}")
        return [(a, self.role) for a in sorted(addrs)]


class MultiResolver:
    """The union of several resolvers (say k8s with DNS behind it for the
    same Service).  A resolver that fails contributes its last good
    answer, so one Service's outage neither drops its peers nor holds up
    the others; only when every resolver fails with no history is the
    whole resolve an outage (None)."""

    def __init__(self, resolvers: Sequence) -> None:
        self.resolvers = list(resolvers)
        self._last_good: Dict[int, List[Resolved]] = {}

    def resolve(self) -> Optional[List[Resolved]]:
        out: List[Resolved] = []
        any_ok = False
        for i, r in enumerate(self.resolvers):
            try:
                got = r.resolve()
            except Exception as exc:
                logger.warning("resolver %d failed: %s", i, exc)
                got = None
            if got is None:
                stale = self._last_good.get(i)
                if stale is not None:
                    out.extend(stale)
                continue
            any_ok = True
            self._last_good[i] = list(got)
            out.extend(got)
        if not any_ok and not out:
            return None
        return out


DYNAMIC_PREFIXES = ("dns:", "k8s:")


def is_dynamic(spec: str) -> bool:
    """Whether a peer entry is a discovery spec (not ``host:port``)."""
    return spec.startswith(DYNAMIC_PREFIXES)


def parse_discover_spec(spec: str):
    """One discovery spec -> its resolver.

    Forms (role defaults to ``both``):
      ``dns:<name>:<port>[=role]``
      ``k8s:[<namespace>/]<service>:<port>[=role]``
    """
    role = "both"
    if "=" in spec:
        spec, role = spec.rsplit("=", 1)
    kind, _, rest = spec.partition(":")
    if kind == "dns":
        name, _, port = rest.rpartition(":")
        if not name:
            raise ValueError(f"--discover dns needs <name>:<port>: {spec!r}")
        return DnsResolver(name, int(port), role=role)
    if kind == "k8s":
        nsvc, _, port = rest.rpartition(":")
        ns, _, svc = nsvc.partition("/")
        if not svc:
            ns, svc = None, ns      # no namespace: the pod's own
        if not svc:
            raise ValueError(
                f"--discover k8s needs [<ns>/]<service>:<port>: {spec!r}")
        return K8sEndpointSliceResolver(svc, int(port), namespace=ns,
                                        role=role)
    raise ValueError(f"unknown --discover kind {kind!r} (dns|k8s)")
