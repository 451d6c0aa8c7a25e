"""Online models the engine and the EPP consult while scheduling (port
of ``SpecAcceptanceTracker``, ``StepTimeModel`` and ``TransferCostModel``
from ``llm_d_tpu.predictor.model``; numpy only).

* ``SpecAcceptanceTracker`` keeps each request's draft-acceptance rate
  (an EMA) and answers the draft depth worth paying for next step.
* ``StepTimeModel`` fits ``step_ms ~ base + a_p * prefill_tokens + a_d *
  decode_tokens`` online and sizes prefill chunks against a target step
  time.
* ``TransferCostModel`` prices a KV restore per link class for the EPP's
  kv-placement-scorer (its analytic prior).
"""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np

from llm_d_tpu_torch.utils.config import env_float


class SpecAcceptanceTracker:
    """Per-request draft-acceptance bookkeeping feeding an adaptive K.

    Below ``low`` the drafter wastes verify work on this request: back off
    to K = 1 (one draft keeps measuring, so recovery is possible); at or
    above it run the full depth.  Untracked requests start at full depth.
    The table holds at most ``cap`` requests."""

    def __init__(self, k_max: int, low: float = 0.35,
                 alpha: float = 0.4, cap: int = 4096) -> None:
        self.k_max = max(1, int(k_max))
        self.low = low
        self.alpha = alpha
        self.cap = cap
        self._rate: Dict[str, float] = {}

    def observe(self, request_id: str, drafted: int, accepted: int) -> None:
        if drafted <= 0:
            return
        r = accepted / drafted
        prev = self._rate.get(request_id)
        if prev is None and len(self._rate) >= self.cap:
            # Bounded table: drop an arbitrary stale entry.
            self._rate.pop(next(iter(self._rate)))
        self._rate[request_id] = (r if prev is None
                                  else (1 - self.alpha) * prev
                                  + self.alpha * r)

    def rate(self, request_id: str) -> Optional[float]:
        return self._rate.get(request_id)

    def suggest_k(self, request_id: str) -> int:
        r = self._rate.get(request_id)
        if r is None or r >= self.low:
            return self.k_max
        return 1

    def forget(self, request_id: str) -> None:
        self._rate.pop(request_id, None)


class StepTimeModel:
    """Online linear step-latency model for chunk budgeting, fit
    closed-form (ridge over accumulated normal equations) from the wall
    time the engine step already reads around its host fetch.
    ``chunk_for`` gives the largest prefill chunk whose predicted step
    time stays under a target at the decode load already funded."""

    def __init__(self, min_samples: int = 16, l2: float = 1e-3) -> None:
        self.min_samples = min_samples
        self.l2 = l2
        self._xtx = np.zeros((3, 3))
        self._xty = np.zeros(3)
        self.num_observed = 0
        self._coef: Optional[np.ndarray] = None

    def observe(self, prefill_tokens: int, decode_tokens: int,
                step_ms: float) -> None:
        x = np.asarray([1.0, float(prefill_tokens), float(decode_tokens)])
        self._xtx += np.outer(x, x)
        self._xty += x * float(step_ms)
        self.num_observed += 1
        self._coef = None            # re-solved at the next predict

    @property
    def trained(self) -> bool:
        return self.num_observed >= self.min_samples

    def predict(self, prefill_tokens: int, decode_tokens: int) -> float:
        """Predicted step wall time (ms); 0.0 when untrained."""
        if not self.trained:
            return 0.0
        if self._coef is None:
            A = self._xtx + self.l2 * np.eye(3)
            self._coef = np.linalg.solve(A, self._xty)
        x = np.asarray([1.0, float(prefill_tokens), float(decode_tokens)])
        return float(max(0.0, self._coef @ x))

    def chunk_for(self, decode_tokens: int, target_ms: float,
                  lo: int, hi: int, rounds: int = 1) -> int:
        """Largest prefill chunk in [lo, hi] predicted to keep the step
        under ``target_ms``: untrained -> ``hi``; even ``lo`` over the
        target -> ``lo`` (prefills must progress).  Under an N-round
        fused dispatch (``rounds``) a waiting decode sees N rounds back
        to back, so each round gets ``target_ms / rounds``."""
        target_ms = target_ms / max(1, rounds)
        if not self.trained or target_ms <= 0 or hi <= lo:
            return hi
        if self.predict(hi, decode_tokens) <= target_ms:
            return hi
        if self.predict(lo, decode_tokens) > target_ms:
            return lo
        lo_b, hi_b = lo, hi          # invariant: lo_b under, hi_b over
        while lo_b + 1 < hi_b:
            mid = (lo_b + hi_b) // 2
            if self.predict(mid, decode_tokens) <= target_ms:
                lo_b = mid
            else:
                hi_b = mid
        return lo_b


class TransferCostModel:
    """KV restore-link cost model for transfer-aware placement:

        restore_ms(source)  ~=  setup + nbytes / rate(source)

    one rate per link class — ``peer`` (replica-to-replica over the
    data-plane interconnect) and ``host`` (shared host-offload tier) —
    from the LLMD_KV_TRANSFER_* knobs: the analytic prior of the JAX
    package's model, which nothing in the port calibrates yet.
    """

    SOURCES = ("peer", "host")

    def __init__(self, peer_gbps: Optional[float] = None,
                 host_gbps: Optional[float] = None,
                 setup_ms: Optional[float] = None) -> None:
        self.peer_gbps = (env_float("LLMD_KV_TRANSFER_PEER_GBPS", 16.0)
                          if peer_gbps is None else float(peer_gbps))
        self.host_gbps = (env_float("LLMD_KV_TRANSFER_HOST_GBPS", 64.0)
                          if host_gbps is None else float(host_gbps))
        self.setup_ms = (env_float("LLMD_KV_TRANSFER_SETUP_MS", 2.0)
                         if setup_ms is None else float(setup_ms))

    def restore_ms(self, nbytes: int, source: str = "peer") -> float:
        """Predicted wall-clock (ms) to restore ``nbytes`` from a link
        class (an unknown class is priced as ``peer``)."""
        if nbytes <= 0:
            return 0.0
        gbps = self.host_gbps if source == "host" else self.peer_gbps
        # bytes -> ms over a gigabit/s link: nbytes * 8 / (gbps * 1e9) s.
        return self.setup_ms + float(nbytes) * 8e-6 / max(gbps, 1e-6)
