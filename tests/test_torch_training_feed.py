"""Port parity: the latency predictor's training feed
(``--latency-training-url``) against the JAX server, into the JAX
package's training sidecar (``llm_d_tpu.predictor.server.TrainingServer``).

The paired servers (``test_torch_server._Pair``) each post to a sidecar
of their own.  After the same requests (streamed and not) the two
sidecars hold the same number of ``ttft`` and ``tpot`` samples with the
same feature keys and the same arrival features; each port sample's
``actual_ms`` is the reply's ``usage``.  A sidecar that does not answer
costs a request nothing: the post runs on a daemon thread with a 1 s
timeout.
"""

import socket
import threading
import time

from llm_d_tpu.predictor.server import TrainingServer
from llm_d_tpu_torch.engine import EngineConfig, EngineCore
from llm_d_tpu_torch.engine.request import Request
from llm_d_tpu_torch.ops.sampling import SamplingParams
from llm_d_tpu_torch.server import openai as TServer
from test_torch_server import _Pair, _serve_jax

import torch

# One intra-op thread: these tests' tensors are tiny, and the suite's
# parallel workers, each with a thread pool as wide as the machine, would
# oversubscribe its cores (the pools' waiting threads spin).
torch.set_num_threads(1)


def _samples(trainer, target):
    return list(trainer.store._samples[target])


def test_samples_equal_the_jax_servers():
    pair = _Pair("tiny")
    trainers = [TrainingServer(retrain_interval_s=60.0) for _ in range(2)]
    cars = [_serve_jax(t, ready_path="/healthz") for t in trainers]
    try:
        pair.jax_server.latency_training_url = cars[0].url
        pair.port_server.latency_training_url = cars[1].url
        body = dict(model="m", prompt=[2, 7, 1, 8], max_tokens=5,
                    temperature=0.0, ignore_eos=True)
        replies = []
        for stream in (False, True, False):
            j, t = pair.both("POST", "/v1/completions",
                             json=dict(body, stream=stream))
            if not stream:
                replies.append(t.json()["usage"])
        for _ in range(200):
            if all(len(_samples(t, "tpot")) == 3 for t in trainers):
                break
            time.sleep(0.02)
        for target in ("ttft", "tpot"):
            js, ts = (_samples(t, target) for t in trainers)
            assert len(ts) == len(js) == 3, target
            assert [sorted(f) for f, _ in ts] == [sorted(f) for f, _ in js]
            # The load each request met at arrival (one at a time: idle).
            assert [f for f, _ in ts] == [f for f, _ in js]
        key = {"ttft": "ttft_ms", "tpot": "avg_tpot_ms"}
        for target, field in key.items():
            actual = sorted(ms for _, ms in _samples(trainers[1], target))
            for usage in replies:
                assert usage[field] in actual
    finally:
        for c in cars:
            c.close()
        pair.close()


def test_a_sidecar_that_does_not_answer_holds_nothing():
    """Samples go out on one daemon thread: the caller returns at once,
    more samples start no more threads, and each post gives up after
    the 1 s timeout, so the queue drains."""
    silent = socket.socket()
    silent.bind(("127.0.0.1", 0))
    silent.listen(8)                  # accepts the connection, never answers
    try:
        eng = EngineCore(EngineConfig(device="cpu", model="tiny",
                                      block_size=8, num_blocks=16))
        server = TServer.build_server(None, engine=eng, model_name="m")
        server.latency_training_url = \
            f"http://127.0.0.1:{silent.getsockname()[1]}"
        req = Request(request_id="r", prompt_token_ids=[1, 2, 3],
                      sampling=SamplingParams(max_tokens=2))
        req.first_token_time = req.arrival_time + 0.01
        before = set(threading.enumerate())
        t0 = time.monotonic()
        for _ in range(3):
            server._post_training_sample(req, server._arrival_features(req))
        assert time.monotonic() - t0 < 0.5
        posts = [t for t in threading.enumerate() if t not in before]
        assert [t.name for t in posts] == ["latency-sample"]
        assert posts[0].daemon
        while not server._samples.empty() and time.monotonic() - t0 < 10:
            time.sleep(0.05)
        assert server._samples.empty()
        assert [t for t in threading.enumerate() if t not in before] == posts
    finally:
        silent.close()
