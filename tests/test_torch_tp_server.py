"""The port's server on a mesh: ``python -m llm_d_tpu_torch.server.openai
--tensor-parallel-size 2 --device cpu`` (rank 0 starts rank 1 itself).

* Its replies (token-id and text prompts, a streamed one) equal the
  one-rank server's on the same flags (the same seed, so the same
  weights: the tp ranks keep their shards of the same draws).
* SIGTERM drains and stops every rank: exit code 0 and no rank process
  left.
* When a rank dies, ``/health`` fails and the server exits non-zero
  instead of serving on with fewer ranks.
"""

import json
import os
import signal
import socket
import subprocess
import sys
import time
from pathlib import Path

import pytest
import requests

import torch

# One intra-op thread: these tests' tensors are tiny, and the suite's
# parallel workers, each with a thread pool as wide as the machine, would
# oversubscribe its cores (the pools' waiting threads spin).
torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]
FLAGS = ["--model", "tiny", "--device", "cpu", "--host", "127.0.0.1",
         "--block-size", "8", "--num-blocks", "64",
         "--max-num-batched-tokens", "64"]
GREEDY = dict(temperature=0.0, ignore_eos=True)
TIMEOUT = 60


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _children(pid: int):
    """Live processes whose parent is ``pid``."""
    out = []
    for d in Path("/proc").iterdir():
        if not d.name.isdigit():
            continue
        try:
            stat = (d / "stat").read_text()
        except OSError:
            continue
        fields = stat.rsplit(")", 1)[1].split()
        if int(fields[1]) == pid and fields[0] != "Z":
            out.append(int(d.name))
    return out


def _alive(pid: int) -> bool:
    try:
        stat = Path(f"/proc/{pid}/stat").read_text()
    except OSError:
        return False
    return stat.rsplit(")", 1)[1].split()[0] != "Z"


class _Server:
    def __init__(self, extra=()):
        self.port = _free_port()
        self.url = f"http://127.0.0.1:{self.port}"
        env = dict(os.environ, PYTHONPATH=str(ROOT), OMP_NUM_THREADS="1",
                   MKL_NUM_THREADS="1", LLMD_DRAIN_TIMEOUT_S="20")
        self.proc = subprocess.Popen(
            [sys.executable, "-m", "llm_d_tpu_torch.server.openai", *FLAGS,
             "--port", str(self.port), *extra], env=env, cwd=str(ROOT),
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT)

    def wait_ready(self):
        for _ in range(1200):
            assert self.proc.poll() is None, self.log()
            try:
                if requests.get(self.url + "/v1/models",
                                timeout=5).status_code == 200:
                    return
            except requests.ConnectionError:
                pass
            time.sleep(0.1)
        raise TimeoutError(self.log())

    def log(self) -> str:
        if self.proc.poll() is None:
            self.proc.kill()
            self.proc.wait(timeout=30)
        return self.proc.stdout.read().decode(errors="replace")[-4000:]

    def close(self):
        for pid in _children(self.proc.pid):
            os.kill(pid, signal.SIGKILL)
        if self.proc.poll() is None:
            self.proc.kill()
            self.proc.wait(timeout=30)
        self.proc.stdout.close()


@pytest.fixture(scope="module")
def servers():
    one, tp = _Server(), _Server(["--tensor-parallel-size", "2"])
    try:
        one.wait_ready()
        tp.wait_ready()
        yield one, tp
    finally:
        one.close()
        tp.close()


def _strip(body):
    return {k: v for k, v in body.items() if k not in ("id", "created")} \
        | {"usage": {k: v for k, v in body["usage"].items()
                     if not k.endswith("_ms")}}


def _frames(resp):
    return [json.loads(ln[6:]) if ln != b"data: [DONE]" else "DONE"
            for ln in resp.iter_lines() if ln.startswith(b"data: ")]


def test_tp_server_replies_equal_the_one_rank_server(servers):
    one, tp = servers
    assert requests.get(tp.url + "/health", timeout=TIMEOUT).status_code \
        == 200
    for prompt, n in (([1, 2, 3], 5), ([40, 41, 42, 43, 44, 45, 46], 9),
                      ("hello mesh", 6)):
        body = dict(GREEDY, prompt=prompt, max_tokens=n)
        a, b = (requests.post(s.url + "/v1/completions", json=body,
                              timeout=TIMEOUT) for s in (one, tp))
        assert a.status_code == b.status_code == 200
        assert _strip(b.json()) == _strip(a.json())
    body = dict(GREEDY, prompt=[9, 8, 7], max_tokens=6, stream=True)
    a, b = (_frames(requests.post(s.url + "/v1/completions", json=body,
                                  stream=True, timeout=TIMEOUT))
            for s in (one, tp))
    assert [f["llmd"]["tok"] for f in b[:-1]] == \
        [f["llmd"]["tok"] for f in a[:-1]]
    assert b[-1] == a[-1] == "DONE"


def test_sigterm_stops_every_rank_and_exits_0(servers):
    _, tp = servers
    ranks = _children(tp.proc.pid)
    assert ranks, "rank 1 is not a child of the server"
    tp.proc.send_signal(signal.SIGTERM)
    assert tp.proc.wait(timeout=60) == 0, tp.log()
    deadline = time.monotonic() + 10
    while any(_alive(p) for p in ranks) and time.monotonic() < deadline:
        time.sleep(0.1)
    assert not [p for p in ranks if _alive(p)]


def test_a_dead_rank_fails_health_and_the_server_exits_nonzero():
    srv = _Server(["--tensor-parallel-size", "2"])
    try:
        srv.wait_ready()
        ranks = _children(srv.proc.pid)
        assert ranks
        for pid in ranks:
            os.kill(pid, signal.SIGKILL)
        seen = None
        for _ in range(100):
            try:
                seen = requests.get(srv.url + "/health", timeout=5)
            except requests.ConnectionError:
                break
            if seen.status_code == 500:
                break
            time.sleep(0.05)
        assert seen is not None and seen.status_code == 500
        assert "rank" in seen.text
        assert srv.proc.wait(timeout=60) != 0
    finally:
        srv.close()
