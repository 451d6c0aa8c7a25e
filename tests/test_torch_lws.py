"""One spmd mesh across the hosts of a LeaderWorkerSet group (the wide-EP
recipe's shape, ``deploy/wide-ep-lws``): two entry points
(``python -m llm_d_tpu_torch.server.openai --data-parallel-size 2
--tensor-parallel-size 2 --device cpu``) on loopback with
``LWS_LEADER_ADDRESS=127.0.0.1:<port>``, ``LWS_GROUP_SIZE=2`` and
``LWS_WORKER_INDEX`` 0 and 1, each starting its two gloo ranks of the
four-rank mesh.

* The leader's greedy replies (token ids of its SSE frames) equal the JAX
  stacked engine's tokens at dp = tp = 2 on the same weights (the port's
  seeded init, carried to JAX), exactly, on ``tiny-moe`` and ``tiny-mla``
  (int8 experts, int8 latent); each request is served alone on both
  sides.
* The worker host answers ``/health`` and ``/v1/models`` on its port and
  nothing else (no completions, no metrics).
* SIGTERM to the leader drains it and stops the mesh: both entry points
  and all four ranks exit 0.  Killing the leader makes the worker exit
  non-zero within its deadline instead of hanging.
* The flags against the group, by the JAX server's arithmetic: the
  recipe's dp = 2 x tp = 8 on two hosts gives each host 8 ranks (global
  rank ``LWS_WORKER_INDEX * 8 + r``) joined at the leader on port 8476; a
  mesh that does not divide over the group and a contradicting
  ``--data-parallel-size-local`` are refused by name; without a group
  (or in ranks mode) no host joins one.
"""

import json
import os
import signal
import subprocess
import sys
import time
from pathlib import Path

import pytest
import requests
import torch

from llm_d_tpu_torch.engine import EngineConfig, EngineCore

from test_torch_tp_server import _alive, _children, _free_port

# One intra-op thread: these tests' tensors are tiny, and the suite's
# parallel workers, each with a thread pool as wide as the machine, would
# oversubscribe its cores (the pools' waiting threads spin).
torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]
ENGINE = dict(block_size=4, num_blocks=64, max_num_seqs=8,
              max_num_batched_tokens=64)
MODELS = {"tiny-moe": {}, "tiny-mla": dict(quantization="int8",
                                           kv_cache_dtype="int8")}
DP, TP = 2, 2
PROMPTS = [[2, 4, 6, 8, 10], [100, 90, 80, 70, 60, 50, 40]]
NEW = 5
TIMEOUT = 60


def _flags(model):
    kw = dict(ENGINE, **MODELS[model])
    return ["--model", model, "--device", "cpu", "--host", "127.0.0.1",
            "--data-parallel-size", str(DP), "--tensor-parallel-size",
            str(TP)] + [a for k, v in kw.items()
                        for a in ("--" + k.replace("_", "-"), str(v))]


class _Host:
    """One entry point of the group, in a session of its own (so its
    ranks can be found and killed with it)."""

    def __init__(self, model, leader_port, index, name):
        self.port = _free_port()
        self.url = f"http://127.0.0.1:{self.port}"
        env = {k: v for k, v in os.environ.items()
               if not k.startswith("LWS_")}
        env.update(PYTHONPATH=str(ROOT), OMP_NUM_THREADS="1",
                   MKL_NUM_THREADS="1", LLMD_DRAIN_TIMEOUT_S="20",
                   LWS_LEADER_ADDRESS=f"127.0.0.1:{leader_port}",
                   LWS_GROUP_SIZE="2", LWS_WORKER_INDEX=str(index))
        self.log_path = ROOT / "build" / f"test_lws_{name}_{os.getpid()}.log"
        self.log_path.parent.mkdir(exist_ok=True)
        self._log = open(self.log_path, "wb")
        self.proc = subprocess.Popen(
            [sys.executable, "-m", "llm_d_tpu_torch.server.openai",
             *_flags(model), "--port", str(self.port)], env=env,
            cwd=str(ROOT), stdout=self._log, stderr=subprocess.STDOUT,
            start_new_session=True)

    def wait_ready(self, deadline):
        while time.monotonic() < deadline:
            assert self.proc.poll() is None, self.log()
            try:
                if requests.get(self.url + "/v1/models",
                                timeout=5).status_code == 200:
                    return
            except requests.ConnectionError:
                pass
            time.sleep(0.2)
        raise TimeoutError(self.log())

    def log(self) -> str:
        self._log.flush()
        return self.log_path.read_text(errors="replace")[-4000:]

    def close(self):
        try:
            os.killpg(self.proc.pid, signal.SIGKILL)
        except ProcessLookupError:
            pass
        self.proc.wait(timeout=30)
        self._log.close()
        self.log_path.unlink(missing_ok=True)


@pytest.fixture(scope="module")
def groups():
    """A leader and a worker host for each model, all started at once."""
    out = {}
    for model in MODELS:
        port = _free_port()
        out[model] = (_Host(model, port, 0, f"{model}_leader"),
                      _Host(model, port, 1, f"{model}_worker"))
    try:
        deadline = time.monotonic() + 120
        for hosts in out.values():
            for h in hosts:
                h.wait_ready(deadline)
        yield out
    finally:
        for hosts in out.values():
            for h in hosts:
                h.close()


def _ranks(pid):
    """The rank processes among ``pid``'s children (not multiprocessing's
    resource tracker)."""
    return [c for c in _children(pid)
            if b"resource_tracker" not in Path(
                f"/proc/{c}/cmdline").read_bytes()]


def _stream_tokens(url, prompt):
    r = requests.post(url + "/v1/completions", json=dict(
        prompt=prompt, max_tokens=NEW, temperature=0.0, ignore_eos=True,
        stream=True), stream=True, timeout=TIMEOUT)
    assert r.status_code == 200
    frames = [json.loads(ln[6:]) for ln in r.iter_lines()
              if ln.startswith(b"data: ") and ln != b"data: [DONE]"]
    return [t for f in frames if "llmd" in f for t in f["llmd"]["tok"]]


def _jax_tokens(devices, model):
    """The JAX stacked engine at dp = tp = 2 on the servers' weights (the
    port's one-device init at the same seed: a mesh's ranks keep their
    shards of the same draws), one request at a time."""
    import jax.numpy as jnp
    from llm_d_tpu.engine.engine import EngineConfig as JEngineConfig
    from llm_d_tpu.engine.engine import EngineCore as JEngineCore
    from llm_d_tpu.engine.request import Request as JRequest
    from llm_d_tpu.ops.sampling import SamplingParams as JSamplingParams
    from llm_d_tpu.parallel.mesh import MeshConfig as JMeshConfig

    def to_jax(t):
        if isinstance(t, dict):
            return {k: to_jax(v) for k, v in t.items()}
        if t.dtype == torch.bfloat16:
            return jnp.asarray(t.view(torch.uint16).numpy()).view(
                jnp.bfloat16)
        return jnp.asarray(t.numpy())

    kw = dict(ENGINE, **MODELS[model])
    params = EngineCore(EngineConfig(model=model, device="cpu",
                                     **kw)).params
    e = JEngineCore(JEngineConfig(model=model, mesh=JMeshConfig(dp=DP, tp=TP),
                                  allow_device_subset=True, **kw),
                    params=to_jax(params), devices=list(devices)[:DP * TP])
    out = []
    for i, p in enumerate(PROMPTS):
        out.append(e.generate([JRequest(
            request_id=f"j{i}", prompt_token_ids=list(p),
            sampling=JSamplingParams(temperature=0.0, max_tokens=NEW,
                                     ignore_eos=True))])[f"j{i}"])
    return out


@pytest.mark.parametrize("model", sorted(MODELS))
def test_leader_replies_equal_the_jax_stacked_engine(groups, devices,
                                                     model):
    leader, _ = groups[model]
    got = [_stream_tokens(leader.url, p) for p in PROMPTS]
    assert got == _jax_tokens(devices, model)
    assert all(len(t) == NEW for t in got)


def test_the_worker_answers_its_probes_and_nothing_else(groups):
    leader, worker = groups["tiny-moe"]
    r = requests.get(worker.url + "/health", timeout=TIMEOUT)
    assert (r.status_code, r.text) == (200, "ok")
    models = requests.get(worker.url + "/v1/models", timeout=TIMEOUT)
    assert models.status_code == 200
    assert [m["id"] for m in models.json()["data"]] == ["tiny-moe"] == \
        [m["id"] for m in requests.get(leader.url + "/v1/models",
                                       timeout=TIMEOUT).json()["data"]]
    for method, path in (("POST", "/v1/completions"),
                         ("POST", "/v1/chat/completions"),
                         ("GET", "/metrics"), ("POST", "/admin/drain")):
        r = requests.request(method, worker.url + path, json={
            "prompt": [1, 2], "max_tokens": 2}, timeout=TIMEOUT)
        assert r.status_code == 404, (path, r.status_code)
    # Its two ranks are its own children; the leader holds rank 0 and 1.
    assert len(_ranks(worker.proc.pid)) == 2
    assert len(_ranks(leader.proc.pid)) == 1


def test_sigterm_on_the_leader_stops_every_rank_with_exit_0(groups):
    leader, worker = groups["tiny-moe"]
    ranks = _ranks(leader.proc.pid) + _ranks(worker.proc.pid)
    assert len(ranks) == 3
    leader.proc.send_signal(signal.SIGTERM)
    assert leader.proc.wait(timeout=60) == 0, leader.log()
    assert worker.proc.wait(timeout=60) == 0, worker.log()
    deadline = time.monotonic() + 10
    while any(_alive(p) for p in ranks) and time.monotonic() < deadline:
        time.sleep(0.1)
    assert not [p for p in ranks if _alive(p)]


def test_a_dead_leader_makes_the_worker_exit_non_zero(groups):
    leader, worker = groups["tiny-mla"]
    assert worker.proc.poll() is None
    os.kill(leader.proc.pid, signal.SIGKILL)
    leader.proc.wait(timeout=10)
    t0 = time.monotonic()
    code = worker.proc.wait(timeout=30)
    assert code != 0, worker.log()
    assert time.monotonic() - t0 < 30
    assert "exited with code" in worker.log()


# ---------- the flags against the group ----------

RECIPE = ["--data-parallel-size", "2", "--tensor-parallel-size", "8"]
SMALL = ["--data-parallel-size", "2", "--tensor-parallel-size", "2"]


@pytest.mark.parametrize("flags,env,want", [
    # The recipe's shape: one dp row (8 ranks) a host, global rank
    # index * 8 + r, joined at the leader's name on JAX's port.
    (RECIPE, {"LWS_LEADER_ADDRESS": "wide-ep-decode-0",
              "LWS_GROUP_SIZE": "2", "LWS_WORKER_INDEX": "1"},
     dict(world=16, local=8, first=8, address="wide-ep-decode-0:8476")),
    (RECIPE, {"LWS_LEADER_ADDRESS": "wide-ep-decode-0",
              "LWS_GROUP_SIZE": "2", "LWS_WORKER_INDEX": "0"},
     dict(world=16, local=8, first=0, address="wide-ep-decode-0:8476")),
    (SMALL + ["--data-parallel-size-local", "1"],
     {"LWS_LEADER_ADDRESS": "10.0.0.1:9000", "LWS_GROUP_SIZE": "2",
      "LWS_WORKER_INDEX": "1"},
     dict(world=4, local=2, first=2, address="10.0.0.1:9000")),
    # Tensor parallelism alone joins too (the JAX server's else branch).
    (["--tensor-parallel-size", "4"],
     {"LWS_LEADER_ADDRESS": "lead", "LWS_GROUP_SIZE": "2",
      "LWS_WORKER_INDEX": "1"},
     dict(world=4, local=2, first=2, address="lead:8476")),
    # No group, or a group of one host: this host serves the whole mesh.
    (SMALL + ["--data-parallel-size-local", "1"], {}, None),
    (SMALL, {"LWS_LEADER_ADDRESS": "lead", "LWS_GROUP_SIZE": "1"}, None),
    # Ranks mode across hosts keeps independent hosts.
    (["--data-parallel-size", "2", "--data-parallel-mode", "ranks",
      "--data-parallel-size-local", "1"],
     {"LWS_LEADER_ADDRESS": "lead", "LWS_GROUP_SIZE": "2",
      "LWS_WORKER_INDEX": "1"}, None)],
    ids=["recipe_worker", "recipe_leader", "size_local", "tp_only",
         "no_group", "group_of_one", "ranks_mode"])
def test_the_group_layout_follows_the_jax_servers_arithmetic(
        flags, env, want, monkeypatch, capsys):
    from llm_d_tpu.parallel.mesh import lws_distributed_args as jlws
    from llm_d_tpu_torch.server import openai as TServer
    for k in ("LWS_LEADER_ADDRESS", "LWS_GROUP_SIZE", "LWS_WORKER_INDEX"):
        monkeypatch.delenv(k, raising=False)
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    p = TServer.build_arg_parser()
    args = p.parse_args(["--model", "tiny-moe"] + flags)
    TServer.check_served(p, args)
    TServer.check_mesh_flags(p, args)
    assert capsys.readouterr().err == ""
    layout = TServer.lws_layout_from_args(args)
    if want is None:
        assert layout is None
        return
    j = jlws()
    # JAX's devices are process-major: process i holds global devices
    # i * local .. i * local + local - 1 of the row-major mesh.
    assert layout.hosts == j["num_processes"]
    assert layout.first == j["process_id"] * layout.local
    assert layout.address == j["coordinator_address"]
    assert dict(world=layout.world, local=layout.local, first=layout.first,
                address=layout.address) == want
    assert layout.leader == (layout.first == 0)


@pytest.mark.parametrize("flags,group,named", [
    (SMALL, "3", "LWS_GROUP_SIZE=3"),
    (RECIPE, "32", "LWS_GROUP_SIZE=32"),
    (SMALL + ["--data-parallel-size-local", "2"], "2",
     "--data-parallel-size-local 2 contradicts"),
    (["--data-parallel-size", "4", "--tensor-parallel-size", "2",
      "--data-parallel-size-local", "1"], "2",
     "--data-parallel-size-local 1 contradicts")],
    ids=["group_not_dividing", "recipe_over_32_hosts", "local_too_big",
         "local_too_small"])
def test_what_contradicts_the_group_is_refused_by_name(flags, group, named,
                                                      monkeypatch, capsys):
    from llm_d_tpu_torch.server import openai as TServer
    monkeypatch.setenv("LWS_LEADER_ADDRESS", "lead")
    monkeypatch.setenv("LWS_GROUP_SIZE", group)
    monkeypatch.setenv("LWS_WORKER_INDEX", "0")
    p = TServer.build_arg_parser()
    args = p.parse_args(["--model", "tiny-moe"] + flags)
    with pytest.raises(SystemExit) as e:
        TServer.check_mesh_flags(p, args)
    assert e.value.code == 2
    assert named in capsys.readouterr().err
