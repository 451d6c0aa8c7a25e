"""Port parity: YAML config layers (``llm_d_tpu_torch.utils.config``
``deep_merge`` / ``load_layers`` / ``apply_file_config``, and the
server's ``--config`` / ``--config-overlay``) against
``llm_d_tpu.utils.config``, on YAML files the tests write.

* The merged layers equal the JAX package's (nested dicts merge, the
  later layer wins, lists replace), and a layer that is not a mapping is
  refused by both.
* Applied to the server's parsed flags, the layers set what the JAX
  server's parser gets from them, flags on the command line win (also
  when they equal their default, or are given as an abbreviation), and
  an unknown key is refused by both.
* A layer that sets an unserved flag is refused by ``check_served`` as
  the flag would be; without ``yaml`` the layers are a parser error
  naming it.
"""

import sys

import pytest

from llm_d_tpu.server import openai as JServer
from llm_d_tpu.utils import config as jconfig
from llm_d_tpu_torch.server import openai as TServer
from llm_d_tpu_torch.utils import config as tconfig

BASE = """
model: deepseek-v3-bench
quantization: int8
kv-cache-dtype: int8
block-size: 64
num-blocks: 576
max_num_seqs: 128
eplb-config: '{"window_size": 512}'
nested:
  a: 1
  b: {c: 2, d: [1, 2]}
"""
OVERLAY = """
num-blocks: 1024
num-scheduler-steps: 32
async-scheduling: true
nested:
  b: {d: [3], e: 4}
"""


@pytest.fixture()
def layers(tmp_path):
    paths = []
    for name, text in (("base.yaml", BASE), ("h100.yaml", OVERLAY)):
        path = tmp_path / name
        path.write_text(text)
        paths.append(str(path))
    return paths


def test_merged_layers_equal_the_jax_package(layers, tmp_path):
    merged = tconfig.load_layers(layers)
    assert merged == jconfig.load_layers(layers)
    assert merged["num-blocks"] == 1024
    assert merged["nested"] == {"a": 1, "b": {"c": 2, "d": [3], "e": 4}}
    assert tconfig.deep_merge({"x": {"y": 1}}, {"x": 2}) == \
        jconfig.deep_merge({"x": {"y": 1}}, {"x": 2}) == {"x": 2}
    bad = tmp_path / "list.yaml"
    bad.write_text("- 1\n- 2\n")
    for mod in (tconfig, jconfig):
        with pytest.raises(ValueError, match="must be a mapping"):
            mod.load_layers([str(bad)])


@pytest.mark.parametrize("cli", [
    [], ["--num-blocks", "64"], ["--num-block", "2048"],
    ["--block-size=32", "--port", "9000"]])
def test_file_config_on_the_flags_equals_the_jax_server(layers, cli):
    argv = ["--config", layers[0], "--config-overlay", layers[1]] + cli
    merged = {k: v for k, v in tconfig.load_layers(layers).items()
              if k != "nested"}
    tp, jp = TServer.build_arg_parser(), JServer.build_arg_parser()
    targs, jargs = tp.parse_args(argv), jp.parse_args(argv)
    tconfig.apply_file_config(targs, tp, merged, argv=argv)
    jconfig.apply_file_config(jargs, jp, merged, argv=argv)
    for dest in ("model", "quantization", "kv_cache_dtype", "block_size",
                 "num_blocks", "max_num_seqs", "num_scheduler_steps",
                 "async_scheduling", "eplb_config", "port"):
        assert getattr(targs, dest) == getattr(jargs, dest), dest
    cfg = TServer.engine_config_from_args(targs)
    assert (cfg.model, cfg.num_scheduler_steps, cfg.async_scheduling) == (
        "deepseek-v3-bench", 32, True)
    assert cfg.num_blocks == {"--num-blocks": 64, "--num-block": 2048}.get(
        cli[0] if cli else None, 1024)
    assert cfg.eplb_config == {"window_size": 512}
    with pytest.raises(ValueError, match="unknown config key"):
        tconfig.apply_file_config(targs, tp, {"nested": 1}, argv=argv)
    with pytest.raises(ValueError, match="unknown config key"):
        jconfig.apply_file_config(jargs, jp, {"nested": 1}, argv=argv)


def test_a_layer_that_sets_an_unserved_flag_is_refused(tmp_path, capsys):
    path = tmp_path / "dp.yaml"
    path.write_text("data-parallel-size: 2\n")
    argv = ["--config", str(path)]
    p = TServer.build_arg_parser()
    args = p.parse_args(argv)
    TServer.apply_config_layers(p, args, argv)
    assert args.data_parallel_size == 2
    with pytest.raises(SystemExit) as e:
        TServer.check_served(p, args)
    assert e.value.code == 2
    assert "--data-parallel-size" in capsys.readouterr().err


def test_without_yaml_the_layers_are_refused_by_name(layers, monkeypatch,
                                                      capsys):
    monkeypatch.setitem(sys.modules, "yaml", None)
    argv = ["--config", layers[0], "--config-overlay", layers[1]]
    p = TServer.build_arg_parser()
    with pytest.raises(SystemExit) as e:
        TServer.apply_config_layers(p, p.parse_args(argv), argv)
    assert e.value.code == 2
    err = capsys.readouterr().err
    assert "--config" in err and "yaml" in err
    with pytest.raises(ImportError):
        tconfig.load_layers(layers)
