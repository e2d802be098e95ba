"""PyTorch port, the config layer against the JAX package and PyYAML: the
port's YAML reader gives ``yaml.safe_load``'s result on every shipped
config, ``load_config``, ``apply_overrides`` and ``set_hparams`` give the
JAX package's, and the config the port saves reads back the same through
both readers."""

import glob
import os

import pytest
import yaml

from speech_editing_tpu.config import hparams as jh
from speech_editing_tpu_torch.config import hparams as th
from tests.test_torch_threads import one_thread  # noqa: F401  (autouse fixture)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CONFIGS = sorted(os.path.relpath(p, REPO) for p in glob.glob(os.path.join(REPO, "egs", "*.yaml")))


def test_every_shipped_config_is_found():
    assert len(CONFIGS) == 16


@pytest.mark.parametrize("config", CONFIGS)
def test_yaml_reader_equals_safe_load(config):
    with open(os.path.join(REPO, config)) as f:
        text = f.read()
    cfg = th.parse_yaml(text, config)
    assert cfg == yaml.safe_load(text)
    assert th.parse_yaml(th.dump_yaml(cfg)) == cfg == yaml.safe_load(th.dump_yaml(cfg))


@pytest.mark.parametrize("config", CONFIGS)
def test_load_config_equals_jax(config, monkeypatch):
    monkeypatch.chdir(REPO)
    assert th.load_config(config) == jh.load_config(config)


@pytest.mark.parametrize("text", [
    "a: 1e-4\nb: 2.5e-3\nc: 017\nd: 0x1F\ne: -.inf\nf: 3.\ng: 1_000\nh: ~\ni:",
    "a: yes\nb: Off\nc: 'it''s'\nd: \"x#y \\\" z\"  # comment\ne: x:y\nf: -x",
    "a: [1, [2, \"b\", [3]], c d, 'e, f']\nb: []\nc: [ ]",
])
def test_yaml_scalars_resolve_as_safe_load(text):
    assert th.parse_yaml(text) == yaml.safe_load(text)


@pytest.mark.parametrize("text", [
    "a:\n  b: 1", "- 1", "a: {b: 1}", "a: &x 1", "a: !!str 1", "a: |", "a: 12:30",
    "a: 2001-12-14", "a: [1,", "a: [1 2]: 3", "a: 'x", "yes: 1", "a: [1, , 2]",
])
def test_yaml_beyond_the_subset_raises(text):
    with pytest.raises(th.YamlSubsetError):
        th.parse_yaml(text)


@pytest.mark.parametrize("overrides", [
    "", "lr=0.001,max_updates=70", "a.b=3,c=[1 2 3],d=true,e=none,f=x y",
    "dec_dilations=[1,2,3],name=abc", "x=-1,y=1.5e-3,z=[]",
])
def test_apply_overrides_equals_jax(overrides):
    base = {"lr": 2e-4, "a": {"b": 1, "k": 2}, "name": "n"}
    assert th.apply_overrides(dict(base, a=dict(base["a"])), overrides) == \
        jh.apply_overrides(dict(base, a=dict(base["a"])), overrides)


def _both(tmp_path, monkeypatch, argv):
    """set_hparams of the port and of JAX on the same arguments, each with
    its own work dir under ``tmp_path``; returns (port, jax) configs."""
    monkeypatch.chdir(REPO)
    out = []
    for side in ("port", "jax"):
        exp = str(tmp_path / side)
        args = [*argv, "--exp_name", exp]
        if side == "port":
            out.append(th.set_hparams(th.arg_parser().parse_args(args), print_hparams=False))
        else:
            out.append(dict(jh.set_hparams(argv=args, print_hparams=False,
                                           global_hparams=False)))
    for cfg in out:
        cfg.pop("work_dir"), cfg.pop("exp_name")
    return out


def test_set_hparams_equals_jax_and_saves_the_config(tmp_path, monkeypatch):
    argv = ["--config", "egs/spec_denoiser.yaml", "-hp", "use_bf16=False,max_updates=60"]
    port, jax_cfg = _both(tmp_path, monkeypatch, argv)
    assert port == jax_cfg and port["use_bf16"] is False and port["max_updates"] == 60
    saved = tmp_path / "port" / "config.yaml"
    assert th.read_yaml(str(saved)) == yaml.safe_load(saved.read_text())
    assert th.read_yaml(str(saved))["work_dir"] == str(tmp_path / "port")
    # the saved config wins over the file, the overrides over both; --reset
    # and --remove start from the file again
    (tmp_path / "port" / "marker").write_text("")
    for flags, lr in (([], 0.5), (["--reset"], 0.0002), (["--remove"], 0.0002)):
        saved_cfg = th.read_yaml(str(saved))
        saved.write_text(th.dump_yaml(dict(saved_cfg, lr=0.5)))
        (tmp_path / "jax" / "config.yaml").write_text(th.dump_yaml(dict(saved_cfg, lr=0.5)))
        port, jax_cfg = _both(tmp_path, monkeypatch,
                              ["--config", "egs/spec_denoiser.yaml", *flags, "-hp", "seed=7"])
        assert port == jax_cfg and port["lr"] == lr and port["seed"] == 7
    assert not (tmp_path / "port" / "marker").exists()
