"""The port's config system against the JAX package's: every shipped config
loads to the same dict, overrides parse to the same values, and the key
registry accepts and refuses the same keys."""

import glob
import json
import sys

import pytest

from x2vlm_tpu.core import config as jax_config  # noqa: E402
from x2vlm_tpu.core import config_schema as jax_schema  # noqa: E402
from x2vlm_tpu_torch.core import config as port_config  # noqa: E402
from x2vlm_tpu_torch.core import config_schema as port_schema  # noqa: E402

SHIPPED = sorted(glob.glob("configs/**/*.yaml", recursive=True))
# the override forms of the JAX package's tests and a few more
OVERRIDES = [
    "batch_size:64;optimizer.lr:2e-5",
    "lr:1e-4;flag:true;xs:[1,2]",
    "images.batch_size:64;schedular.epochs:3",
    "a.b.c:null;d:~;e:False;f:yes;g:off",
    "k:-3;m:+4;n:0;o:1.5;p:.5;q:-1.5e-3;r:3.0e+2;s:1e4;t:2E-2",
    "name:data/bert-base-uncased;u:'quoted: text';v:\"double\"",
    "xs:[a, b, 'c d'];ys:[1, 2.5, true, null];zs:[]",
    "m:{a: 1, b: [2, 3]};inf:.inf",
    " spaced : 7 ; trailing:;",
    "path:/abs/path.json;url:hdfs://x/y",
]


def test_every_shipped_config_is_found():
    assert len(SHIPPED) >= 20


@pytest.mark.parametrize("path", SHIPPED)
def test_shipped_configs_load_and_validate_alike(path):
    want = jax_config.load_config(path, overrides="batch_size:7;optimizer.lr:1e-4")
    got = port_config.load_config(path, overrides="batch_size:7;optimizer.lr:1e-4")
    assert got.to_dict() == want.to_dict()
    jax_bad = jax_schema.unknown_keys(want)
    assert port_schema.unknown_keys(got) == jax_bad


@pytest.mark.parametrize("override", OVERRIDES)
def test_overrides_parse_as_jax_with_pyyaml(override):
    assert port_config.parse_overrides(override) == jax_config.parse_overrides(override)


def test_yaml_file_without_pyyaml_names_it(monkeypatch, tmp_path):
    """PyYAML is imported only where YAML is read: a JSON config loads
    without it, a YAML file or an override raises naming it."""
    monkeypatch.setitem(sys.modules, "yaml", None)
    with pytest.raises(ImportError, match="PyYAML"):
        port_config.load_config(SHIPPED[0])
    p = tmp_path / "c.json"
    p.write_text(json.dumps({"a": {"b": 1}}))
    assert port_config.load_config(str(p), {"a.b": 2}).to_dict() == {"a": {"b": 2}}
    with pytest.raises(ImportError, match="PyYAML"):
        port_config.load_config(str(p), "a.b:2")


@pytest.mark.parametrize("cfg", [
    {"image_res": 224, "batch_size": 3},
    {"image_res": 224, "no_such_key": 1},
    {"images": {"batch_size": 8, "bogus": 1}},
    {"optimizer": {"lr": 1e-4, "momentum": 0.9}},
    {"text_config_inline": {"hidden_size": 32, "not_a_field": 1}},
    {"vision_config_inline": {"vision_width": 32, "weird": 2}},
    {"_comment": "ok", "schedular": {"epochs": 1, "_note": 2}},
])
def test_registry_accepts_and_refuses_the_same_keys(cfg):
    assert port_schema.unknown_keys(cfg) == jax_schema.unknown_keys(cfg)
    jax_raises = port_raises = False
    try:
        jax_schema.validate_config(cfg)
    except ValueError:
        jax_raises = True
    try:
        port_schema.validate_config(cfg)
    except ValueError:
        port_raises = True
    assert port_raises == jax_raises


def test_registry_is_the_jax_one():
    assert port_schema.TOP_LEVEL.keys() == jax_schema.TOP_LEVEL.keys()
    assert {k: set(v) for k, v in port_schema.BLOCKS.items()} == \
        {k: set(v) for k, v in jax_schema.BLOCKS.items()}
    assert port_schema.VISION_JSON.keys() == jax_schema.VISION_JSON.keys()
