"""The YAML subset loader/dumper (config/yaml_subset.py) against PyYAML,
kept as a test-only oracle: every file under conf/, CLI override values and
the chunk_info.yaml round trip."""

import glob
import math
import os

import pytest

from tomosar2height_jax.config import yaml_subset
from tomosar2height_jax.config.compose import default_conf_dir

yaml = pytest.importorskip("yaml")

CONF_FILES = sorted(os.path.relpath(p, default_conf_dir()) for p in
                    glob.glob(os.path.join(default_conf_dir(), "**", "*.yaml"),
                              recursive=True))


def _same(a, b) -> bool:
    """Equal values of equal types (nan == nan)."""
    if isinstance(a, float) and isinstance(b, float) and math.isnan(a) and math.isnan(b):
        return True
    if type(a) is not type(b):
        return False
    if isinstance(a, dict):
        return a.keys() == b.keys() and all(_same(a[k], b[k]) for k in a)
    if isinstance(a, list):
        return len(a) == len(b) and all(_same(x, y) for x, y in zip(a, b))
    return a == b


def test_conf_tree_is_covered():
    assert len(CONF_FILES) >= 6


@pytest.mark.parametrize("name", CONF_FILES)
def test_conf_file_matches_pyyaml(name):
    path = os.path.join(default_conf_dir(), name)
    with open(path) as f:
        want = yaml.safe_load(f)
    assert _same(yaml_subset.load_file(path), want)


OVERRIDE_VALUES = [
    "true", "False", "yes", "off", "null", "~", "", "0", "-3", "+7", "010",
    "0x1F", "0b101", "1_000", "1:30", "1.5", "0.", ".5", "-2.5e-3", "1.0e+5",
    "1e-4", ".inf", "-.Inf", ".nan", "float32", "bfloat16", "cumsum",
    "outputs/city/raster/ndsm.tif", "data/munich/generated", "'quoted # not a comment'",
    '"tab\\tand \\u00e9"', "''", "[16384]", "[0,1,2]", "[0.0, 640.0, 1280.0]",
    "[]", "[a, 'b c', [1, 2.5], null]", "{}", "{a: 1, b: [1, 2], c: x}",
    "value # trailing comment", "a: 1",
]


@pytest.mark.parametrize("text", OVERRIDE_VALUES)
def test_override_value_matches_pyyaml(text):
    assert _same(yaml_subset.load(text), yaml.safe_load(text))


def _chunk_info():
    return {
        0: {"name": "chunk_000", "min_bound": [0.0, 5000000.0, -10.0],
            "max_bound": [640.0, 5000640.0, 70.25]},
        1: {"name": "chunk_001", "min_bound": [640.0, 5000000.0, 1e-05],
            "max_bound": [1280.0, 5000640.0, 123456789.125]},
        10: {"name": "it's 2", "min_bound": [-1.5e16, 0.1], "max_bound": [2.0, 3.0]},
    }


def test_chunk_info_round_trip():
    text = yaml_subset.dump(_chunk_info())
    assert _same(yaml.safe_load(text), _chunk_info())
    assert _same(yaml_subset.load(text), _chunk_info())


def test_reads_pyyaml_chunk_info():
    # the layout older builds wrote (PyYAML safe_dump, flow-style leaves)
    text = yaml.safe_dump(_chunk_info(), default_flow_style=None, allow_unicode=True)
    assert _same(yaml_subset.load(text), _chunk_info())


def test_builder_writes_readable_chunk_info(tmp_path):
    """The dataset builder's chunk_info.yaml reads back equal with both."""
    import sys

    sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "scripts"))
    import make_synthetic_city as msc

    from tomosar2height_jax.config import compose
    from tomosar2height_jax.data import build_dataset

    root = str(tmp_path)
    msc.main(root, seed=0, density=0.02)
    cfg = compose(default_conf_dir(), overrides=[
        "dataset=synthetic", f"gt_dsm={root}/raster/ndsm.tif",
        f"input_pointcloud_folder={root}/cloud",
        f"mask_files.building={root}/raster/footprint.tif",
        f"output.output_folder={root}/generated",
        "output.save_visualization_pc=false"])
    info = build_dataset(cfg, overwrite=True)
    path = f"{root}/generated/chunk_info.yaml"
    with open(path) as f:
        on_disk = yaml.safe_load(f)
    assert _same(yaml_subset.load_file(path), on_disk)
    assert _same(on_disk, {int(k): v for k, v in info.items()})


@pytest.mark.parametrize("text", [
    "a: &anchor 1", "b: *anchor", "c: !!str 1", "d: |\n  block", "- x\n---\n- y",
])
def test_unsupported_syntax_raises(text):
    with pytest.raises(ValueError):
        yaml_subset.load(text)
