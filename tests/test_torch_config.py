"""The port's own copy of the config tree against the JAX package's originals.

``bubbleformer_tpu_torch/config/`` keeps ``default.yaml`` and the
``data_cfg``, ``model_cfg``, ``optim_cfg``, ``scheduler_cfg`` and
``mesh_cfg`` groups.  Each copy must equal its original key for key, so
that an edit to one side shows here; and packaging must ship the copies
with the package.
"""
import tomllib
from pathlib import Path

import pytest
import yaml

from bubbleformer_tpu_torch.config import DEFAULT_CONFIG_DIR

REPO = Path(__file__).resolve().parents[1]
JAX_DIR = REPO / "bubbleformer_tpu" / "config"
PORT_DIR = Path(DEFAULT_CONFIG_DIR)
GROUPS = ("data_cfg", "model_cfg", "optim_cfg", "scheduler_cfg", "mesh_cfg")


def _files(root: Path):
    return sorted(p.relative_to(root).as_posix() for p in root.glob("**/*.yaml"))


def test_port_reads_its_own_tree():
    assert PORT_DIR == REPO / "bubbleformer_tpu_torch" / "config"


def test_port_copies_every_group_but_the_mesh():
    """Every group now, the mesh too: the data-parallel mesh reads
    ``mesh_cfg`` (``parallel/mesh.py``), and each of its copies equals its
    original (``test_copy_equals_original``)."""
    want = [f for f in _files(JAX_DIR) if f.split("/")[0] in GROUPS or "/" not in f]
    assert _files(PORT_DIR) == want == _files(JAX_DIR)
    assert _files(PORT_DIR / "mesh_cfg") == ["dp_sp.yaml", "dp_tp.yaml", "single.yaml"]


@pytest.mark.parametrize("name", _files(PORT_DIR))
def test_copy_equals_original(name):
    with open(PORT_DIR / name, encoding="utf-8") as f:
        port = yaml.safe_load(f)
    with open(JAX_DIR / name, encoding="utf-8") as f:
        original = yaml.safe_load(f)
    assert port == original


def test_packaging_ships_the_yaml_files():
    with open(REPO / "pyproject.toml", "rb") as f:
        data = tomllib.load(f)["tool"]["setuptools"]["package-data"]
    patterns = data["bubbleformer_tpu_torch.config"]
    shipped = {p.relative_to(PORT_DIR).as_posix() for pat in patterns for p in PORT_DIR.glob(pat)}
    assert shipped == set(_files(PORT_DIR))
