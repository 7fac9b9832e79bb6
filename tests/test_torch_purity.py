"""The port stands alone: no JAX, kart_tpu, msgpack or click import (the
card's machine has neither of the last two), the card by default, a named
error instead of a fallback."""

import ast
import os
import subprocess
import sys
import types

import numpy as np
import pytest
import torch

import kart_tpu_torch
from kart_tpu_torch import runtime
from kart_tpu_torch.cli import main as cli_main
from kart_tpu_torch.diff import backend, engine
from kart_tpu_torch.events.cdc import dirty_tiles
from kart_tpu_torch.ops import _build, bbox
from kart_tpu_torch.ops.blocks import FeatureBlock
from kart_tpu_torch.spatial_filter import blob_filter_for_spec, envelope_prepass

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG = os.path.dirname(os.path.abspath(kart_tpu_torch.__file__))


def _port_files():
    files = [os.path.join(ROOT, "chip_smoke.py")]
    for d, dirs, names in os.walk(PKG):
        dirs[:] = [x for x in dirs if x != "_build"]  # kernel build output
        files += [os.path.join(d, n) for n in names if n.endswith(".py")]
    return sorted(files)


def _modules():
    mods = []
    for f in _port_files()[1:]:
        rel = os.path.relpath(f, ROOT)[:-3].replace(os.sep, ".")
        mods.append(rel[: -len(".__init__")] if rel.endswith(".__init__") else rel)
    return mods


FORBIDDEN = ("jax", "jaxlib", "kart_tpu", "msgpack", "click")


def _forbidden(name):
    return name.split(".")[0] in FORBIDDEN


@pytest.mark.parametrize("path", _port_files(), ids=lambda p: os.path.relpath(p, ROOT))
def test_no_jax_or_kart_tpu_imports(path):
    with open(path) as fh:
        tree = ast.parse(fh.read(), path)
    bad = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            bad += [a.name for a in node.names if _forbidden(a.name)]
        elif isinstance(node, ast.ImportFrom) and node.module and node.level == 0:
            if _forbidden(node.module):
                bad.append(node.module)
    assert not bad, f"{path} imports {bad}"


def test_walk_reaches_every_package():
    dirs = {os.path.relpath(os.path.dirname(f), PKG) for f in _port_files()[1:]}
    assert {".", "core", "models", "cli", "diff", "ops", "spatial_filter", "tiles",
            "events"} <= dirs
    assert {"kart_tpu_torch.cli.diff_cmds", "kart_tpu_torch.core.msgpack",
            "kart_tpu_torch.__main__", "kart_tpu_torch.crs", "kart_tpu_torch.epsg",
            "kart_tpu_torch.geom", "kart_tpu_torch.tiles.streams", "kart_tpu_torch.gridshift",
            "kart_tpu_torch.cli.spatial_cmds", "kart_tpu_torch.events.cdc",
            "kart_tpu_torch.cli.data_cmds"} <= set(_modules())


def test_imports_with_jax_and_kart_tpu_blocked():
    code = (
        "import sys\n"
        f"for m in {FORBIDDEN!r}:\n"
        "    sys.modules[m] = None\n"
        "import importlib\n"
        f"for m in {_modules()!r} + ['chip_smoke']:\n"
        "    importlib.import_module(m)\n"
        f"assert not any(k.split('.')[0] in {FORBIDDEN!r}"
        " for k, v in sys.modules.items() if v is not None)\n"
        "print('ok')\n"
    )
    r = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                       text=True, timeout=120)
    assert r.returncode == 0 and r.stdout.strip() == "ok", r.stderr


def _block():
    keys = np.arange(10, dtype=np.int64)
    blk = FeatureBlock.from_arrays(keys, np.zeros((10, 5), np.uint32))
    blk.envelopes = np.zeros((10, 4), np.float32)
    return blk


ENTRY_POINTS = {
    "select_backend": lambda: backend.select_backend(),
    "classify_changed": lambda: engine.classify_changed(_block(), _block()),
    "feature_count": lambda: engine.feature_count(_block(), _block()),
    "feature_count_rect": lambda: engine.feature_count(_block(), _block(), (0, 0, 1, 1)),
    "spatial_prefilter_blocks": lambda: engine.spatial_prefilter_blocks(
        _block(), _block(), (0, 0, 1, 1)),
    "bbox_intersects": lambda: bbox.bbox_intersects(np.zeros((3, 4)), (0, 0, 1, 1)),
    "envelope_prepass": lambda: envelope_prepass(ROOT, "0,0,1,1"),
    "blob_filter_for_spec": lambda: blob_filter_for_spec(types.SimpleNamespace(gitdir=ROOT),
                                                         "0,0,1,1"),
    "resolve_device": lambda: runtime.resolve_device(),
    "cli_main": lambda: cli_main(["-C", ROOT, "diff", "-o", "feature-count", "HEAD^...HEAD"]),
    "dirty_tiles": lambda: dirty_tiles(types.SimpleNamespace(gitdir=ROOT), None, None),
    "cli_log": lambda: cli_main(["-C", ROOT, "log", "-o", "json", "--with-dataset-changes"]),
    "cli_build_annotations": lambda: cli_main(["-C", ROOT, "build-annotations"]),
}


@pytest.mark.parametrize("name", sorted(ENTRY_POINTS))
def test_default_device_is_the_card(monkeypatch, name):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(runtime.DeviceUnavailable):
        ENTRY_POINTS[name]()


def test_cpu_only_on_request_and_no_other_devices():
    assert runtime.resolve_device("cpu") == torch.device("cpu")
    with pytest.raises(runtime.DeviceUnavailable):
        runtime.resolve_device("meta")
    with pytest.raises(runtime.DeviceUnavailable):
        backend.envelope_scan(torch.zeros((2, 4), device="meta"), (0, 0, 1, 1))


def test_build_raises_without_nvcc(monkeypatch, tmp_path):
    monkeypatch.delenv("CUDA_HOME", raising=False)
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setattr(_build, "DEFAULT_CUDA_HOME", str(tmp_path / "no-cuda"))
    monkeypatch.setattr(_build, "BUILD_ROOT", str(tmp_path / "build"))
    with pytest.raises(_build.NvccNotFound):
        _build.find_nvcc()
    with pytest.raises(_build.NvccNotFound):
        _build.build_all()
    assert issubclass(_build.NvccNotFound, _build.BuildError)


def test_chip_smoke_fails_without_card_or_repo(tmp_path):
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    r = subprocess.run([sys.executable, "chip_smoke.py", "--rows", "1000"], cwd=ROOT,
                       env=env, capture_output=True, text=True, timeout=120)
    assert r.returncode != 0 and '"ok"' not in r.stdout
    alone = tmp_path / "chip_smoke.py"
    with open(os.path.join(ROOT, "chip_smoke.py")) as fh:
        alone.write_text(fh.read())
    r = subprocess.run([sys.executable, "chip_smoke.py"], cwd=tmp_path, env=env,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode != 0 and '"ok"' not in r.stdout
