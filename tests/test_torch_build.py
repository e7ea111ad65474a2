"""The kernel build's cache key (``repro_torch.kernels.build._target``):
a library is named by a hash of its source, of every header in ``csrc``
and of the flags, so a changed header can never load a stale library.
Runs on the CPU: nothing is compiled."""
import shutil

import pytest

from repro_torch.kernels import build
from torch_dist_workers import torch_threads as torch_threads  # noqa


@pytest.fixture
def csrc(tmp_path, monkeypatch):
    """A private copy of ``csrc`` that the build module hashes."""
    copy = tmp_path / "csrc"
    shutil.copytree(build.CSRC, copy)
    monkeypatch.setattr(build, "CSRC", copy)
    return copy


def _targets():
    return {name: build._target(name) for name in build.SOURCES}


def test_target_is_stable_and_per_source(csrc):
    first = _targets()
    assert first == _targets()
    assert len(set(first.values())) == len(build.SOURCES)
    assert all(p.parent == build.BUILD_DIR for p in first.values())


@pytest.mark.parametrize("header", ["codec.cuh", "gemm_sm90.cuh"])
def test_target_changes_with_every_header(csrc, header):
    before = _targets()
    path = csrc / header
    path.write_text(path.read_text() + "\n// changed\n")
    after = _targets()
    assert all(after[n] != before[n] for n in build.SOURCES)


def test_target_changes_with_a_new_header(csrc):
    before = _targets()
    (csrc / "extra.cuh").write_text("#pragma once\n")
    assert all(build._target(n) != before[n] for n in build.SOURCES)


def test_target_changes_with_its_source_only(csrc):
    before = _targets()
    path = csrc / "tiled_mm.cu"
    path.write_text(path.read_text() + "\n// changed\n")
    after = _targets()
    assert after["tiled_mm"] != before["tiled_mm"]
    assert all(after[n] == before[n] for n in build.SOURCES
               if n != "tiled_mm")
