"""`ops/cuda_build.py` on the CPU: the library's name follows the source and
every shared header, and `build` says clearly when there is no `nvcc`."""

import os

import pytest

from instance_based_loc_tpu_torch.ops import cuda_build


@pytest.fixture
def csrc(tmp_path, monkeypatch):
    monkeypatch.setattr(cuda_build, "CSRC_DIR", str(tmp_path))
    monkeypatch.setattr(cuda_build, "BUILD_DIR", str(tmp_path / "_build"))
    (tmp_path / "k.cu").write_text('#include "common.cuh"\n')
    (tmp_path / "common.cuh").write_text("// helpers\n")
    return tmp_path


def test_library_path_changes_with_source_and_headers(csrc):
    first = cuda_build.library_path("k.cu")
    assert first == cuda_build.library_path("k.cu")
    assert os.path.basename(first).startswith("libk_")
    (csrc / "common.cuh").write_text("// helpers, edited\n")
    second = cuda_build.library_path("k.cu")
    assert second != first
    (csrc / "more.cuh").write_text("// another header\n")
    third = cuda_build.library_path("k.cu")
    assert third not in (first, second)
    (csrc / "k.cu").write_text('#include "common.cuh"\n// edited\n')
    assert cuda_build.library_path("k.cu") not in (first, second, third)


def test_build_raises_without_nvcc(csrc, monkeypatch):
    monkeypatch.setattr(cuda_build.shutil, "which", lambda name: None)
    monkeypatch.setenv("CUDA_HOME", str(csrc / "no_cuda"))
    with pytest.raises(RuntimeError, match="nvcc not found"):
        cuda_build.build("k.cu")
    assert not os.path.exists(cuda_build.BUILD_DIR)
