"""The kernels' build keys and return codes, on the CPU (no nvcc needed:
nothing here compiles)."""
import re

import pytest

from repro_torch.kernels import build


def test_every_source_and_local_include_is_in_csrc():
    for name in build.SOURCES:
        src = (build.CSRC / f"{name}.cu").read_text()
        for header in re.findall(r'#include "([^"]+)"', src):
            assert (build.CSRC / header).is_file(), (name, header)


def test_lib_path_follows_the_source_and_the_shared_headers(tmp_path,
                                                            monkeypatch):
    monkeypatch.setattr(build, "CSRC", tmp_path)
    (tmp_path / "k.cu").write_text('#include "h.cuh"\n')
    (tmp_path / "h.cuh").write_text("// v1\n")
    first = build.lib_path("k")
    assert build.lib_path("k") == first
    (tmp_path / "h.cuh").write_text("// v2\n")
    second = build.lib_path("k")
    assert second != first
    (tmp_path / "k.cu").write_text('#include "h.cuh"\n// edited\n')
    assert build.lib_path("k") not in (first, second)


@pytest.mark.parametrize("rc,message", [
    (1, "kernel launch failed: cudaError 1"),
    (700, "kernel launch failed: cudaError 700"),
    (build.ERR_TENSOR_MAP, "no cuTensorMapEncodeTiled in libcuda"),
    (build.ERR_TENSOR_MAP + 1, "tensor-map encode failed (CUresult 1)"),
    (build.ERR_MISALIGNED, "base address is not 16-byte aligned"),
])
def test_check_rc_raises_with_what_failed(rc, message):
    with pytest.raises(RuntimeError, match=re.escape(message)):
        build.check_rc(rc, "expert_gemm")


def test_check_rc_passes_zero():
    build.check_rc(0, "expert_gemm")


def test_return_codes_match_the_shared_header():
    header = (build.CSRC / "hopper.cuh").read_text()
    for name in ("ERR_TENSOR_MAP", "ERR_MISALIGNED"):
        found = re.search(rf"constexpr int {name} = (\d+);", header)
        assert found and int(found.group(1)) == getattr(build, name), name
