"""The port's kernel build (learn_nerf_tpu_torch.kernels.build) with a
stand-in nvcc: one compile per source, then one link; the library is keyed
by the sources' digest; a failed compile raises and names its source."""

import os
import stat

import pytest

from learn_nerf_tpu_torch.kernels import build

FAKE_NVCC = """#!/usr/bin/env python3
import sys
args = sys.argv[1:]
out = args[args.index("-o") + 1]
inputs = [a for i, a in enumerate(args) if a.endswith((".cu", ".o")) and args[i - 1] != "-o"]
text = "".join(open(p).read() for p in inputs)
if "-c" in args and "broken" in text:
    print(inputs[0] + ": error: broken source")
    sys.exit(2)
with open(out, "w") as f:
    f.write(("linked " if "-shared" in args else "compiled ") + text)
"""


@pytest.fixture
def fake_toolchain(tmp_path, monkeypatch):
    nvcc = tmp_path / "cuda" / "bin" / "nvcc"
    nvcc.parent.mkdir(parents=True)
    nvcc.write_text(FAKE_NVCC)
    nvcc.chmod(nvcc.stat().st_mode | stat.S_IEXEC)
    csrc = tmp_path / "csrc"
    csrc.mkdir()
    (csrc / "a.cu").write_text("A;")
    (csrc / "b.cu").write_text("B;")
    (csrc / "common.cuh").write_text("H;")
    monkeypatch.setenv("CUDA_HOME", str(tmp_path / "cuda"))
    monkeypatch.setattr(build, "CSRC_DIR", csrc)
    monkeypatch.setattr(build, "BUILD_DIR", tmp_path / "_build")
    return csrc


def test_build_compiles_each_source_then_links(fake_toolchain, monkeypatch):
    lib = build.build()
    assert lib == build.library_dir() / build.LIB_NAME
    assert lib.read_text() == "linked compiled A;compiled B;"
    log = (lib.parent / "build.log").read_text()
    assert log.count(" -c ") == 2 and log.count("-shared") == 1
    assert sorted(os.listdir(lib.parent)) == ["build.log", build.LIB_NAME]  # objects removed
    # Built once per digest: no compiler is needed for the same sources.
    monkeypatch.setenv("CUDA_HOME", "/nonexistent")
    assert build.build() == lib


def test_changed_source_builds_anew_and_failures_name_the_source(fake_toolchain):
    first = build.library_dir()
    (fake_toolchain / "common.cuh").write_text("H2;")  # headers count in the digest
    assert build.library_dir() != first
    (fake_toolchain / "b.cu").write_text("broken")
    with pytest.raises(RuntimeError, match=r"b\.cu \(nvcc exit 2\)"):
        build.build()
    assert not (build.library_dir() / build.LIB_NAME).exists()
