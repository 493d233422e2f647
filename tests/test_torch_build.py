"""The port's kernel build helper (echo_tts_tpu_torch.ops._build) on the CPU:
a library's file name is a hash of its `.cu` and of every `csrc/*.cuh` that
source includes, so an edited shared header rebuilds what depends on it; and
every quoted include of the real sources names a file that is there. nvcc
itself runs only on the card (chip_smoke.py builds every source)."""
import pytest

from echo_tts_tpu_torch.ops import _build


@pytest.fixture
def csrc(tmp_path, monkeypatch):
    (tmp_path / "a.cu").write_text('#include <cuda.h>\n#include "core.cuh"\nint a;\n')
    (tmp_path / "b.cu").write_text("int b;\n")
    (tmp_path / "core.cuh").write_text('  #  include "inner.cuh"\nint core;\n')
    (tmp_path / "inner.cuh").write_text("int inner;\n")
    (tmp_path / "other.cuh").write_text("int other;\n")
    monkeypatch.setattr(_build, "CSRC", tmp_path)
    return tmp_path


def test_source_files_follow_quoted_includes(csrc):
    assert [p.name for p in _build.source_files("a")] == ["a.cu", "core.cuh", "inner.cuh"]
    assert [p.name for p in _build.source_files("b")] == ["b.cu"]


@pytest.mark.parametrize("edited,rebuilds_a", [("a.cu", True), ("core.cuh", True),
                                               ("inner.cuh", True), ("other.cuh", False),
                                               ("b.cu", False)])
def test_lib_path_changes_with_every_file_the_source_includes(csrc, edited, rebuilds_a):
    before_a, before_b = _build._lib_path("a"), _build._lib_path("b")
    with open(csrc / edited, "a") as f:
        f.write("// edited\n")
    assert (_build._lib_path("a") != before_a) == rebuilds_a
    assert (_build._lib_path("b") != before_b) == (edited == "b.cu")
    assert _build._lib_path("a").parent == _build.BUILD_DIR
    assert _build._lib_path("a").name.startswith("liba-")


@pytest.mark.parametrize("name", _build.KERNELS)
def test_every_quoted_include_exists(name):
    files = _build.source_files(name)
    assert files[0] == _build.CSRC / f"{name}.cu"
    for path in files:
        assert path.is_file(), path
        for inc in _build.local_includes(path):
            assert (_build.CSRC / inc).is_file(), f"{path.name} includes {inc}"


def test_attention_kernels_share_the_core_header():
    for name in ("joint_attention", "joint_attention_bwd", "joint_attention_variants",
                 "attention_core_check"):
        assert _build.CSRC / "attention_core.cuh" in _build.source_files(name)
    assert sorted(p.stem for p in _build.CSRC.glob("*.cu")) == sorted(_build.KERNELS)


@pytest.mark.parametrize("name", ["res_chain", "res_chain_variants", "conv_core_check"])
def test_conv_kernels_share_the_conv_core_header(name):
    """K2, K2v-cl and the conv core's bare check stand on conv_core.cuh,
    which stands on attention_core.cuh: an edit of either rebuilds them."""
    files = _build.source_files(name)
    assert _build.CSRC / "conv_core.cuh" in files
    assert _build.CSRC / "attention_core.cuh" in files


@pytest.mark.parametrize("name", ["trunk_rows", "trunk_rows_bwd"])
def test_trunk_row_kernels_share_their_header(name):
    """K6-K8 and their backward kernels stand on trunk_rows.cuh (the shapes
    and the bf16 packing): an edit of it rebuilds both."""
    assert _build.CSRC / "trunk_rows.cuh" in _build.source_files(name)
