"""The CUDA build's bookkeeping on the CPU (repro_torch/kernels/_build.py):
the library's name changes with every file the build reads, and the
compilers' reports are read right.  Nothing here compiles: there is no
nvcc on a machine without a card."""

import pytest

from repro_torch.kernels import _build


@pytest.fixture
def csrc(tmp_path, monkeypatch):
    (tmp_path / "a.cu").write_text('#include "common.cuh"\n')
    (tmp_path / "common.cuh").write_text("constexpr int X = 1;\n")
    monkeypatch.setattr(_build, "CSRC", tmp_path)
    return tmp_path


def test_sources_are_translation_units_inputs_every_file(csrc):
    assert [p.name for p in _build.sources()] == ["a.cu"]
    assert [p.name for p in _build.inputs()] == ["a.cu", "common.cuh"]


@pytest.mark.parametrize("edit", ["source", "header", "new_header"])
def test_library_name_follows_every_input(csrc, edit):
    before = _build.library_path()
    if edit == "source":
        (csrc / "a.cu").write_text('#include "common.cuh"\n// changed\n')
    elif edit == "header":
        (csrc / "common.cuh").write_text("constexpr int X = 2;\n")
    else:
        (csrc / "other.cuh").write_text("#pragma once\n")
    after = _build.library_path()
    assert after != before
    assert after.parent == before.parent
    assert _build.ptxas_report() == after.with_suffix(".ptxas.txt")


PTXAS = """\
ptxas info    : 0 bytes gmem
ptxas info    : Compiling entry function '_Z1kILi128EEvPf' for 'sm_90a'
ptxas info    : Function properties for _Z1kILi128EEvPf
    8 bytes stack frame, 68 bytes spill stores, 56 bytes spill loads
ptxas info    : Used 128 registers, used 1 barriers, 400 bytes cmem[0]
ptxas info    : Compiling entry function '_Z1kILi64EEvPf' for 'sm_90a'
ptxas info    : Function properties for _Z1kILi64EEvPf
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 96 registers, 400 bytes cmem[0]
"""

SASS = """\
\tcode for sm_90a
\t\tFunction : _Z1kILi128EEvPf
        /*0000*/                   LDC R1, c[0x0][0x28] ;
        /*0b30*/                   HMMA.16816.F32.BF16 R4, R12, R20, R4 ;
        /*0b40*/                   HMMA.16816.F32.BF16 R8, R12, R22, R8 ;
\t\tFunction : _Z1dILi64EEvPf
        /*0000*/                   FFMA R1, R2, R3, R1 ;
\t\tFunction : _Z1wILi64EEvPf
        /*0100*/                   HGMMA.64x64x16.F32.BF16 R24, gdesc[UR4], R24 ;
"""


def test_ptxas_usage_reads_registers_and_spills():
    assert _build.ptxas_usage(PTXAS) == {
        "_Z1kILi128EEvPf": {"registers": 128, "spill_stores": 68,
                            "spill_loads": 56},
        "_Z1kILi64EEvPf": {"registers": 96, "spill_stores": 0,
                           "spill_loads": 0}}


def test_sass_tensor_core_counts():
    assert _build.sass_tensor_core_counts(SASS) == {
        "_Z1kILi128EEvPf": 2, "_Z1dILi64EEvPf": 0, "_Z1wILi64EEvPf": 1}


@pytest.mark.parametrize("demangled,short", [
    ("void <unnamed>::decode_attention_kernel<__nv_bfloat16, (int)128, "
     "(int)4>(const __nv_bfloat16 *, int)",
     "decode_attention_kernel<__nv_bfloat16, 128, 4>"),
    ("void (anonymous namespace)::flash_attention_mma_kernel<(int)64>"
     "(const __nv_bfloat16 *)", "flash_attention_mma_kernel<64>"),
])
def test_short_kernel_names(demangled, short):
    assert _build._short(demangled) == short
