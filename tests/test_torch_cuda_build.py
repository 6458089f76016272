"""The kernel build: its report of registers and spills, read from ``ptxas
-v`` output (the card's build prints it; no ``nvcc`` runs here), and the
hash that names each built library."""
from __future__ import annotations

import re
import shutil
from pathlib import Path

from repro_torch import _cuda_build as build

PTXAS = """\
ptxas info    : 0 bytes gmem
ptxas info    : Compiling entry function '_ZN12_GLOBAL__N_124waterfill_descent_kernelILi16EEEvPKdS2_Pdxi' for 'sm_90a'
ptxas info    : Function properties for _ZN12_GLOBAL__N_124waterfill_descent_kernelILi16EEEvPKdS2_Pdxi
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 40 registers, used 0 barriers, 1024 bytes smem, 396 bytes cmem[0]
ptxas info    : Compiling entry function '_ZN12_GLOBAL__N_116flash_fwd_kernelIfLi256EEEvPKT_S3_S3_PS1_iixxxxiiixffi' for 'sm_90a'
ptxas info    : Function properties for _ZN12_GLOBAL__N_116flash_fwd_kernelIfLi256EEEvPKT_S3_S3_PS1_iixxxxiiixffi
    8 bytes stack frame, 4 bytes spill stores, 4 bytes spill loads
ptxas info    : Used 128 registers, used 1 barriers, 396 bytes cmem[0]
"""


def test_ptxas_report_gives_each_kernel_its_registers_and_spills(monkeypatch):
    monkeypatch.setattr(shutil, "which", lambda name: None)
    entries = build.ptxas_report(PTXAS).split("; ")
    assert entries == [
        "_ZN12_GLOBAL__N_124waterfill_descent_kernelILi16EEEvPKdS2_Pdxi: 40 registers, "
        "0 bytes spill stores, 0 bytes spill loads",
        "_ZN12_GLOBAL__N_116flash_fwd_kernelIfLi256EEEvPKT_S3_S3_PS1_iixxxxiiixffi: 128 "
        "registers, 4 bytes spill stores, 4 bytes spill loads",
    ]


def test_ptxas_report_demangles_where_cxxfilt_is_found():
    if shutil.which("c++filt") is None:
        assert build.ptxas_report(PTXAS).startswith("_ZN")
        return
    assert build.ptxas_report(PTXAS) == (
        "waterfill_descent_kernel<16>: 40 registers, 0 bytes spill stores, 0 bytes spill "
        "loads; flash_fwd_kernel<float, 256>: 128 registers, 4 bytes spill stores, 4 bytes "
        "spill loads")


def test_ptxas_report_of_nothing_is_empty():
    assert build.ptxas_report("") == ""


def test_a_header_beside_a_source_is_part_of_its_build_hash(tmp_path):
    (tmp_path / "a.cu").write_text('#include "shared.cuh"\n')
    (tmp_path / "b.cu").write_text('#include "shared.cuh"\n')
    header = tmp_path / "shared.cuh"
    header.write_text("// one\n")
    before = [build._target(tmp_path / n) for n in ("a.cu", "b.cu")]
    assert build._target(tmp_path / "a.cu") == before[0]
    header.write_text("// two\n")
    after = [build._target(tmp_path / n) for n in ("a.cu", "b.cu")]
    assert all(x != y for x, y in zip(before, after))
    assert [p.name.split("-")[0] for p in after] == ["liba", "libb"]


def test_every_local_include_of_a_kernel_source_is_a_hashed_header():
    """A source's quoted includes must be .cuh files beside it, the ones
    its build hash covers, so an edited header rebuilds every source that
    includes it."""
    root = Path(build.__file__).resolve().parent
    sources = sorted(root.rglob("csrc/*.cu"))
    assert sources
    shared = []
    for src in sources:
        for name in re.findall(r'^#include "([^"]+)"', src.read_text(), re.M):
            assert name.endswith(".cuh") and "/" not in name, (src.name, name)
            assert (src.parent / name).is_file(), (src.name, name)
            shared.append((src.name, name))
    assert ("fused_step.cu", "water_descent.cuh") in shared
    assert ("waterfill.cu", "water_descent.cuh") in shared
