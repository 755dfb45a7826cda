"""The SASS reader of scripts/sass_census.py on a small listing in
cuobjdump's format (the tool itself runs where the CUDA toolkit is)."""

import pytest

from tpu_pathtracer_torch.ops import cuda_build
from tpu_pathtracer_torch.scripts import sass_census

LISTING = """
\t\tFunction : _ZN5anon18sweep_count_kernelEPKf
        /*0000*/                   MOV R1, R2 ;
        /*0010*/                   FMNMX R3, R4, R5, PT ;
        /*0020*/                   FMNMX R3, R4, R6, !PT ;
        /*0030*/               @P0 BRA 0x60 ;
        /*0040*/                   CALL.REL.NOINC 0x100 ;
        /*0050*/                   FADD R1, R1, R2 ;
        /*0060*/                   FSETP.GT.AND P0, PT, R1, R2, PT ;
        /*0070*/              @!P0 BRA 0x10 ;
        /*0080*/                   EXIT ;
\t\tFunction : _ZN5anon20rowtest_probe_kernelILi0ELi16EEvPKf
        /*0000*/                   MUFU.RCP R1, R2 ;
        /*0010*/                   EXIT ;
"""


def test_loop_skips_the_rare_call():
    """The loop 0x10-0x70 issues five instructions a trip on its fast path:
    the forward branch over the CALL is taken, so the CALL and the FADD
    beside it are not counted; two FMNMX a test give 2.5 instructions a
    test, against 2 operations: an issue ceiling of 80%."""
    loops = sass_census.sass_loops(LISTING, sass_census.COUNT_SYMBOL)
    assert loops == [{"issued": 5, "ops": {"FMNMX": 2, "BRA": 2, "FSETP": 1}}]
    x = sass_census.issue_ceiling(LISTING, sass_census.COUNT_SYMBOL, "FMNMX", 2, 4)
    assert x == {"issued_per_test": 5.0, "ops_per_test": 4, "issue_ceiling_pct": 80.0}


@pytest.mark.parametrize("symbol,marker,match", [
    ("18sweep_count_kernelE", "MUFU", "no innermost loop issues MUFU"),  # no such loop
    (sass_census.probe_symbol("full-bw"), "MUFU", "no innermost loop"),  # no loop at all
    (sass_census.probe_symbol("mt"), "MUFU", "0 kernels"),               # not in the listing
    ("_kernel", "FMNMX", "2 kernels"),                                   # not one kernel
])
def test_missing_reading_raises(symbol, marker, match):
    with pytest.raises(RuntimeError, match=match):
        sass_census.issue_ceiling(LISTING, symbol, marker, 1, 1)


SWEEP1 = """
\t\tFunction : _ZN5anon13sweep1_kernelEPKf
        /*0000*/                   LDS.128 R4, [R2] ;
        /*0010*/                   MUFU.RCP R1, R4 ;
        /*0020*/                   MUFU.RCP R3, R5 ;
        /*0030*/              @!P0 BRA 0x0 ;
        /*0040*/                   LDG.E R4, [R2.64] ;
        /*0050*/                   SHFL.IDX R5, R1, R0, 0x1f ;
        /*0060*/               @P2 BRA 0x78 ;
        /*0068*/                   MUFU.RCP R1, R4 ;
        /*0070*/                   CALL.REL.NOINC 0x100 ;
        /*0078*/              @!P0 BRA 0x40 ;
        /*0080*/                   LDG.E R4, [R2.64] ;
        /*0090*/                   MUFU.RCP R1, R4 ;
        /*00a0*/                   FADD R1, R1, R2 ;
        /*00b0*/              @!P1 BRA 0x80 ;
        /*00c0*/                   EXIT ;
"""


@pytest.mark.parametrize("having,lacking,issued", [
    (("LDS",), ("LDG",), 2.0),       # the prime: two lanes a trip, 4 instructions
    (("LDG", "SHFL"), (), 6.0),      # the warp's leaf service, its guarded row test
    (("LDG",), ("SHFL",), 4.0),      # the per-lane leaf loop
])
def test_loops_told_apart_by_their_opcodes(having, lacking, issued):
    """Three loops issue MUFU; the opcodes a loop must and must not issue
    pick one: the prime reads shared memory, the leaf rows device memory,
    and only the warp's service shuffles.  The service's branch over its
    row test is not taken though that holds a CALL: it skips a MUFU too."""
    x = sass_census.issue_ceiling(SWEEP1, sass_census.SWEEP1_SYMBOL, "MUFU", 1, 52,
                                  having=having, lacking=lacking)
    assert x["issued_per_test"] == issued


def test_no_loop_with_the_opcodes_raises():
    with pytest.raises(RuntimeError, match="no innermost loop"):
        sass_census.issue_ceiling(SWEEP1, sass_census.SWEEP1_SYMBOL, "MUFU", 1, 52,
                                  having=("LDS", "SHFL"))


def test_probe_symbol_names_the_unrolled_instance():
    """rowtest_probe_kernel<V, 16>: the variant's index, then mtblock 16."""
    assert sass_census.probe_symbol("full-bw") == "20rowtest_probe_kernelILi0ELi16EE"
    assert sass_census.probe_symbol("mt") == "20rowtest_probe_kernelILi5ELi16EE"


def test_library_sass_needs_cuobjdump(tmp_path, monkeypatch):
    monkeypatch.setattr(cuda_build, "_nvcc", lambda: str(tmp_path / "nvcc"))
    with pytest.raises(RuntimeError, match="no cuobjdump"):
        sass_census.library_sass(str(tmp_path / "lib.so"))
