"""The SASS reader behind the dense verdict kernel's bound.

``cilium_tpu_torch.sass_mix`` counts the instructions a (packet, entry)
pair issues in the kernel's entry loop, from ``cuobjdump -sass`` text.
No CUDA toolkit here, so these feed it text in cuobjdump's format: an
outer tile loop around an inner loop unrolled by two, each entry's hit
accumulate skipped by a predicated forward branch; and the shape of the
segment loop, where one LDS.128 of an entry feeds two packets of the
thread and a hit block holds branches of its own.
"""

import pytest

from cilium_tpu_torch import kernels, sass_mix
from cilium_tpu_torch.ops import dense_verdict as dense

SASS = """
	code for sm_90a
		Function : _ZN12_GLOBAL__N_120other_kernelEv
        /*0000*/                   LDS.128 R8, [R2] ;        /* 0x0000000002087984 */
        /*0010*/                   BRA 0x0 ;                 /* 0xfffffffc00fc7947 */
		Function : _ZN12_GLOBAL__N_120dense_verdict_kernelEPKi
        /*0000*/                   S2R R3, SR_CTAID.X ;      /* 0x0000000000037919 */
        /*0010*/                   BAR.SYNC.DEFER_BLOCKING 0x0 ;
        /*0020*/                   IMAD R39, R35, 0x10, R36 ;
        /*0030*/                   BSSY B1, 0x90 ;
        /*0040*/                   LDS.128 R8, [R39] ;
        /*0050*/                   ISETP.NE.AND P0, PT, R8, R30, PT ;
        /*0060*/                   PLOP3.LUT P0, PT, P3, P1, P0, 0xf8, 0x0 ;
        /*0070*/              @!P0 BRA 0x90 ;
        /*0080*/                   IMAD.IADD R26, R26, 0x1, R9 ;
        /*0090*/                   BSYNC B1 ;
        /*00a0*/                   LDS.128 R12, [R39+0x10] ;
        /*00b0*/                   ISETP.NE.AND P4, PT, R12, R30, PT ;
        /*00c0*/                   ISETP.EQ.AND P2, PT, R13, R29, !P4 ;
        /*00d0*/              @!P2 BRA 0x100 ;
        /*00e0*/                   SEL R11, R23, RZ, P0 ;
        /*00f0*/                   IMAD.IADD R2, R2, 0x1, R23 ;
        /*0100*/                   VIADD R35, R35, 0x2 ;
        /*0110*/               @P2 BRA 0x20 ;
        /*0120*/                   BAR.SYNC.DEFER_BLOCKING 0x0 ;
        /*0130*/              @!P0 BRA 0x10 ;
        /*0140*/                   EXIT ;
"""


SEGMENT_SASS = """
	code for sm_90a
		Function : _ZN12_GLOBAL__N_122segment_verdict_kernelEPK4int4iS2_S2_PiS3_S3_
        /*0000*/                   S2R R0, SR_TID.X ;
        /*0010*/                   LDGSTS.E.BYPASS.128 [R3], desc[UR4][R4.64] ;
        /*0020*/                   LDGDEPBAR ;
        /*0030*/                   DEPBAR.LE SB0, 0x1 ;
        /*0040*/                   BAR.SYNC.DEFER_BLOCKING 0x0 ;
        /*0050*/                   LDS.128 R12, [UR8] ;
        /*0060*/                   BSSY B0, 0x120 ;
        /*0070*/                   ISETP.NE.AND P0, PT, R14, R17, PT ;
        /*0080*/                   ISETP.EQ.OR P4, PT, R14, R33, !P0 ;
        /*0090*/                   ISETP.EQ.AND P4, PT, R13, R30, P4 ;
        /*00a0*/                   ISETP.NE.AND P5, PT, R14, R31, PT ;
        /*00b0*/                   ISETP.EQ.OR P2, PT, R14, R19, !P5 ;
        /*00c0*/                   ISETP.EQ.AND P2, PT, R13, R32, P2 ;
        /*00d0*/                   PLOP3.LUT P1, PT, P4, P2, P1, 0xfe, 0x0 ;
        /*00e0*/              @!P1 BRA 0x120 ;
        /*00f0*/                   SEL R43, R12, RZ, P1 ;
        /*0100*/              @!P2 BRA 0x120 ;
        /*0110*/                   IMAD.IADD R4, R4, 0x1, R43 ;
        /*0120*/                   BSYNC B0 ;
        /*0130*/                   LDS.128 R20, [UR8+0x10] ;
        /*0140*/                   ISETP.NE.AND P0, PT, R22, R17, PT ;
        /*0150*/                   ISETP.EQ.OR P4, PT, R22, R33, !P0 ;
        /*0160*/                   ISETP.EQ.AND P4, PT, R21, R30, P4 ;
        /*0170*/                   ISETP.NE.AND P5, PT, R22, R31, PT ;
        /*0180*/                   ISETP.EQ.OR P2, PT, R22, R19, !P5 ;
        /*0190*/                   ISETP.EQ.AND P2, PT, R21, R32, P2 ;
        /*01a0*/                   PLOP3.LUT P1, PT, P4, P2, P1, 0xfe, 0x0 ;
        /*01b0*/              @!P1 BRA 0x1e0 ;
        /*01c0*/                   SEL R43, R20, RZ, P1 ;
        /*01d0*/                   BRA 0x1e0 ;
        /*01e0*/                   UIADD3 UR8, UR8, 0x20, URZ ;
        /*01f0*/                   ISETP.NE.AND P3, PT, RZ, UR4, PT ;
        /*0200*/               @P3 BRA 0x50 ;
        /*0210*/                   BAR.SYNC.DEFER_BLOCKING 0x0 ;
        /*0220*/               @P6 BRA 0x10 ;
        /*0230*/                   EXIT ;
"""


def test_hot_loop_mix_counts_several_packets_per_load():
    mix = sass_mix.hot_loop_mix(SEGMENT_SASS, "segment_verdict_kernel",
                                packets_per_load=2)
    assert mix["loop"] == ["0x50", "0x200"]
    # two entries an iteration, each compared with two packets
    assert mix["pairs_per_iteration"] == 4
    # hot path: LDS BSSY 6 ISETP PLOP3 BRA BSYNC | LDS 6 ISETP PLOP3 BRA
    # | UIADD3 ISETP BRA; each hit block (0xf0-0x110, 0x1c0-0x1d0) and
    # its inner branches are skipped on a miss
    assert mix["opcodes"] == {"BRA": 3, "BSSY": 1, "BSYNC": 1,
                              "ISETP": 13, "LDS": 2, "PLOP3": 2,
                              "UIADD3": 1}
    assert mix["per_pair"] == {"alu": 15 / 4, "fma": 0.0, "issue": 23 / 4}
    # one packet per load: the same loop, half the pairs
    one = sass_mix.hot_loop_mix(SEGMENT_SASS, "segment_verdict_kernel")
    assert one["pairs_per_iteration"] == 2
    assert one["per_pair"]["alu"] == 15 / 2


def test_hot_loop_mix_counts_the_miss_path_per_pair():
    mix = sass_mix.hot_loop_mix(SASS, "dense_verdict_kernel")
    assert mix["loop"] == ["0x20", "0x110"]
    assert mix["pairs_per_iteration"] == 2
    # hot path: IMAD BSSY LDS ISETP PLOP3 BRA BSYNC LDS ISETP ISETP BRA
    # VIADD BRA; the IMAD.IADD at 0x80 and SEL/IMAD.IADD at 0xe0-0xf0
    # are skipped on a miss
    assert mix["opcodes"] == {"BRA": 3, "BSSY": 1, "BSYNC": 1, "IMAD": 1,
                              "ISETP": 3, "LDS": 2, "PLOP3": 1, "VIADD": 1}
    assert mix["per_pair"] == {"alu": 2.0, "fma": 0.5, "issue": 6.5}


def test_pair_seconds_takes_the_slowest_pipe():
    per_pair = {"alu": 9.0, "fma": 0.5, "issue": 13.0}
    got = sass_mix.pair_seconds(per_pair, sms=132, clock_hz=1.98e9)
    assert got["pipe"] == "alu"
    assert got["seconds"] == 9.0 / (64 * 132 * 1.98e9)
    issue_bound = sass_mix.pair_seconds({"alu": 1.0, "fma": 0.0,
                                         "issue": 20.0}, 1, 1.0)
    assert issue_bound == {"seconds": 20.0 / 128, "pipe": "issue"}


def test_hot_loop_mix_refuses_what_it_cannot_read():
    with pytest.raises(ValueError, match="no SASS"):
        sass_mix.hot_loop_mix(SASS, "missing_kernel")
    no_loop = SASS.replace("@P2 BRA 0x20", "@P2 BRA 0x130")
    no_loop = no_loop.replace("@!P0 BRA 0x10", "@!P0 BRA 0x140")
    with pytest.raises(ValueError, match="no loop"):
        sass_mix.hot_loop_mix(no_loop, "dense_verdict_kernel")


def test_packets_per_thread_is_the_kernel_sources():
    """The bound counts PACKETS_PER_THREAD pairs per entry load; it must
    be the value the kernel is built with."""
    src = (kernels.CSRC / "dense_verdict.cu").read_text()
    assert src.count("constexpr int kPerThread = ") == 1
    assert f"constexpr int kPerThread = {dense.PACKETS_PER_THREAD};" in src
