"""The SASS reader behind the dense verdict kernel's bound.

``cilium_tpu_torch.sass_mix`` counts the instructions a (packet, entry)
pair issues in the kernel's entry loop, from ``cuobjdump -sass`` text.
No CUDA toolkit here, so these feed it text in cuobjdump's format: an
outer tile loop around an inner loop unrolled by two, each entry's hit
accumulate skipped by a predicated forward branch.
"""

import pytest

from cilium_tpu_torch import sass_mix

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
