"""The SASS reader behind chip_smoke.py's log-kernel bounds
(repro_torch/kernels/sass.py), on text laid out as cuobjdump prints it:
the product loop is found after the last barrier, its K step read from
its induction, and its instructions counted per product by pipe."""

import pytest

from repro_torch.kernels import sass

# one gemm_kernel-shaped function: a staging loop between the two
# barriers, then the product loop (4 K columns a pass), then the K loop's
# own backward branch; encodings as cuobjdump prints them
SASS = """
	code for sm_90a
		Function : _ZN3cim11gemm_kernelINS_7LogCoreILb0EEEtest
	.headerflags	@"EF_CUDA_SM90"
        /*0000*/                   LDC R1, c[0x0][0x28] ;   /* 0x00000a00ff017b82 */
                                                            /* 0x000fe20000000800 */
        /*0010*/                   BAR.SYNC.DEFER_BLOCKING 0x0 ;
        /*0020*/                   IMAD R2, R2, 0x2, R3 ;
        /*0030*/               @P0 BRA 0x20 ;
        /*0040*/                   BAR.SYNC.DEFER_BLOCKING 0x0 ;
        /*0050*/                   IMAD.MOV.U32 R34, RZ, RZ, RZ ;
        /*0060*/                   LDS.128 R8, [R31] ;
        /*0070*/                   VIADD R34, R34, 0x4 ;
        /*0080*/                   ISETP.NE.AND P5, PT, R34, 0x20, PT ;
        /*0090*/                   SHF.L.U32 R16, R16, R13, RZ ;
        /*00a0*/                   IADD3 R16, R35, R16, R17 ;
        /*00b0*/                   IMAD R23, R18, R16, R23 ;
        /*00c0*/                   FLO.U32 R38, R35 ;
        /*00d0*/               @P5 BRA 0x60 ;
        /*00e0*/              @!P0 BRA 0x10 ;
        /*00f0*/                   EXIT ;
		Function : _ZN3cim11gemm_kernelINS_7LutCoreEEtest
        /*0000*/                   BAR.SYNC.DEFER_BLOCKING 0x0 ;
        /*0010*/                   EXIT ;
"""

LOG = "_ZN3cim11gemm_kernelINS_7LogCoreILb0EEEtest"


def test_functions_parse_every_instruction_with_its_guard():
    fns = sass.functions(SASS)
    assert list(fns) == [LOG, "_ZN3cim11gemm_kernelINS_7LutCoreEEtest"]
    insns = fns[LOG]
    assert len(insns) == 16 and insns[0].op == "LDC"
    assert insns[3] == sass.Insn(0x30, "@P0", "BRA", "0x20")
    assert insns[14] == sass.Insn(0xe0, "@!P0", "BRA", "0x10")


@pytest.mark.parametrize("op,pipe", [
    ("IMAD.MOV.U32", "fma"), ("IMAD", "fma"), ("IADD3", "alu"),
    ("SHF.L.U32", "alu"), ("ISETP.EQ.OR", "alu"), ("LOP3.LUT", "alu"),
    ("FLO.U32", "xu"), ("VIADD", "either"), ("VIMNMX.U32", "either"),
    ("LDS.128", "other"), ("BRA", "other"), ("UIADD3", "other")])
def test_pipes(op, pipe):
    assert sass.pipe(op) == pipe


def test_product_loop_is_the_loop_after_the_last_barrier():
    body, step = sass.product_loop(sass.functions(SASS)[LOG], 32)
    assert (body[0].pc, body[-1].pc, step) == (0x60, 0xd0, 4)


def test_per_product_counts_and_the_pipe_that_bounds_them():
    # 8 instructions a pass of 4 K columns x 4 rows = 16 products
    c = sass.per_product(sass.functions(SASS)[LOG], 32, 4)
    assert c == {"alu": 3 / 16, "fma": 1 / 16, "xu": 1 / 16,
                 "either": 1 / 16, "other": 2 / 16, "int": 6 / 16}
    clocks, by = sass.clocks_per_product(c)
    assert by == "xu" and clocks == pytest.approx(1 / 16 / 16)
    c["alu"] = 10 / 16
    assert sass.clocks_per_product(c)[1] == "alu"


def test_a_function_without_a_product_loop_is_refused():
    lut = sass.functions(SASS)["_ZN3cim11gemm_kernelINS_7LutCoreEEtest"]
    with pytest.raises(ValueError, match="no product loop"):
        sass.product_loop(lut, 32)
    with pytest.raises(ValueError, match="induction against 64"):
        sass.product_loop(sass.functions(SASS)[LOG], 64)


# a tensor-core function as cuobjdump prints it: mma.sync m16n8k32 s8
# becomes IMMA.16832, wgmma IGMMA; a predicated one counts too
TC_SASS = """
		Function : _ZN3cim21int8_mma_dense_kernelILb1EEEvPKaS2_PiPfiiii
        /*0000*/                   LDSM.16.MT88.4 R8, [R2] ;
        /*0010*/                   PRMT R12, R8, 0x6420, R9 ;
        /*0020*/                   IMMA.16832.S8.S8 R24, R36.ROW, R12.COL, R24 ;
        /*0030*/                   IMMA.16832.S8.S8 R28, R36.ROW, R14.COL, R28 ;
        /*0040*/               @P1 IMMA.16832.S8.S8 R32, R40.ROW, R12.COL, R32 ;
        /*0050*/                   IGMMA.64x64x32.S8.S8 R24, gdesc[UR4], R24 ;
        /*0060*/                   EXIT ;
		Function : _ZN3cim11gemm_kernelINS_7IntCoreEEtest
        /*0000*/                   IMAD R2, R2, R3, R4 ;
        /*0010*/                   EXIT ;
"""


def test_tensor_core_instructions_are_counted_per_function():
    fns = sass.functions(TC_SASS)
    got = {name: sass.tensor_core_counts(insns)
           for name, insns in fns.items()}
    assert got == {
        "_ZN3cim21int8_mma_dense_kernelILb1EEEvPKaS2_PiPfiiii":
            {"IMMA": 3, "IGMMA": 1},
        "_ZN3cim11gemm_kernelINS_7IntCoreEEtest": {"IMMA": 0, "IGMMA": 0}}


# a cluster_gemm_kernel-shaped function: a prologue loop (no barrier), the
# K-step loop (a stage landed, an inner staging loop, the staged x
# visible, then the unrolled products: IDP is dp4a), then the k groups'
# reduction loop with one barrier
CLUSTER_SASS = """
		Function : _ZN3cim19cluster_gemm_kernelINS_14ClusterLogCoreILb0EEELi4ELi32EEEvNS_6ClArgsE
        /*0000*/                   IADD3 R4, R4, 0x100, RZ ;
        /*0010*/               @P1 BRA 0x0 ;
        /*0020*/                   DEPBAR.LE SB0, 0x2 ;
        /*0030*/                   BAR.SYNC.DEFER_BLOCKING 0x0 ;
        /*0040*/                   MUFU.RCP R6, R5 ;
        /*0050*/               @P2 BRA 0x40 ;
        /*0060*/                   BAR.SYNC.DEFER_BLOCKING 0x0 ;
        /*0070*/                   LDS.128 R8, [R3] ;
        /*0080*/                   IDP.4A.S8.S8 R20, R8, R12, R20 ;
        /*0090*/                   IDP.4A.S8.S8 R20, R9, R13, R20 ;
        /*00a0*/                   IDP.4A.S8.S8 R21, R8, R14, R21 ;
        /*00b0*/                   IDP.4A.S8.S8 R21, R9, R15, R21 ;
        /*00c0*/                   VIADD R2, R2, 0x1 ;
        /*00d0*/                   ISETP.GE.AND P0, PT, R2, R7, PT ;
        /*00e0*/              @!P0 BRA.U 0x20 ;
        /*00f0*/                   STS [R3], R20 ;
        /*0100*/                   BAR.SYNC.DEFER_BLOCKING 0x0 ;
        /*0110*/               @P3 BRA 0xf0 ;
        /*0120*/                   EXIT ;
"""
CLUSTER = "_ZN3cim19cluster_gemm_kernelINS_14ClusterLogCoreILb0EEELi4ELi32EEEvNS_6ClArgsE"


def test_step_products_is_the_k_step_loop_tail():
    insns = sass.functions(CLUSTER_SASS)[CLUSTER]
    section = sass.step_products(insns)
    assert (section[0].pc, section[-1].pc) == (0x70, 0xe0)
    # 4 IDP (FMA pipe), VIADD, ISETP over 8 products (2 rows x 4 k)
    c = sass.section_per_product(section, 8)
    assert c == {"alu": 1 / 8, "fma": 4 / 8, "xu": 0.0, "either": 1 / 8,
                 "other": 2 / 8, "int": 6 / 8}
    clocks, by = sass.clocks_per_product(c)
    assert by == "fma" and clocks == pytest.approx(4 / 8 / 64)


def test_step_products_refuses_other_shapes():
    insns = sass.functions(CLUSTER_SASS)[CLUSTER]
    # no loop over two barriers: the template's function
    with pytest.raises(ValueError, match="no K-step loop"):
        sass.step_products(sass.functions(SASS)[LOG][:4])
    # a loop inside the product section
    looped = insns[:9] + [sass.Insn(0x85, "@P4", "BRA", "0x70")] + insns[9:]
    with pytest.raises(ValueError, match="holds a loop"):
        sass.step_products(looped)


# an attention-cluster-shaped function: a staging loop without products,
# an outer loop holding one row loop of 4 dp4a (and a shuffle), and a
# second row loop of 2 dp4a after it
ATTN_SASS = """
		Function : _ZN4attn19attn_cluster_kernelILi3ELb0EEEvNS_6AcArgsE
        /*0000*/                   BAR.SYNC.DEFER_BLOCKING 0x0 ;
        /*0010*/                   IMAD R2, R2, 0x2, R3 ;
        /*0020*/               @P0 BRA 0x10 ;
        /*0030*/                   LDS.128 R4, [R9] ;
        /*0040*/                   LDS.128 R12, [R10] ;
        /*0050*/                   IDP.4A.S8.S8 R20, R4, R12, RZ ;
        /*0060*/                   IDP.4A.S8.S8 R20, R5, R13, R20 ;
        /*0070*/                   IDP.4A.S8.S8 R20, R6, R14, R20 ;
        /*0080*/                   IDP.4A.S8.S8 R20, R7, R15, R20 ;
        /*0090*/                   SHFL.BFLY PT, R21, R20, 0x1, 0x1f ;
        /*00a0*/                   IADD3 R20, R20, R21, RZ ;
        /*00b0*/                   VIADD R9, R9, 0x50 ;
        /*00c0*/               @P1 BRA 0x40 ;
        /*00d0*/               @P2 BRA 0x30 ;
        /*00e0*/                   IDP.4A.S8.S8 R20, R4, R12, RZ ;
        /*00f0*/                   IDP.4A.S8.S8 R20, R5, R13, R20 ;
        /*0100*/                   ISETP.NE.AND P3, PT, R9, R8, PT ;
        /*0110*/               @P3 BRA 0xe0 ;
        /*0120*/                   EXIT ;
"""


def test_idp_loops_are_the_innermost_loops_with_dp4a():
    insns = sass.functions(ATTN_SASS)[
        "_ZN4attn19attn_cluster_kernelILi3ELb0EEEvNS_6AcArgsE"]
    loops = sass.idp_loops(insns)
    assert [(body[0].pc, body[-1].pc, n) for body, n in loops] == [
        (0x40, 0xc0, 4), (0xe0, 0x110, 2)]
    c = sass.section_per_product(loops[0][0], 2 * loops[0][1])
    # 4 IDP on the FMA pipe, the IADD3 on the ALU, the VIADD either way,
    # the loads, the shuffle and the branch issue only: over 8 products
    assert (c["fma"], c["alu"], c["either"]) == (0.5, 0.125, 0.125)
