"""The share of the traced busy time that the kernels only the Soft MoE
layer launches take, in %, over the union of the device's events. The
symbols (as ``harness/trace.py::kernel_symbol`` names them) are those of
a trace of the layer alone on an H100 (``SoftMoE(32, 8, 1, 512)`` in
bf16, forward and backward at 32 and 256 rows), less every symbol of a
trace of the cell's two heads alone (``Dense(61952, 4)`` and
``Dense(61952, 1)`` in bf16, forward and backward at 32 and 256 rows) and
less every symbol of a traced ``impala_dqn.learner`` run: the cuBLAS
kernels of its four products forward and of three f32 products of its
backward (the last two of the list only at 256 rows, which the cell does
not run backward). Its launches that share a symbol with the trunk or
the heads are not counted: the experts' K10 launches, both softmaxes and
their backward, its casts and copies, and its other f32 backward
products. The names are cuBLAS's heuristic choices for these shapes: a
library that chose others would leave the metric silent. None without a
trace or where none of them ran."""

KERNELS = frozenset((
    "nvjet_tss_128x128_64x6_2x1_v_bz_NNT",
    "nvjet_tss_128x64_64x8_1x2_h_bz_NNT",
    "nvjet_tss_256x128_64x4_2x1_v_bz_coopA_NNT",
    "nvjet_tss_32x384_64x4_1x4_h_bz_NNN",
    "nvjet_tss_32x64_64x16_1x4_h_bz_NNN",
    "nvjet_tss_64x16_64x16_1x2_h_bz_NNT",
    "nvjet_tss_64x32_64x16_1x1_h_bz_NTT",
    "sm80_xmma_gemm_f32f32_f32f32_f32_nn_n_tilesize32x32x8_stage3_warpsize1x2x"
    "1_ffma_aligna4_alignc4_execute_kernel__5x_cublas",
    "sm80_xmma_gemm_f32f32_f32f32_f32_nt_n_tilesize32x64x8_stage3_warpsize1x2x"
    "1_ffma_aligna4_alignc4_execute_kernel__5x_cublas",
    "sm80_xmma_gemm_f32f32_f32f32_f32_tn_n_tilesize128x32x8_stage3_warpsize2x2"
    "x1_ffma_aligna4_alignc4_execute_kernel__5x_cublas",
))


def read(ctx):
    if ctx.trace is None or ctx.trace["busy_s"] <= 0:
        return None
    seconds = sum(s for k, (_n, s) in ctx.trace["by_kernel"].items()
                  if k in KERNELS)
    return 100.0 * seconds / ctx.trace["busy_s"] if seconds else None
