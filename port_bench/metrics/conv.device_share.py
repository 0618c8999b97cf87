"""The share of the traced busy time that the convolutions take, in %:
cuDNN's forward (fprop), data-gradient (dgrad) and weight-gradient
(wgrad) kernels, the layout, padding and dtype conversions it runs around
them and the workspace it clears for them, over the union of the device's
events. The symbols are those of the traces of ``impala_dqn.learner``,
``nature_dqn.learner`` and ``nature_dqn.actor`` on an H100 (cuDNN's
deterministic algorithms, TF32 off), as ``harness/trace.py::
kernel_symbol`` names them; the profiler leaves cuDNN's cutlass wgrad
kernels mangled, so they are taken by the prefix of that name. None
without a trace or where none of them ran."""

KERNELS = frozenset((
    "sm80_xmma_fprop_implicit_gemm_bf16bf16_bf16f32_f32_nhwckrsc_nhwc_"
    "tilesize128x32x32_stage4_warpsize4x1x1_g1_tensor16x8x16_t1r3s3_"
    "execute_kernel__5x_cudnn",
    "sm80_xmma_fprop_implicit_gemm_bf16bf16_bf16f32_f32_nhwckrsc_nhwc_"
    "tilesize256x32x32_stage4_warpsize4x1x1_g1_tensor16x8x16_execute_"
    "kernel__5x_cudnn",
    "sm80_xmma_fprop_implicit_gemm_bf16bf16_bf16f32_f32_nhwckrsc_nhwc_"
    "tilesize64x32x64_stage5_warpsize2x2x1_g1_tensor16x8x16_execute_"
    "kernel__5x_cudnn",
    "sm80_xmma_fprop_implicit_gemm_indexed_f32f32_f32f32_f32_nchwkcrs_nchw_"
    "tilesize32x32x8_stage3_warpsize1x2x1_g1_ffma_aligna4_alignc4_execute_"
    "kernel__5x_cudnn",
    "sm90_xmma_fprop_implicit_gemm_bf16bf16_bf16f32_f32_nhwckrsc_nhwc_"
    "tilesize64x64x64_warpgroupsize1x1x1_g1_execute_segment_k_off_kernel__"
    "5x_cudnn",
    "sm90_xmma_fprop_implicit_gemm_bf16bf16_bf16f32_f32_nhwckrsc_nhwc_"
    "tilesize128x64x64_warpgroupsize1x1x1_g1_execute_segment_k_off_kernel__"
    "5x_cudnn",
    "sm90_xmma_fprop_implicit_gemm_bf16bf16_bf16f32_f32_nhwckrsc_nhwc_"
    "tilesize256x64x32_warpgroupsize1x1x1_g1_execute_segment_k_off_kernel__"
    "5x_cudnn",
    "sm80_xmma_dgrad_implicit_gemm_indexed_bf16bf16_bf16f32_f32_nhwckrsc_"
    "nhwc_tilesize128x32x32_stage4_warpsize4x1x1_g1_tensor16x8x16_execute_"
    "kernel__5x_cudnn",
    "sm90_xmma_dgrad_implicit_gemm_bf16bf16_bf16f32_f32_nhwckrsc_nhwc_"
    "tilesize64x64x64_warpgroupsize1x1x1_g1_execute_segment_k_off_kernel__"
    "5x_cudnn",
    "sm90_xmma_dgrad_implicit_gemm_bf16bf16_bf16f32_f32_nhwckrsc_nhwc_"
    "tilesize256x64x32_warpgroupsize1x1x1_g1_execute_segment_k_off_kernel__"
    "5x_cudnn",
    "sm90_xmma_dgrad_implicit_gemm_indexed_bf16bf16_bf16f32_f32_nhwckrsc_"
    "nhwc_tilesize256x64x64_warpgroupsize1x1x1_g1_strided_execute_kernel__"
    "5x_cudnn",
    "sm90_xmma_wgrad_indexed_implicit_gemm_bf16bf16_bf16f32_f32_nhwckrsc_"
    "nhwc_tilesize64x64x64_warpgroupsize1x1x1_g1_execute_segment_k_off_"
    "kernel__5x_cudnn",
    "sm90_xmma_wgrad_indexed_implicit_gemm_bf16bf16_bf16f32_f32_nhwckrsc_"
    "nhwc_tilesize64x64x64_warpgroupsize1x1x1_g1_execute_segment_k_on_"
    "kernel__5x_cudnn",
    "sm90_xmma_wgrad_indexed_implicit_gemm_bf16bf16_bf16f32_f32_nhwckrsc_"
    "nhwc_tilesize64x64x64_warpgroupsize1x1x1_g1_execute_split_k_kernel__"
    "5x_cudnn",
    "implicit_convolve_sgemm",
    "cutlass__5x_cudnn::Kernel",
    "cudnn::engines_precompiled::nhwcToNchwKernel",
    "cudnn::engines_precompiled::nchwToNhwcKernel",
    "cudnn::engines_precompiled::convertTensor_kernel",
    "nhwcAddPaddingKernel",
    "cask_plugin__5x_cudnn::xmma__5x_cudnn::init_device_workspace_kernel",
))
# cutlass__5x_cudnn::Kernel<conv::kernel::ImplicitGemmConvolution<...>>,
# mangled
MANGLED = "_ZN17cutlass__5x_cudnn6KernelINS_4conv6kernel23ImplicitGemmConvolution"


def read(ctx):
    if ctx.trace is None or ctx.trace["busy_s"] <= 0:
        return None
    seconds = sum(s for k, (_n, s) in ctx.trace["by_kernel"].items()
                  if k in KERNELS or k.startswith(MANGLED))
    return 100.0 * seconds / ctx.trace["busy_s"] if seconds else None
