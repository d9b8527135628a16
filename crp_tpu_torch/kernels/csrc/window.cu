// Hopper kernels for the windowed SpMM on packs with no super-group plan:
// every multi-shard uniform pack, and single-shard packs whose windows are
// not monotone.  For one shard's G row groups of TM rows,
//
//     C[g*TM + r, j] = sum_{k < W} A[g, r, k] * B[ws[g] + k, j]
//
// with A the dense (G, TM, W) window panels, B the (rows, n) receive buffer
// (rows >= max(ws) + W, checked by the Python wrapper) and C the (G*TM, n)
// output.  Pad groups (zero panels at ws = 0) and an empty shard's all-zero
// panels come out zero.
//
// Replaces crp_tpu/kernels/spmm_pallas.py _window_kernel (wrapper
// spmm_window_pallas), at the pack's operating point:
//   crp_window_x3    <- precision "x3": the panels arrive as bf16 hi/lo,
//                       split once in RNE when they are packed (the split
//                       the TPU kernel makes of its fp32 panels on every
//                       read), B split to bf16 hi/lo in registers,
//                       acc += al*bh + ah*bl + ah*bh in fp32: the wgmma
//                       body of #1 fed by TMA (x3_wgmma.cuh), its own entry
//                       so that #4 keeps its launch count and its row
//   crp_window_bf16  <- precision DEFAULT: the panels arrive as their bf16
//                       hi plane, rounded once in RNE when they are packed
//                       (the rounding the TPU kernel makes of its fp32
//                       panels on every read), and B cast to bf16 (RNE) by
//                       the caller; one bf16 product, fp32 sums: #2's
//                       one-pass wgmma body (x3_wgmma.cuh, ONE_PASS), its
//                       own entry so that #4 keeps its launch count and row
//   crp_window_f32   <- HIGHEST: 3xTF32 on the TF32 tensor cores, A and B
//                       split to tf32 big/small (cvt.rna's bits),
//                       acc += as*bb + ab*bs + ab*bb: #1's wgmma body in
//                       its TF32X3 mode (x3_wgmma.cuh), the panels' big
//                       and small planes, split once when they are packed
//                       (TMA copies and cannot split; the tensor cores
//                       truncate an fp32 operand), fed by TMA into a
//                       4-stage ring, B split in registers
//   crp_window_f64   <- fp64 panels: an entry of dd_tc.cu, #11's DMMA body
//                       on the FP64 tensor cores (the windowed walk)
// The TPU kernel walks a (G, n/TN, W/Wc) grid in order and double-buffers
// each step's B window chunk in VMEM; here each block owns one output tile
// and walks its group's window in k-slices, with the per-32-row-slice
// fresh-accumulator IEEE sums of the super-grouped kernels.  HIGHEST on
// the TPU is itself a multi-pass bf16 decomposition on the MXU; three TF32
// products are Hopper's counterpart, held to the fp32 plain version
// (TOL_PLAIN).
//
// What bounds it on an H100 at the p = 4 headline shard (G = 214, TM = 256,
// W = 5632, n = 256), each pass 157 GFLOP of products over panels of 1.23
// GB at fp32 (0.37 ms at 3.35 TB/s): x3 three bf16 passes over the hi/lo
// pair (the same bytes), 0.48 ms at 989 TF/s; DEFAULT one bf16 pass (0.16
// ms) over the 0.62 GB hi plane, bound by its bytes (0.18 ms); HIGHEST
// three TF32 passes, 0.96 ms at 495 TF/s (one fp32 FMA pass would be 2.36
// ms at 67 TF/s), over 2.47 GB of TF32 planes (0.74 ms); fp64 one pass at
// the FP64 tensor cores' 67 TF/s, 2.36 ms, over 2.47 GB of panels (0.74
// ms).

#include "panel_tiles.cuh"
#include "x3_wgmma.cuh"

extern "C" {

int crp_window_x3(const void* ws, const void* ah, const void* al, const void* b,
                  void* c, int64_t G, int64_t TM, int64_t W, int64_t n, void* stream)
{
    return crp::launch_wgmma<crp::WgMode::SPLIT_B>(ws, ah, al, b, nullptr, c, G, TM, W, n,
                                                    stream);
}

// the wgmma body's rings and resources, crp_window_x3's, crp_window_bf16's
// and crp_window_f32's (crp::x3_layout)
int crp_x3_layout(char* out, int len)
{
    return crp::x3_layout<false, false, false, true>(out, len);
}

int crp_window_bf16(const void* ws, const void* ah, const void* bh, void* c,
                    int64_t G, int64_t TM, int64_t W, int64_t n, void* stream)
{
    return crp::launch_wgmma<crp::WgMode::ONE_PASS>(ws, ah, nullptr, bh, nullptr, c, G, TM,
                                                    W, n, stream);
}

int crp_window_f32(const void* ws, const void* tiles, const void* b, void* c,
                   int64_t G, int64_t TM, int64_t W, int64_t n, void* stream)
{
    // tiles: the (2, G, TM, W) TF32 planes, big then small (see x3_wgmma.cuh)
    const float* big = static_cast<const float*>(tiles);
    return crp::launch_wgmma<crp::WgMode::TF32X3>(ws, big, big + G * TM * W, b, nullptr, c, G,
                                                   TM, W, n, stream);
}

const char* crp_error_string(int code)
{
    return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
