// Hopper kernels for the windowed SpMM on packs with no super-group plan:
// every multi-shard uniform pack, and single-shard packs whose windows are
// not monotone.  For one shard's G row groups of TM rows,
//
//     C[g*TM + r, j] = sum_{k < W} A[g, r, k] * B[ws[g] + k, j]
//
// with A the fp32 (or fp64) dense (G, TM, W) window panels of the JAX pack,
// B the (rows, n) receive buffer (rows >= max(ws) + W, checked by the
// Python wrapper) and C the (G*TM, n) output.  Pad groups (zero panels at
// ws = 0) and an empty shard's all-zero panels come out zero.
//
// Replaces crp_tpu/kernels/spmm_pallas.py _window_kernel (wrapper
// spmm_window_pallas), at the pack's operating point:
//   crp_window_x3    <- precision "x3": A and B split to bf16 hi/lo in RNE
//                       on the load path into shared memory,
//                       acc += al*bh + ah*bl + ah*bh in fp32
//   crp_window_bf16  <- precision DEFAULT: A and B rounded to bf16 (RNE) on
//                       the load path, one bf16 product, fp32 sums
//   crp_window_f32   <- HIGHEST: 3xTF32 on the TF32 tensor cores, A and B
//                       split to tf32 big/small (cvt.rna's bits) as their
//                       fragments are read, acc += as*bb + ab*bs + ab*bb
//                       (panel_tf32x3_kernel), fed by a 4-stage cp.async
//                       shared-memory ring
//   crp_window_f64   <- fp64 panels: fp64 FMA
// The TPU kernel walks a (G, n/TN, W/Wc) grid in order and double-buffers
// each step's B window chunk in VMEM; here each block owns one output tile
// and walks its group's window in 32-row k-slices (panel_tiles.cuh), with
// the per-slice fresh-fragment IEEE sums of the super-grouped kernels.
// HIGHEST on the TPU is itself a multi-pass bf16 decomposition on the MXU;
// three TF32 products are Hopper's counterpart, held to the fp32 plain
// version (TOL_PLAIN).  At the p = 4 headline shard the three passes are
// 473.7 GFLOP: 0.96 ms at the 495 TF/s TF32 peak, against 2.36 ms for one
// fp32 FMA pass at 67 TF/s.
//
// What bounds it on an H100 at the p = 4 headline shard (G = 213, TM = 256,
// W ~ 5632, n = 256): per shard x3 does 3 x 157 GFLOP of bf16 products (0.48
// ms at the 989 TF/s bf16 peak) over 1.23 GB of fp32 panels (0.37 ms at
// 3.35 TB/s).  The panels stay fp32 (the JAX pack, so one pack feeds both
// packages) and are split on every read: each N tile re-reads and re-splits
// its A slice, which the pre-split super-grouped pack does not.  Whether a
// pre-split multi-shard pack pays is a later measurement against this one.

#include "panel_tiles.cuh"

extern "C" {

int crp_window_x3(const void* ws, const void* tiles, const void* b, void* c,
                  int64_t G, int64_t TM, int64_t W, int64_t n, void* stream)
{
    return crp::launch_mma<true, true>(nullptr, ws, tiles, nullptr, b, c, G, TM,
                                       W, n, stream);
}

int crp_window_bf16(const void* ws, const void* tiles, const void* b, void* c,
                    int64_t G, int64_t TM, int64_t W, int64_t n, void* stream)
{
    return crp::launch_mma<false, true>(nullptr, ws, tiles, nullptr, b, c, G,
                                        TM, W, n, stream);
}

int crp_window_f32(const void* ws, const void* tiles, const void* b, void* c,
                   int64_t G, int64_t TM, int64_t W, int64_t n, void* stream)
{
    return crp::launch_tf32x3<false>(nullptr, ws, tiles, b, c, G, TM, W, n, stream);
}

// crp_window_f32's ring and resources (crp::tf32x3_layout)
int crp_tf32x3_layout(char* out, int len)
{
    return crp::tf32x3_layout<false>(out, len);
}

int crp_window_f64(const void* ws, const void* tiles, const void* b, void* c,
                   int64_t G, int64_t TM, int64_t W, int64_t n, void* stream)
{
    return crp::launch_fma<double, 64, 128, 8, 4, 8>(nullptr, ws, tiles, b, c,
                                                      G, TM, W, n, stream);
}

const char* crp_error_string(int code)
{
    return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
