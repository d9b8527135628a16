// Hopper kernels for the super-grouped windowed SpMM on uniform packs.
//
// Every entry computes, for a pack of G row groups of TM rows,
//
//     C[g*TM + r, j] = sum_{k < W} A[g, r, k] * B[ws[g] + k, j]
//
// with A the dense (G, TM, W) window panels, B the (rows, n) receive
// buffer (rows >= max(ws) + W, checked by the Python wrapper) and C the
// (G*TM, n) output.  A uniform pack is the one-chunk-per-group case of
// the tile kernels in panel_tiles.cuh (group_ptr == nullptr, starts = ws).
//
// Replaces (crp_tpu/kernels/spmm_pallas.py):
//   crp_window_sg_presplit  <- _window_kernel_sg_presplit (x3: A as bf16
//                              hi/lo, B split to bf16 hi/lo here in RNE,
//                              acc += al*bh + ah*bl + ah*bh in fp32)
//   crp_window_sg_presplit_ab <- _window_kernel_sg_presplit_ab (x3 with B
//                              also pre-split to bf16 hi/lo in HBM by
//                              split_b_bf16: the same tiles, no split here)
//   crp_window_sg_bf16      <- _window_kernel_sg_bf16 (one bf16 pass)
//   crp_window_sg_f32 / f64 <- _window_kernel_sg (register-tiled FMA in
//                              fp32 or fp64; never TF32)
//
// The TPU kernels double-buffer one B super-window per SG groups in VMEM;
// the pack's `bases`/`SG`/`Wsg` (VMEM artifacts) are not needed here.
//
// What bounds it on an H100 at the pwtk-class n = 256 headline (G = 852,
// TM = 256, W = 5632): x3 does 3 x 629 GFLOP of bf16 products over 4.9 GB
// of A panels (1.9 ms at the 989 TF/s bf16 peak against 1.5 ms of HBM
// time), the 1-pass kernel 629 GFLOP over 2.5 GB (memory-bound), the fp32
// FMA kernel 629 GFLOP at the 67 TF/s fp32 peak (compute-bound).  The A
// panels are the dominant bytes; groups advance in order, so the B windows
// of neighbouring groups (5.8 MB each, mostly shared) stay in the 50 MB L2.
// The pre-split B pair moves the same bytes as fp32 B (two bf16 halves),
// and saves the split that every block of x3 redoes on every B element it
// loads (~2.5e9 splits per headline product); this simple version reads
// the halves as two 2-byte loads where x3 makes one 4-byte load.

#include "panel_tiles.cuh"

extern "C" {

int crp_window_sg_presplit(const void* ws, const void* ah, const void* al,
                           const void* b, void* c, int64_t G, int64_t TM,
                           int64_t W, int64_t n, void* stream)
{
    return crp::launch_mma<true>(nullptr, ws, ah, al, b, c, G, TM, W, n,
                                 stream);
}

int crp_window_sg_presplit_ab(const void* ws, const void* ah, const void* al,
                              const void* bh, const void* bl, void* c,
                              int64_t G, int64_t TM, int64_t W, int64_t n,
                              void* stream)
{
    return crp::launch_mma<true, false, false, true>(
        nullptr, ws, ah, al, bh, c, G, TM, W, n, stream, nullptr, bl);
}

int crp_window_sg_bf16(const void* ws, const void* ah, const void* bh,
                       void* c, int64_t G, int64_t TM, int64_t W, int64_t n,
                       void* stream)
{
    return crp::launch_mma<false>(nullptr, ws, ah, nullptr, bh, c, G, TM, W,
                                  n, stream);
}

int crp_window_sg_f32(const void* ws, const void* tiles, const void* b,
                      void* c, int64_t G, int64_t TM, int64_t W, int64_t n,
                      void* stream)
{
    return crp::launch_fma<float, 128, 128, 8, 8, 8>(nullptr, ws, tiles, b, c,
                                                      G, TM, W, n, stream);
}

int crp_window_sg_f64(const void* ws, const void* tiles, const void* b,
                      void* c, int64_t G, int64_t TM, int64_t W, int64_t n,
                      void* stream)
{
    return crp::launch_fma<double, 64, 128, 8, 4, 8>(nullptr, ws, tiles, b, c,
                                                      G, TM, W, n, stream);
}

const char* crp_error_string(int code)
{
    return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
