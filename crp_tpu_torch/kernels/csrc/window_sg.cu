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
//                              acc += al*bh + ah*bl + ah*bh in fp32), on
//                              the wgmma body of x3_wgmma.cuh (TMA ring,
//                              B split in registers)
//   crp_window_sg_presplit_ab <- _window_kernel_sg_presplit_ab (x3 with B
//                              also pre-split to bf16 hi/lo in HBM by
//                              split_b_bf16): the same body reading the
//                              two bf16 planes, no split here
//   crp_window_sg_bf16      <- _window_kernel_sg_bf16 (one bf16 pass): the
//                              same body's one-pass mode, the hi panels by
//                              TMA and one bf16 B plane in a 6-stage ring,
//                              one wgmma per k16
//   crp_window_sg_f32       <- _window_kernel_sg at HIGHEST on fp32: 3xTF32
//                              on the TF32 tensor cores, the same body's
//                              TF32X3 mode (as crp_window_f32): the panels'
//                              TF32 big/small planes, split once when they
//                              are packed, by TMA, B split in registers,
//                              held to the fp32 plain version
// The fp64 entry, crp_window_sg_f64 (replacing _window_kernel_sg on fp64),
// is in dd_tc.cu: #11's DMMA body on the FP64 tensor cores with its
// windowed walk, bound by its products (2 G TM W n at 67 TFLOP/s).
//
// The TPU kernels double-buffer one B super-window per SG groups in VMEM;
// the pack's `bases`/`SG`/`Wsg` (VMEM artifacts) are not needed here.
//
// What bounds it on an H100 at the pwtk-class n = 256 headline (G = 852,
// TM = 256, W = 5632): x3 does 3 x 629 GFLOP of bf16 products over 4.9 GB
// of A panels (1.9 ms at the 989 TF/s bf16 peak against 1.5 ms of HBM
// time), the 1-pass kernel 629 GFLOP (0.64 ms) over 2.5 GB (0.73 ms: the
// bytes bound it), highest 3 x 629 GFLOP of TF32 products (3.8 ms at 495
// TF/s; one fp32 FMA pass would be 9.4 ms at 67 TF/s) over 9.8 GB of TF32
// planes (2.9 ms).  The A panels are
// the dominant bytes; groups advance in order, so the B windows of
// neighbouring groups (5.8 MB each, mostly shared) stay in the 50 MB L2.
// The pre-split B pair moves the same bytes as fp32 B (two bf16 halves),
// and saves the split that every consumer thread of #1 makes of its
// fragments.

#include "panel_tiles.cuh"
#include "x3_wgmma.cuh"

extern "C" {

int crp_window_sg_presplit(const void* ws, const void* ah, const void* al,
                           const void* b, void* c, int64_t G, int64_t TM,
                           int64_t W, int64_t n, void* stream)
{
    return crp::launch_wgmma<crp::WgMode::SPLIT_B>(ws, ah, al, b, nullptr, c, G, TM, W,
                                                    n, stream);
}

int crp_window_sg_presplit_ab(const void* ws, const void* ah, const void* al,
                              const void* bh, const void* bl, void* c,
                              int64_t G, int64_t TM, int64_t W, int64_t n,
                              void* stream)
{
    return crp::launch_wgmma<crp::WgMode::PAIR_B>(ws, ah, al, bh, bl, c, G, TM, W, n,
                                                   stream);
}

int crp_window_sg_bf16(const void* ws, const void* ah, const void* bh,
                       void* c, int64_t G, int64_t TM, int64_t W, int64_t n,
                       void* stream)
{
    return crp::launch_wgmma<crp::WgMode::ONE_PASS>(ws, ah, nullptr, bh, nullptr, c, G,
                                                    TM, W, n, stream);
}

int crp_window_sg_f32(const void* ws, const void* tiles, const void* b,
                      void* c, int64_t G, int64_t TM, int64_t W, int64_t n,
                      void* stream)
{
    // tiles: the (2, G, TM, W) TF32 planes, big then small (see x3_wgmma.cuh)
    const float* big = static_cast<const float*>(tiles);
    return crp::launch_wgmma<crp::WgMode::TF32X3>(ws, big, big + G * TM * W, b, nullptr, c, G,
                                                   TM, W, n, stream);
}

// the wgmma body's rings and resources, x3, one-pass and TF32X3
// (crp::x3_layout)
int crp_x3_layout(char* out, int len)
{
    return crp::x3_layout<true, false, false, true>(out, len);
}

const char* crp_error_string(int code)
{
    return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
