// Hopper kernels of the fused halo exchange + windowed SpMM, for the p row
// shards of a multi-shard engine held on one card.  Shard i's G row groups
// of TM rows are groups i*G .. i*G + G - 1 of one launch, and
//
//     C[(i*G + g)*TM + r, j] = sum_{k < W} A[i, g, r, k] * B[ws[i, g] + k, j]
//
// with A the dense (p, G, TM, W) window panels, ws the global window starts
// (multiples of 128), B the global B, and C the (p*G*TM, n) output.  B is
// never assembled: it is the (p*max_k, n) stack of the shards' own row
// blocks, and global row r is row chunk_src[r / 128] + r % 128 of that
// stack, in the shard that owns it (ownership boundaries are 128-row
// aligned), or zero past the matrix (chunk_src -1).  So each row group
// reads its window straight from the owners' rows, with no receive buffer
// and no exchange copy.
//
// Replaces crp_tpu/kernels/spmm_halo.py _halo_kernel (wrapper
// halo_spmm_local).  On a TPU each shard is its own chip: the kernel pushes
// every owned 128-row chunk into the consumers' window buffers by remote
// DMA, gates its window reads on per-owner arrival semaphores, and starts
// with a barrier so that one exec's pushes never land in a buffer the last
// exec still reads.  On one card the owners' rows are in the same memory:
// the push becomes the read through chunk_src, and stream order (B written
// before the launch, C read after it) is the barrier.  At the pack's
// operating point, as the TPU kernel:
//   crp_halo_x3    <- "x3": the panels arrive as bf16 hi/lo, split once in
//                     RNE when they are packed, B split to bf16 hi/lo in
//                     registers, acc += al*bh + ah*bl + ah*bh in fp32: #4's
//                     wgmma body fed by TMA (x3_wgmma.cuh) with the chunk
//                     lookup on the producer's B copy, once a 64-row stage
//   crp_halo_bf16  <- DEFAULT: the panels' bf16 hi plane, rounded once in
//                     RNE when they are packed, and B cast to bf16 by the
//                     caller, one product: #4's one-pass wgmma body
//                     (x3_wgmma.cuh, ONE_PASS) with the same chunk lookup
//   crp_halo_f32   <- HIGHEST: 3xTF32 on the TF32 tensor cores
//                     (panel_tf32x3_kernel, #4's crp_window_f32 body): a
//                     4-stage cp.async ring, dead chunks zero-filled by
//                     the copy, three TF32 products per k step
//   crp_halo_f64   <- fp64 panels: fp64 FMA
// Each body is #4's (window.cu) with the chunk lookup on the B load, the
// per-32-row IEEE sums included.  At the p = 4 headline (4 x 214 groups,
// W = 5632, n = 256) a pass is 632 GFLOP: x3's three bf16 passes 1.92 ms
// at 989 TF/s (over 4.94 GB of hi/lo panels, 1.47 ms at 3.35 TB/s),
// DEFAULT's one pass 0.64 ms, bound by its 2.47 GB of hi panels (0.74 ms),
// HIGHEST's three TF32 passes 3.83 ms at 495 TF/s.

#include "panel_tiles.cuh"
#include "x3_wgmma.cuh"

extern "C" {

int crp_halo_x3(const void* chunk_src, const void* ws, const void* ah,
                const void* al, const void* b, void* c, int64_t G, int64_t TM,
                int64_t W, int64_t n, void* stream)
{
    return crp::launch_wgmma<crp::WgMode::SPLIT_B, true>(ws, ah, al, b, nullptr, c, G, TM,
                                                          W, n, stream, chunk_src);
}

// the wgmma body's rings and resources, crp_halo_x3's and crp_halo_bf16's
// (crp::x3_layout)
int crp_x3_layout(char* out, int len)
{
    return crp::x3_layout<false, true>(out, len);
}

int crp_halo_bf16(const void* chunk_src, const void* ws, const void* ah,
                  const void* bh, void* c, int64_t G, int64_t TM, int64_t W,
                  int64_t n, void* stream)
{
    return crp::launch_wgmma<crp::WgMode::ONE_PASS, true>(ws, ah, nullptr, bh, nullptr, c, G,
                                                          TM, W, n, stream, chunk_src);
}

int crp_halo_f32(const void* chunk_src, const void* ws, const void* tiles,
                 const void* b, void* c, int64_t G, int64_t TM, int64_t W,
                 int64_t n, void* stream)
{
    return crp::launch_tf32x3<true>(nullptr, ws, tiles, b, c, G, TM, W, n, stream,
                                    chunk_src);
}

// crp_halo_f32's ring and resources (crp::tf32x3_layout)
int crp_tf32x3_layout(char* out, int len)
{
    return crp::tf32x3_layout<true>(out, len);
}

int crp_halo_f64(const void* chunk_src, const void* ws, const void* tiles,
                 const void* b, void* c, int64_t G, int64_t TM, int64_t W,
                 int64_t n, void* stream)
{
    return crp::launch_fma<double, 64, 128, 8, 4, 8, true>(
        nullptr, ws, tiles, b, c, G, TM, W, n, stream, chunk_src);
}

const char* crp_error_string(int code)
{
    return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
