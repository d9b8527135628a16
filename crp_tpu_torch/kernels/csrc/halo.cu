// Hopper kernels of the fused halo exchange + windowed SpMM.  A launch
// covers G row groups of TM rows: on one card every group of the p row
// shards of a multi-shard engine (shard i's groups i*G .. i*G + G - 1),
// across processes (one rank a shard) the groups of this rank's shard, and
//
//     C[g*TM + r, j] = sum_{k < W} A[g, r, k] * B[ws[g] + k, j]
//
// with A the dense window panels, ws the global window starts (multiples of
// 128), B the global B, and C the (G*TM, n) output.  B is never assembled:
// it lives in p owner shards of 128-row aligned row blocks, each at its own
// address, and `rows` is a device table of pointers, one per 128-row chunk
// of B: the chunk's first row in its owner's shard, null past the matrix.
// The caller makes it from the plan's (owner, row) pairs and the owners'
// base pointers (spmm_halo.py chunk_rows).  So each row group reads its
// window straight from the owners' rows, with no receive buffer and no
// exchange copy.  On one card the owners are the shards of one stacked
// (p, max_k, n) buffer; across processes they are the ranks' own B
// buffers, mapped into every peer by CUDA IPC, so the one-card and the
// cross-process kernel are one code path.
//
// Replaces crp_tpu/kernels/spmm_halo.py _halo_kernel (wrapper
// halo_spmm_local).  On a TPU each shard is its own chip: the kernel pushes
// every owned 128-row chunk into the consumers' window buffers by remote
// DMA, gates its window reads on per-owner arrival semaphores, and starts
// with a barrier so that one exec's pushes never land in a buffer the last
// exec still reads.  Here the push becomes the read through the chunks'
// pointers.  On one card stream order (B written before the launch, C read
// after it) is the barrier; across processes the caller holds a host
// barrier before the launch (every owner's B written) and one after it (no
// owner overwrites B while a peer still reads it).  At the pack's
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

// rows16: every chunk pointer is on 16 bytes (16-byte B copies where n
// allows them)
int crp_halo_x3(const void* rows, const void* ws, const void* ah, const void* al, void* c,
                int64_t G, int64_t TM, int64_t W, int64_t n, int64_t rows16, void* stream)
{
    return crp::launch_wgmma<crp::WgMode::SPLIT_B, true>(ws, ah, al, rows, nullptr, c, G, TM,
                                                          W, n, stream, rows, nullptr,
                                                          rows16 != 0);
}

// the wgmma body's rings and resources, crp_halo_x3's and crp_halo_bf16's
// (crp::x3_layout)
int crp_x3_layout(char* out, int len)
{
    return crp::x3_layout<false, true>(out, len);
}

int crp_halo_bf16(const void* rows, const void* ws, const void* ah, void* c, int64_t G,
                  int64_t TM, int64_t W, int64_t n, int64_t rows16, void* stream)
{
    return crp::launch_wgmma<crp::WgMode::ONE_PASS, true>(ws, ah, nullptr, rows, nullptr, c,
                                                          G, TM, W, n, stream, rows, nullptr,
                                                          rows16 != 0);
}

int crp_halo_f32(const void* rows, const void* ws, const void* tiles, void* c, int64_t G,
                 int64_t TM, int64_t W, int64_t n, int64_t rows16, void* stream)
{
    return crp::launch_tf32x3<true>(nullptr, ws, tiles, rows, c, G, TM, W, n, stream, rows,
                                    rows16 != 0);
}

// crp_halo_f32's ring and resources (crp::tf32x3_layout)
int crp_tf32x3_layout(char* out, int len)
{
    return crp::tf32x3_layout<true>(out, len);
}

int crp_halo_f64(const void* rows, const void* ws, const void* tiles, void* c, int64_t G,
                 int64_t TM, int64_t W, int64_t n, int64_t rows16, void* stream)
{
    (void)rows16;  // the FMA body loads B element by element
    return crp::launch_fma<double, 64, 128, 8, 4, 8, true>(nullptr, ws, tiles, rows, c, G,
                                                            TM, W, n, stream, rows);
}

const char* crp_error_string(int code)
{
    return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
