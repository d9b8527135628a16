// Hopper kernels for the ragged gathered-window SpMM.
//
// A ragged pack covers each TM-row group g with the column chunks
// s in [group_ptr[g], group_ptr[g + 1]); chunk s is a dense (TM, Wc) panel
// over the B rows [starts[s], starts[s] + Wc), and every entry computes
//
//     C[g*TM + r, j] = sum_{s of g} sum_{k < Wc} A[s, r, k] * B[starts[s] + k, j]
//
// into the (G*TM, n) output C, every element of which is written.  Every
// group owns at least one chunk: a group whose nonzeros all spilled owns a
// zero dummy chunk at start 0, and no-op trailing steps (zero panels) fall
// into the last group's range.  group_ptr is the exclusive cumsum of the
// pack's step_first, derived at pack time; B has >= max(starts) + Wc rows
// (checked by the Python wrapper).
//
// Replaces (crp_tpu/kernels/spmm_ragged.py):
//   crp_ragged_presplit  <- _ragged_kernel_presplit (x3: A as bf16 hi/lo,
//                           B split to bf16 hi/lo here in RNE)
//   crp_ragged_bf16      <- _ragged_kernel_bf16 (one bf16 pass)
//   crp_ragged_f32 / f64 <- _ragged_kernel (fp32 HIGHEST or fp64; FMA,
//                           never TF32)
//
// The TPU kernels walk a sequential (n-tile, step) grid with an NSLOT-deep
// rolling DMA prefetch of (panel, B chunk) pairs and a double-buffered
// per-group output block; both exist because the TPU grid is sequential.
// Here one block owns one (128-row slice of a group, n-tile) and walks the
// group's chunks itself (panel_tiles.cuh); the k-slices of all its chunks
// form one loop, each slice's MMAs summed in a fresh fragment and added
// with IEEE fp32 adds.
//
// What bounds it on an H100 at the cplaw power-law point (786,432 rows,
// (TM, Wc) = (512, 128), S = 12,289 chunks, n = 256): x3 does 3 x 412
// GFLOP of bf16 products over 3.2 GB of A panels plus 0.4 GB of B chunks
// per n-tile pass; the chunks are narrow (Wc = 128 is four 32-row
// k-slices), so the per-slice shared-memory round trip, not the tensor
// cores, is what the simple version waits on.

#include "panel_tiles.cuh"

extern "C" {

int crp_ragged_presplit(const void* group_ptr, const void* starts,
                        const void* ah, const void* al, const void* b,
                        void* c, int64_t G, int64_t TM, int64_t Wc, int64_t n,
                        void* stream)
{
    if (!group_ptr) return (int)cudaErrorInvalidValue;
    return crp::launch_mma<true>(group_ptr, starts, ah, al, b, c, G, TM, Wc,
                                 n, stream);
}

int crp_ragged_bf16(const void* group_ptr, const void* starts, const void* ah,
                    const void* bh, void* c, int64_t G, int64_t TM, int64_t Wc,
                    int64_t n, void* stream)
{
    if (!group_ptr) return (int)cudaErrorInvalidValue;
    return crp::launch_mma<false>(group_ptr, starts, ah, nullptr, bh, c, G, TM,
                                  Wc, n, stream);
}

int crp_ragged_f32(const void* group_ptr, const void* starts,
                   const void* panels, const void* b, void* c, int64_t G,
                   int64_t TM, int64_t Wc, int64_t n, void* stream)
{
    if (!group_ptr) return (int)cudaErrorInvalidValue;
    return crp::launch_fma<float, 128, 128, 8, 8, 8>(
        group_ptr, starts, panels, b, c, G, TM, Wc, n, stream);
}

int crp_ragged_f64(const void* group_ptr, const void* starts,
                   const void* panels, const void* b, void* c, int64_t G,
                   int64_t TM, int64_t Wc, int64_t n, void* stream)
{
    if (!group_ptr) return (int)cudaErrorInvalidValue;
    return crp::launch_fma<double, 64, 128, 8, 4, 8>(
        group_ptr, starts, panels, b, c, G, TM, Wc, n, stream);
}

const char* crp_error_string(int code)
{
    return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
