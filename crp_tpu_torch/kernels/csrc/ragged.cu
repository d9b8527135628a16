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
// zero dummy chunk at start 0, and no-op trailing steps (zero panels) pad
// a shard of a stacked pack to the common S past its last group's range.
// group_ptr is the exclusive cumsum of the pack's step_first, derived at
// pack time; B has >= max(starts) + Wc rows (checked by the Python
// wrapper).
//
// Replaces (crp_tpu/kernels/spmm_ragged.py):
//   crp_ragged_presplit  <- _ragged_kernel_presplit (x3: A as bf16 hi/lo,
//                           B split to bf16 hi/lo in registers in RNE,
//                           acc += al*bh + ah*bl + ah*bh in fp32): the
//                           wgmma body of #1 fed by TMA (x3_wgmma.cuh) with
//                           its ragged walk
//   crp_ragged_bf16      <- _ragged_kernel_bf16 (one bf16 pass, B cast to
//                           bf16 by the caller): the same body's one-pass
//                           mode (#2's), with the same walk
//   crp_ragged_f32       <- _ragged_kernel at HIGHEST on fp32: 3xTF32 on
//                           the TF32 tensor cores, the same body's TF32X3
//                           mode (#3's) with the same walk, on the panels'
//                           TF32 big and small planes, split once when they
//                           are packed; held to the fp32 plain version
// The fp64 entry, crp_ragged_f64 (replacing _ragged_kernel on fp64), is in
// dd_tc.cu: #11's DMMA body on the FP64 tensor cores with its ragged walk,
// bound by its products (2 S TM Wc n at 67 TFLOP/s).
//
// The TPU kernels walk a sequential (n-tile, step) grid with an NSLOT-deep
// rolling DMA prefetch of (panel, B chunk) pairs and a double-buffered
// per-group output block; both exist because the TPU grid is sequential.
// Here one block owns one (128-row slice of a group, n-tile) and walks the
// group's chunks itself; the k-slices of all its chunks form one loop,
// each slice's products summed in a fresh accumulator and added with IEEE
// fp32 adds.  The wgmma body's TMA ring runs across chunk boundaries: a hub
// group's many chunks and a dummy chunk are stages like any other.
//
// What bounds it on an H100 at the cplaw power-law point (786,432 rows,
// (TM, Wc) = (512, 128), S = 12,322 chunks, n = 256): at x3 the bytes, 3.23
// GB of hi/lo panels, 0.81 GB of B and 0.81 GB of C (1.45 ms at 3.35
// TB/s) against 3 x 412 GFLOP of bf16 products (1.25 ms); in one pass the
// bytes too, 1.62 GB of hi panels, B in bf16 and C (0.84 ms).  The chunks
// are narrow (Wc = 128 is two 64-row stages), so a block walks 16 stages
// on average and its fixed costs (barrier init, filling the ring, the C
// epilogue) weigh more than on the windowed packs.  A persistent grid that
// overlapped them (tiles gridDim.x apart) measured 52% slower: the tiles
// that share a group's B chunks no longer ran side by side, and B came
// from HBM instead of L2.  At highest ((TM, Wc) = (256, 128): chunks of
// four 32-row stages) the three TF32 products (3 x 412 GFLOP at
// 495 TF/s, 2.5 ms) bound it, not its bytes: about 6.5 GB of TF32 planes,
// B and C (1.9 ms); the n tiles of one panel slice run on neighbouring
// blocks, so its later reads come from L2.

#include "panel_tiles.cuh"
#include "x3_wgmma.cuh"

extern "C" {

int crp_ragged_presplit(const void* group_ptr, const void* starts,
                        const void* ah, const void* al, const void* b,
                        void* c, int64_t G, int64_t TM, int64_t Wc, int64_t n,
                        void* stream)
{
    return crp::launch_wgmma<crp::WgMode::SPLIT_B, false, true>(
        starts, ah, al, b, nullptr, c, G, TM, Wc, n, stream, nullptr, group_ptr);
}

int crp_ragged_bf16(const void* group_ptr, const void* starts, const void* ah,
                    const void* bh, void* c, int64_t G, int64_t TM, int64_t Wc,
                    int64_t n, void* stream)
{
    return crp::launch_wgmma<crp::WgMode::ONE_PASS, false, true>(
        starts, ah, nullptr, bh, nullptr, c, G, TM, Wc, n, stream, nullptr, group_ptr);
}

// the wgmma body's rings and resources, x3 (#7), one-pass (#8) and TF32
// (#6) (crp::x3_layout)
int crp_x3_layout(char* out, int len)
{
    return crp::x3_layout<false, false, true, true>(out, len);
}

// big, small: the (S, TM, Wc) TF32 planes (see x3_wgmma.cuh)
int crp_ragged_f32(const void* group_ptr, const void* starts, const void* big,
                   const void* small, const void* b, void* c, int64_t G, int64_t TM,
                   int64_t Wc, int64_t n, void* stream)
{
    return crp::launch_wgmma<crp::WgMode::TF32X3, false, true>(
        starts, big, small, b, nullptr, c, G, TM, Wc, n, stream, nullptr, group_ptr);
}

const char* crp_error_string(int code)
{
    return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
