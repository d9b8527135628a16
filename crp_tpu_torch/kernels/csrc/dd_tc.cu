// Hopper kernel for the fp64-class ragged SpMM on the FP64 tensor cores.
//
// The pack is the ragged total cover of the dd_mxu kind (every nonzero in
// a chunk panel, no spill), with fp64 panels: group g owns the chunks
// s in [group_ptr[g], group_ptr[g + 1]), chunk s is a dense (TM, Wc) fp64
// panel over the B rows [starts[s], starts[s] + Wc), and the entry computes
//
//     C[g*TM + r, j] = sum_{s of g} sum_{k < Wc} A[s, r, k] * B[starts[s] + k, j]
//
// in fp64 into the (G*TM, n) output, every element of which is written
// (pad groups own zero dummy chunks and come out zero).  It reads the same
// step arrays as the ragged kernels (ragged.cu).
//
// Replaces crp_ragged_dd_f64tc <- _ragged_kernel_dd (spmm_dd_mxu.py), which
// reaches fp64-class accuracy on a TPU, whose matrix unit has no fp64, by
// cutting A into 7 bf16 integer slices (Ozaki), B into 7 more in the
// kernel, and summing 34 exact bf16 passes in double-float.  Hopper's
// tensor cores multiply fp64 directly (DMMA), so the port keeps the
// contract (the same total cover, C to <= 1e-12) and drops the mechanism:
// one fp64 pass, fp64 panels, fp64 B and C.  wgmma has no fp64 form;
// mma.sync is the route.
//
// Layout: one block per (64-row slice of a group, 64-column n-tile), four
// warps of 32 x 32, each a 4 x 4 grid of mma.sync.m8n8k4 f64 tiles.  The
// block walks its group's chunks in 16-deep k slices as one loop (the
// tile walk of panel_tiles.cuh): one shared-memory stage, the next slice
// prefetched into registers.  The fragments of m8n8k4 f64 hold one A and
// one B double per lane (A[lane / 4][lane % 4], B[lane % 4][lane / 4]) and
// two C doubles (C[lane / 4][2 (lane % 4) + i]); the shared-memory pitches
// are padded so that each half-warp's fragment reads hit 32 distinct banks.
// What bounds it: at the banded fp64 point (S = 3,402 chunks of 128 x 512,
// n = 256) 114 GFLOP of panel work against 1.8 GB of panels, read once per
// n-tile (L2 serves the re-reads of neighbouring blocks); the simple
// single-stage pipeline leaves it latency-bound, well under the 67 TFLOP/s
// FP64 tensor-core peak.  TMA and a deeper pipeline are later work.

#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int DD_BM = 64;
constexpr int DD_BN = 64;
constexpr int DD_BK = 16;
constexpr int DD_THREADS = 128;   // 4 warps: 2 along M x 2 along N
constexpr int A_LD = DD_BK + 4;   // smem pitches (doubles)
constexpr int B_LD = DD_BN + 4;
constexpr int A_PER = DD_BM * DD_BK / DD_THREADS;  // A doubles per thread
constexpr int B_PER = DD_BK * DD_BN / DD_THREADS;  // B doubles per thread

// d += a (8x4, row) * b (4x8, col), fp64 on the tensor cores
__device__ __forceinline__ void dmma_8x8x4(double& d0, double& d1, double a,
                                           double b)
{
    asm volatile(
        "mma.sync.aligned.m8n8k4.row.col.f64.f64.f64.f64 "
        "{%0, %1}, {%2}, {%3}, {%0, %1};\n"
        : "+d"(d0), "+d"(d1)
        : "d"(a), "d"(b));
}

__global__ void __launch_bounds__(DD_THREADS)
ragged_dd_kernel(const int32_t* __restrict__ group_ptr,
                 const int32_t* __restrict__ starts,
                 const double* __restrict__ panels,
                 const double* __restrict__ b,
                 double* __restrict__ c,
                 int64_t TM, int64_t W, int64_t n, int64_t n_tiles)
{
    __shared__ __align__(16) double As[DD_BM][A_LD];
    __shared__ __align__(16) double Bs[DD_BK][B_LD];

    const int tid = threadIdx.x;
    const int64_t tile = blockIdx.x;
    const int64_t nt = tile % n_tiles;
    const int64_t row0 = (tile / n_tiles) * DD_BM;  // first C row
    const int64_t g = row0 / TM;                     // TM % DD_BM == 0
    const int64_t r_in = row0 - g * TM;
    const int64_t n0 = nt * DD_BN;
    const int64_t s_begin = group_ptr[g];
    const int64_t s_end = group_ptr[g + 1];
    const int64_t nk = W / DD_BK;

    double ra[A_PER], rb[B_PER];

    // slice t of the group's walk: chunk s_begin + t / nk, k0 = (t % nk) BK
    auto load_tile = [&](int64_t t) {
        const int64_t s = s_begin + t / nk;
        const int64_t k0 = (t % nk) * DD_BK;
        const int64_t b_row0 = starts[s] + k0;
        const double* a = panels + (size_t)(s * TM + r_in) * W + k0;
#pragma unroll
        for (int i = 0; i < A_PER; ++i) {
            const int idx = tid + i * DD_THREADS;
            ra[i] = a[(size_t)(idx / DD_BK) * W + idx % DD_BK];
        }
#pragma unroll
        for (int i = 0; i < B_PER; ++i) {
            const int idx = tid + i * DD_THREADS;
            const int64_t col = n0 + idx % DD_BN;
            rb[i] = col < n ? b[(size_t)(b_row0 + idx / DD_BN) * n + col] : 0.0;
        }
    };
    auto store_tile = [&]() {
#pragma unroll
        for (int i = 0; i < A_PER; ++i) {
            const int idx = tid + i * DD_THREADS;
            As[idx / DD_BK][idx % DD_BK] = ra[i];
        }
#pragma unroll
        for (int i = 0; i < B_PER; ++i) {
            const int idx = tid + i * DD_THREADS;
            Bs[idx / DD_BN][idx % DD_BN] = rb[i];
        }
    };

    const int warp = tid >> 5, lane = tid & 31;
    const int wm = warp >> 1;  // 32-row slab of the tile
    const int wn = warp & 1;   // 32-column slab of the tile
    const int gid = lane >> 2, tig = lane & 3;

    double acc[4][4][2];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j][0] = acc[i][j][1] = 0.0;

    auto compute_tile = [&]() {
#pragma unroll
        for (int kk = 0; kk < DD_BK; kk += 4) {
            double af[4], bf[4];
#pragma unroll
            for (int i = 0; i < 4; ++i) af[i] = As[wm * 32 + i * 8 + gid][kk + tig];
#pragma unroll
            for (int j = 0; j < 4; ++j) bf[j] = Bs[kk + tig][wn * 32 + j * 8 + gid];
#pragma unroll
            for (int i = 0; i < 4; ++i)
#pragma unroll
                for (int j = 0; j < 4; ++j)
                    dmma_8x8x4(acc[i][j][0], acc[i][j][1], af[i], bf[j]);
        }
    };

    const int64_t nt_k = (s_end - s_begin) * nk;
    if (nt_k > 0) {
        load_tile(0);
        store_tile();
        __syncthreads();
    }
    for (int64_t kt = 0; kt < nt_k; ++kt) {
        if (kt + 1 < nt_k) load_tile(kt + 1);
        compute_tile();
        __syncthreads();
        if (kt + 1 < nt_k) {
            store_tile();
            __syncthreads();
        }
    }

    // the n edge is masked here (n is not padded)
#pragma unroll
    for (int i = 0; i < 4; ++i) {
        const size_t row = (size_t)(row0 + wm * 32 + i * 8 + gid);
#pragma unroll
        for (int j = 0; j < 4; ++j) {
            const int64_t col = n0 + wn * 32 + j * 8 + 2 * tig;
            if (col < n) c[row * n + col] = acc[i][j][0];
            if (col + 1 < n) c[row * n + col + 1] = acc[i][j][1];
        }
    }
}

}  // namespace

extern "C" {

// group_ptr (G + 1,), starts (S,), panels (S, TM, Wc) fp64, b (rows >=
// max(starts) + Wc, n) fp64, c (G*TM, n) fp64; TM % 64 == 0, Wc % 16 == 0.
int crp_ragged_dd_f64tc(const void* group_ptr, const void* starts,
                        const void* panels, const void* b, void* c, int64_t G,
                        int64_t TM, int64_t Wc, int64_t n, void* stream)
{
    if (!group_ptr || G < 0 || TM <= 0 || TM % DD_BM || Wc <= 0 ||
        Wc % DD_BK || n < 0)
        return (int)cudaErrorInvalidValue;
    const int64_t n_tiles = (n + DD_BN - 1) / DD_BN;
    const int64_t blocks = G * (TM / DD_BM) * n_tiles;
    if (blocks > 0x7fffffff) return (int)cudaErrorInvalidConfiguration;
    if (blocks > 0)
        ragged_dd_kernel<<<(unsigned)blocks, DD_THREADS, 0,
                           (cudaStream_t)stream>>>(
            static_cast<const int32_t*>(group_ptr),
            static_cast<const int32_t*>(starts),
            static_cast<const double*>(panels), static_cast<const double*>(b),
            static_cast<double*>(c), TM, Wc, n, n_tiles);
    return (int)cudaGetLastError();
}

const char* crp_error_string(int code)
{
    return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
