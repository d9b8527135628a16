// Tile kernels shared by the windowed (window_sg.cu) and the ragged
// (ragged.cu) SpMM entries.
//
// A pack covers G row groups of TM rows.  Group g owns the chunks
// s in [s_begin(g), s_end(g)); chunk s is a dense (TM, W) panel of A over
// the B rows [starts[s], starts[s] + W), and
//
//     C[g*TM + r, j] = sum_s sum_{k < W} A[s, r, k] * B[starts[s] + k, j].
//
// With group_ptr == nullptr every group owns exactly the chunk s = g (the
// uniform windowed pack, starts = ws); otherwise the chunks of g are
// [group_ptr[g], group_ptr[g + 1]) (the ragged pack).  Every element of the
// (G*TM, n) output C is written, pad groups included (their panels are
// zero).
//
// The TPU kernels walk a sequential grid and carry C across steps in VMEM.
// Here blocks run unordered: each block owns one (BM x BN) output tile of
// one group and walks that group's chunks itself, k-slice by k-slice as one
// linear loop, so the register prefetch of the next slice runs across chunk
// boundaries and no state crosses blocks.  Blocks are numbered N-tile
// fastest, so the N tiles of one (group, M tile) run on neighbouring blocks
// and the second read of an A slice comes from L2.  Speed beyond that
// (wgmma, TMA, a deeper pipeline) is later work: this is the simple, right
// version.

#pragma once

#include <cstdint>

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>

namespace crp {

using bf16 = __nv_bfloat16;
namespace wmma = nvcuda::wmma;

// chunk range of group g (see above)
__device__ __forceinline__ void group_chunks(const int32_t* group_ptr,
                                             int64_t g, int64_t* s_begin,
                                             int64_t* s_end)
{
    *s_begin = group_ptr ? group_ptr[g] : g;
    *s_end = group_ptr ? group_ptr[g + 1] : g + 1;
}

// ---------------------------------------------------------------- bf16 MMA

constexpr int MMA_BM = 128;
constexpr int MMA_BN = 128;
constexpr int MMA_BK = 32;
constexpr int MMA_THREADS = 256;  // 8 warps: 2 along M x 4 along N
constexpr int A_LD = MMA_BK + 8;  // smem pitches (elements): multiples of 8
constexpr int B_LD = MMA_BN + 8;  // for wmma, padded against bank conflicts
constexpr int A_VECS = MMA_BM * MMA_BK / 8 / MMA_THREADS;  // uint4 per thread
constexpr int B_ELEMS = MMA_BK * MMA_BN / MMA_THREADS;     // per thread

// X3: A arrives as bf16 hi/lo, B as fp32 and is split here.
// !X3: A hi only, B already bf16 (cast by the caller).
template <bool X3>
__global__ void __launch_bounds__(MMA_THREADS)
panel_mma_kernel(const int32_t* __restrict__ group_ptr,
                 const int32_t* __restrict__ starts,
                 const bf16* __restrict__ ah,
                 const bf16* __restrict__ al,
                 const void* __restrict__ b_raw,
                 float* __restrict__ c,
                 int64_t TM, int64_t W, int64_t n, int64_t n_tiles)
{
    __shared__ __align__(128) bf16 As_h[MMA_BM][A_LD];
    __shared__ __align__(128) bf16 As_l[X3 ? MMA_BM : 1][A_LD];
    __shared__ __align__(128) bf16 Bs_h[MMA_BK][B_LD];
    __shared__ __align__(128) bf16 Bs_l[X3 ? MMA_BK : 1][B_LD];
    __shared__ __align__(128) float Cs[MMA_THREADS / 32][16 * 16];

    const int tid = threadIdx.x;
    const int64_t tile = blockIdx.x;
    const int64_t nt = tile % n_tiles;
    const int64_t row0 = (tile / n_tiles) * MMA_BM;  // first C row
    const int64_t g = row0 / TM;                      // TM % MMA_BM == 0
    const int64_t r_in = row0 - g * TM;               // first row in the group
    const int64_t n0 = nt * MMA_BN;
    int64_t s_begin, s_end;
    group_chunks(group_ptr, g, &s_begin, &s_end);
    const int64_t nk = W / MMA_BK;                    // k slices per chunk
    const float* b_f = static_cast<const float*>(b_raw);
    const bf16* b_h = static_cast<const bf16*>(b_raw);

    // B tile: thread owns column cc and rows (tid / BN) + 2 i
    const int cc = tid & (MMA_BN - 1);
    const bool col_ok = n0 + cc < n;

    uint4 ra_h[A_VECS];
    uint4 ra_l[A_VECS];
    float rb_f[B_ELEMS];
    bf16 rb_h[B_ELEMS];

    // slice t of the group's walk: chunk s_begin + t / nk, k0 = (t % nk) BK
    auto load_tile = [&](int64_t t) {
        const int64_t s = s_begin + t / nk;
        const int64_t k0 = (t % nk) * MMA_BK;
        const int64_t b_row0 = starts[s] + k0;
        const size_t a0 = (size_t)(s * TM + r_in) * W + k0;
#pragma unroll
        for (int i = 0; i < A_VECS; ++i) {
            const int idx = tid + i * MMA_THREADS;
            const size_t off = a0 + (size_t)(idx >> 2) * W + (idx & 3) * 8;
            ra_h[i] = *reinterpret_cast<const uint4*>(ah + off);
            if constexpr (X3) ra_l[i] = *reinterpret_cast<const uint4*>(al + off);
        }
#pragma unroll
        for (int i = 0; i < B_ELEMS; ++i) {
            const int r = (tid / MMA_BN) + (MMA_THREADS / MMA_BN) * i;
            const size_t off = (size_t)(b_row0 + r) * n + n0 + cc;
            if constexpr (X3) rb_f[i] = col_ok ? b_f[off] : 0.0f;
            else rb_h[i] = col_ok ? b_h[off] : __float2bfloat16_rn(0.0f);
        }
    };

    auto store_tile = [&]() {
#pragma unroll
        for (int i = 0; i < A_VECS; ++i) {
            const int idx = tid + i * MMA_THREADS;
            const int r = idx >> 2, k8 = (idx & 3) * 8;
            *reinterpret_cast<uint4*>(&As_h[r][k8]) = ra_h[i];
            if constexpr (X3) *reinterpret_cast<uint4*>(&As_l[r][k8]) = ra_l[i];
        }
#pragma unroll
        for (int i = 0; i < B_ELEMS; ++i) {
            const int r = (tid / MMA_BN) + (MMA_THREADS / MMA_BN) * i;
            if constexpr (X3) {
                // RNE split, the same as the pack's A split and the plain
                // version's .to(torch.bfloat16): never truncate
                const bf16 hi = __float2bfloat16_rn(rb_f[i]);
                Bs_h[r][cc] = hi;
                Bs_l[r][cc] = __float2bfloat16_rn(rb_f[i] - __bfloat162float(hi));
            } else {
                Bs_h[r][cc] = rb_h[i];
            }
        }
    };

    const int warp = tid >> 5;
    const int wm = warp >> 2;  // 64-row slab of the tile
    const int wn = warp & 3;   // 32-column slab of the tile

    wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[4][2];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 2; ++j) wmma::fill_fragment(acc[i][j], 0.0f);

    // The tensor cores' fp32 accumulation does not round to nearest: carried
    // over a whole 5632-row window it drifts ~2e-6 (relative) from an IEEE
    // sum of the same exact products (measured at the windowed headline).
    // So the MMAs of one BK slice go into a fresh fragment, and the running
    // sum is kept with IEEE fp32 adds -- the TPU kernels' two levels too (an
    // MXU partial per chunk, a VPU add across chunks).
    auto compute_tile = [&]() {
        constexpr int KS = MMA_BK / 16;
        wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major>
            fb_h[KS][2], fb_l[KS][2];
#pragma unroll
        for (int s = 0; s < KS; ++s) {
#pragma unroll
            for (int j = 0; j < 2; ++j) {
                wmma::load_matrix_sync(fb_h[s][j], &Bs_h[s * 16][wn * 32 + j * 16], B_LD);
                if constexpr (X3)
                    wmma::load_matrix_sync(fb_l[s][j], &Bs_l[s * 16][wn * 32 + j * 16], B_LD);
            }
        }
#pragma unroll
        for (int i = 0; i < 4; ++i) {
            wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major>
                fa_h[KS], fa_l[KS];
#pragma unroll
            for (int s = 0; s < KS; ++s) {
                wmma::load_matrix_sync(fa_h[s], &As_h[wm * 64 + i * 16][s * 16], A_LD);
                if constexpr (X3)
                    wmma::load_matrix_sync(fa_l[s], &As_l[wm * 64 + i * 16][s * 16], A_LD);
            }
#pragma unroll
            for (int j = 0; j < 2; ++j) {
                wmma::fragment<wmma::accumulator, 16, 16, 16, float> part;
                wmma::fill_fragment(part, 0.0f);
#pragma unroll
                for (int s = 0; s < KS; ++s) {
                    if constexpr (X3) {
                        wmma::mma_sync(part, fa_l[s], fb_h[s][j], part);
                        wmma::mma_sync(part, fa_h[s], fb_l[s][j], part);
                    }
                    wmma::mma_sync(part, fa_h[s], fb_h[s][j], part);
                }
#pragma unroll
                for (int e = 0; e < part.num_elements; ++e)
                    acc[i][j].x[e] += part.x[e];
            }
        }
    };

    // one shared-memory stage, the next slice prefetched into registers
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

    // epilogue: each warp stages one 16x16 fragment at a time and writes
    // the columns below n (the ragged N edge is masked here, n is not padded)
    float* cs = Cs[warp];
    const int lane = tid & 31;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
#pragma unroll
        for (int j = 0; j < 2; ++j) {
            wmma::store_matrix_sync(cs, acc[i][j], 16, wmma::mem_row_major);
            __syncwarp();
            const int64_t r0 = row0 + wm * 64 + i * 16;
            const int64_t c0 = n0 + wn * 32 + j * 16;
            for (int e = lane; e < 256; e += 32) {
                const int64_t col = c0 + (e & 15);
                if (col < n) c[(size_t)(r0 + (e >> 4)) * n + col] = cs[e];
            }
            __syncwarp();
        }
    }
}

template <bool X3>
int launch_mma(const void* group_ptr, const void* starts, const void* ah,
               const void* al, const void* b, void* c, int64_t G, int64_t TM,
               int64_t W, int64_t n, void* stream)
{
    if (G < 0 || TM <= 0 || TM % MMA_BM || W <= 0 || W % MMA_BK || n < 0)
        return (int)cudaErrorInvalidValue;
    const int64_t n_tiles = (n + MMA_BN - 1) / MMA_BN;
    const int64_t blocks = G * (TM / MMA_BM) * n_tiles;
    if (blocks > 0x7fffffff) return (int)cudaErrorInvalidConfiguration;
    if (blocks > 0)
        panel_mma_kernel<X3><<<(unsigned)blocks, MMA_THREADS, 0,
                               (cudaStream_t)stream>>>(
            static_cast<const int32_t*>(group_ptr),
            static_cast<const int32_t*>(starts), static_cast<const bf16*>(ah),
            static_cast<const bf16*>(al), b, static_cast<float*>(c),
            TM, W, n, n_tiles);
    return (int)cudaGetLastError();
}

// --------------------------------------------------------------- FMA path

__device__ __forceinline__ float fma_rn(float a, float b, float c)
{
    return __fmaf_rn(a, b, c);
}

__device__ __forceinline__ double fma_rn(double a, double b, double c)
{
    return __fma_rn(a, b, c);
}

// Block tile BM x BN, k step BK; each thread owns RM consecutive rows and
// RN columns strided by BN / RN (neighbouring threads on neighbouring
// columns: conflict-free B reads and coalesced C writes).
template <typename T, int BM, int BN, int BK, int RM, int RN>
__global__ void __launch_bounds__((BM / RM) * (BN / RN))
panel_fma_kernel(const int32_t* __restrict__ group_ptr,
                 const int32_t* __restrict__ starts,
                 const T* __restrict__ tiles,
                 const T* __restrict__ b,
                 T* __restrict__ c,
                 int64_t TM, int64_t W, int64_t n, int64_t n_tiles)
{
    constexpr int NT = (BM / RM) * (BN / RN);
    constexpr int TX = BN / RN;
    constexpr int A_PER = BM * BK / NT;
    constexpr int B_PER = BK * BN / NT;
    __shared__ __align__(16) T As[BK][BM + 4];  // transposed: As[k][m]
    __shared__ __align__(16) T Bs[BK][BN];

    const int tid = threadIdx.x;
    const int64_t tile = blockIdx.x;
    const int64_t nt = tile % n_tiles;
    const int64_t row0 = (tile / n_tiles) * BM;
    const int64_t g = row0 / TM;  // TM % BM == 0
    const int64_t r_in = row0 - g * TM;
    const int64_t n0 = nt * BN;
    int64_t s_begin, s_end;
    group_chunks(group_ptr, g, &s_begin, &s_end);
    const int64_t nk = W / BK;
    const int tx = tid % TX, ty = tid / TX;

    T ra[A_PER], rb[B_PER];
    T acc[RM][RN];
#pragma unroll
    for (int i = 0; i < RM; ++i)
#pragma unroll
        for (int j = 0; j < RN; ++j) acc[i][j] = T(0);

    auto load_tile = [&](int64_t t) {
        const int64_t s = s_begin + t / nk;
        const int64_t k0 = (t % nk) * BK;
        const int64_t b_row0 = starts[s] + k0;
        const T* a = tiles + (size_t)(s * TM + r_in) * W + k0;
#pragma unroll
        for (int i = 0; i < A_PER; ++i) {
            const int idx = tid + i * NT;
            ra[i] = a[(size_t)(idx / BK) * W + idx % BK];
        }
#pragma unroll
        for (int i = 0; i < B_PER; ++i) {
            const int idx = tid + i * NT;
            const int64_t col = n0 + idx % BN;
            rb[i] = col < n ? b[(size_t)(b_row0 + idx / BN) * n + col] : T(0);
        }
    };
    auto store_tile = [&]() {
#pragma unroll
        for (int i = 0; i < A_PER; ++i) {
            const int idx = tid + i * NT;
            As[idx % BK][idx / BK] = ra[i];
        }
#pragma unroll
        for (int i = 0; i < B_PER; ++i) {
            const int idx = tid + i * NT;
            Bs[idx / BN][idx % BN] = rb[i];
        }
    };
    auto compute_tile = [&]() {
#pragma unroll
        for (int kk = 0; kk < BK; ++kk) {
            T av[RM], bv[RN];
#pragma unroll
            for (int i = 0; i < RM; ++i) av[i] = As[kk][ty * RM + i];
#pragma unroll
            for (int j = 0; j < RN; ++j) bv[j] = Bs[kk][tx + j * TX];
#pragma unroll
            for (int i = 0; i < RM; ++i)
#pragma unroll
                for (int j = 0; j < RN; ++j)
                    acc[i][j] = fma_rn(av[i], bv[j], acc[i][j]);
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

#pragma unroll
    for (int i = 0; i < RM; ++i) {
        const size_t row = (size_t)(row0 + ty * RM + i);
#pragma unroll
        for (int j = 0; j < RN; ++j) {
            const int64_t col = n0 + tx + j * TX;
            if (col < n) c[row * n + col] = acc[i][j];
        }
    }
}

template <typename T, int BM, int BN, int BK, int RM, int RN>
int launch_fma(const void* group_ptr, const void* starts, const void* tiles,
               const void* b, void* c, int64_t G, int64_t TM, int64_t W,
               int64_t n, void* stream)
{
    if (G < 0 || TM <= 0 || TM % BM || W <= 0 || W % BK || n < 0)
        return (int)cudaErrorInvalidValue;
    const int64_t n_tiles = (n + BN - 1) / BN;
    const int64_t blocks = G * (TM / BM) * n_tiles;
    if (blocks > 0x7fffffff) return (int)cudaErrorInvalidConfiguration;
    if (blocks > 0)
        panel_fma_kernel<T, BM, BN, BK, RM, RN>
            <<<(unsigned)blocks, (BM / RM) * (BN / RN), 0,
               (cudaStream_t)stream>>>(
                static_cast<const int32_t*>(group_ptr),
                static_cast<const int32_t*>(starts),
                static_cast<const T*>(tiles), static_cast<const T*>(b),
                static_cast<T*>(c), TM, W, n, n_tiles);
    return (int)cudaGetLastError();
}

}  // namespace crp
