// Hopper kernels for the super-grouped windowed SpMM on uniform packs.
//
// Every entry computes, for a pack of G row groups of TM rows,
//
//     C[g*TM + r, j] = sum_{k < W} A[g, r, k] * B[ws[g] + k, j]
//
// with A the dense (G, TM, W) window panels, B the (rows, n) receive
// buffer (rows >= max(ws) + W, checked by the Python wrapper) and C the
// (G*TM, n) output, every element of which is written, pad groups
// included (their panels are zero).
//
// Replaces (crp_tpu/kernels/spmm_pallas.py):
//   crp_window_sg_presplit  <- _window_kernel_sg_presplit (x3: A as bf16
//                              hi/lo, B split to bf16 hi/lo here in RNE,
//                              acc += al*bh + ah*bl + ah*bh in fp32)
//   crp_window_sg_bf16      <- _window_kernel_sg_bf16 (one bf16 pass)
//   crp_window_sg_f32 / f64 <- _window_kernel_sg (register-tiled FMA in
//                              fp32 or fp64; never TF32)
//
// The TPU kernels walk a sequential grid, carry C across the k steps and
// double-buffer one B super-window per SG groups in VMEM.  Here blocks run
// unordered: each block owns one (BM x BN) output tile of one group and
// loops over that group's whole window itself, so no state crosses blocks
// and the pack's `bases`/`SG`/`Wsg` (VMEM artifacts) are not needed.
//
// What bounds it on an H100 at the pwtk-class n = 256 headline (G = 852,
// TM = 256, W = 5632): x3 does 3 x 629 GFLOP of bf16 products over 4.9 GB
// of A panels (1.9 ms at the 989 TF/s bf16 peak against 1.5 ms of HBM
// time), the 1-pass kernel 629 GFLOP over 2.5 GB (memory-bound), the fp32
// FMA kernel 629 GFLOP at the 67 TF/s fp32 peak (compute-bound).  The A
// panels are the dominant bytes: blocks are numbered N-tile fastest, so the
// N tiles of one (group, M tile) run on neighbouring blocks and the second
// read of the A tile comes from L2; groups advance in order, so the B
// windows of neighbouring groups (5.8 MB each, mostly shared) stay in the
// 50 MB L2.  Speed beyond that (wgmma, TMA, a deeper pipeline) is later
// work: this is the simple, right version.

#include <cstdint>

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>

namespace {

using bf16 = __nv_bfloat16;
namespace wmma = nvcuda::wmma;

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
window_mma_kernel(const int32_t* __restrict__ ws,
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
    const int64_t n0 = nt * MMA_BN;
    const int64_t b_row0 = ws[g];
    const bf16* a_h = ah + row0 * W;
    const bf16* a_l = X3 ? al + row0 * W : nullptr;
    const float* b_f = static_cast<const float*>(b_raw);
    const bf16* b_h = static_cast<const bf16*>(b_raw);

    // B tile: thread owns column cc and rows (tid / BN) + 2 i
    const int cc = tid & (MMA_BN - 1);
    const bool col_ok = n0 + cc < n;

    uint4 ra_h[A_VECS];
    uint4 ra_l[A_VECS];
    float rb_f[B_ELEMS];
    bf16 rb_h[B_ELEMS];

    auto load_tile = [&](int64_t k0) {
#pragma unroll
        for (int i = 0; i < A_VECS; ++i) {
            const int idx = tid + i * MMA_THREADS;
            const size_t off = (size_t)(idx >> 2) * W + k0 + (idx & 3) * 8;
            ra_h[i] = *reinterpret_cast<const uint4*>(a_h + off);
            if constexpr (X3) ra_l[i] = *reinterpret_cast<const uint4*>(a_l + off);
        }
#pragma unroll
        for (int i = 0; i < B_ELEMS; ++i) {
            const int r = (tid / MMA_BN) + (MMA_THREADS / MMA_BN) * i;
            const size_t off = (size_t)(b_row0 + k0 + r) * n + n0 + cc;
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
    // sum of the same exact products (measured at the headline).  So the
    // MMAs of one BK slice go into a fresh fragment, and the running sum is
    // kept with IEEE fp32 adds -- the TPU kernel's two levels too (an MXU
    // partial per chunk, a VPU add across chunks).
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

    // one shared-memory stage, the next tile prefetched into registers
    const int64_t nk = W / MMA_BK;
    load_tile(0);
    store_tile();
    __syncthreads();
    for (int64_t kt = 0; kt < nk; ++kt) {
        if (kt + 1 < nk) load_tile((kt + 1) * MMA_BK);
        compute_tile();
        __syncthreads();
        if (kt + 1 < nk) {
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
int launch_mma(const void* ws, const void* ah, const void* al, const void* b,
               void* c, int64_t G, int64_t TM, int64_t W, int64_t n,
               void* stream)
{
    if (G < 0 || TM <= 0 || TM % MMA_BM || W <= 0 || W % MMA_BK || n < 0)
        return (int)cudaErrorInvalidValue;
    const int64_t n_tiles = (n + MMA_BN - 1) / MMA_BN;
    const int64_t blocks = G * (TM / MMA_BM) * n_tiles;
    if (blocks > 0x7fffffff) return (int)cudaErrorInvalidConfiguration;
    if (blocks > 0)
        window_mma_kernel<X3><<<(unsigned)blocks, MMA_THREADS, 0,
                                (cudaStream_t)stream>>>(
            static_cast<const int32_t*>(ws), static_cast<const bf16*>(ah),
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
window_fma_kernel(const int32_t* __restrict__ ws,
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
    const int64_t n0 = nt * BN;
    const int64_t b_row0 = ws[g];
    const T* a = tiles + row0 * W;
    const int tx = tid % TX, ty = tid / TX;

    T ra[A_PER], rb[B_PER];
    T acc[RM][RN];
#pragma unroll
    for (int i = 0; i < RM; ++i)
#pragma unroll
        for (int j = 0; j < RN; ++j) acc[i][j] = T(0);

    auto load_tile = [&](int64_t k0) {
#pragma unroll
        for (int i = 0; i < A_PER; ++i) {
            const int idx = tid + i * NT;
            ra[i] = a[(size_t)(idx / BK) * W + k0 + idx % BK];
        }
#pragma unroll
        for (int i = 0; i < B_PER; ++i) {
            const int idx = tid + i * NT;
            const int64_t col = n0 + idx % BN;
            rb[i] = col < n ? b[(size_t)(b_row0 + k0 + idx / BN) * n + col] : T(0);
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

    const int64_t nk = W / BK;
    load_tile(0);
    store_tile();
    __syncthreads();
    for (int64_t kt = 0; kt < nk; ++kt) {
        if (kt + 1 < nk) load_tile((kt + 1) * BK);
        compute_tile();
        __syncthreads();
        if (kt + 1 < nk) {
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
int launch_fma(const void* ws, const void* tiles, const void* b, void* c,
               int64_t G, int64_t TM, int64_t W, int64_t n, void* stream)
{
    if (G < 0 || TM <= 0 || TM % BM || W <= 0 || W % BK || n < 0)
        return (int)cudaErrorInvalidValue;
    const int64_t n_tiles = (n + BN - 1) / BN;
    const int64_t blocks = G * (TM / BM) * n_tiles;
    if (blocks > 0x7fffffff) return (int)cudaErrorInvalidConfiguration;
    if (blocks > 0)
        window_fma_kernel<T, BM, BN, BK, RM, RN>
            <<<(unsigned)blocks, (BM / RM) * (BN / RN), 0,
               (cudaStream_t)stream>>>(
                static_cast<const int32_t*>(ws), static_cast<const T*>(tiles),
                static_cast<const T*>(b), static_cast<T*>(c), TM, W, n,
                n_tiles);
    return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

int crp_window_sg_presplit(const void* ws, const void* ah, const void* al,
                           const void* b, void* c, int64_t G, int64_t TM,
                           int64_t W, int64_t n, void* stream)
{
    return launch_mma<true>(ws, ah, al, b, c, G, TM, W, n, stream);
}

int crp_window_sg_bf16(const void* ws, const void* ah, const void* bh,
                       void* c, int64_t G, int64_t TM, int64_t W, int64_t n,
                       void* stream)
{
    return launch_mma<false>(ws, ah, nullptr, bh, c, G, TM, W, n, stream);
}

int crp_window_sg_f32(const void* ws, const void* tiles, const void* b,
                      void* c, int64_t G, int64_t TM, int64_t W, int64_t n,
                      void* stream)
{
    return launch_fma<float, 128, 128, 8, 8, 8>(ws, tiles, b, c, G, TM, W, n,
                                                 stream);
}

int crp_window_sg_f64(const void* ws, const void* tiles, const void* b,
                      void* c, int64_t G, int64_t TM, int64_t W, int64_t n,
                      void* stream)
{
    return launch_fma<double, 64, 128, 8, 4, 8>(ws, tiles, b, c, G, TM, W, n,
                                                 stream);
}

const char* crp_error_string(int code)
{
    return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
