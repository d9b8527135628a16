// Hopper kernels for the fused spill of the ragged SpMM and for the gather
// kind.
//
// The spilled nonzeros of a ragged pack are regrouped on the host into
// steps of Q slots, each step inside one TMo-row block of the (M, n)
// output (crp_tpu/kernels/spmm_ragged.py pack_spill_blocks): slot q holds
// (rel[q], cols[q], vals[q]) and routes to row blk*TMo + rel[q]; pad slots
// carry rel == TMo and are skipped (never relying on 0 * B).  The steps of
// block b are [blk_ptr[b], blk_ptr[b + 1]) (blk_ptr is derived at pack time
// from the pack's `first`; trailing pad steps fall into the last block).
// The entries write the complete
//
//     out[blk*TMo + rel[q], :] = C[...] + sum over live slots q of contrib(q)
//
// with contrib(q) = vals[q] * B[cols[q], :] rounded as the TPU kernel does
// at each operating point: the fp32 product (highest), its bf16 hi + lo
// (x3), or its bf16 rounding (default).  crp_gather_blocks takes no C: its
// tile starts at zero and no C is read, so a block with no live slot comes
// out zero (the gather pack, pack_gather_blocks, holds every nonzero of a
// shard in these steps).
//
// Replaces _spill_block_kernel: crp_spill_blocks its has_c=True form (via
// spmm_spill_pallas), crp_gather_blocks its has_c=False form (via
// spmm_gather_chunked, the gather kind).  The TPU kernel routes rows with a
// one-hot MXU product and takes the gathered B rows as one (ns*Q, n) XLA
// stream, which the JAX gather kind cuts into chunks to bound its memory;
// here the kernel reads B[cols[q]] itself (no gathered stream in device
// memory, so no chunking) and adds into a shared-memory tile.
//
// Layout: one block per (output block b, 32-column n-tile); the block's
// TMo x 32 fp32 tile lives in shared memory (64 KB at TMo = 512, above the
// 48 KB default: the launch opts in).  Lane l owns column l, so each slot's
// B row segment is one coalesced 128-byte load.  The block's slots are
// staged in shared memory and dealt to the 16 warps in batches of 8: a warp
// issues the batch's 8 independent B loads, then adds the contributions
// with shared-memory float atomics.  Spreading every row over all warps is
// the point: the spill is skewed, a power-law hub row holds tens of
// thousands of spilled slots (cplaw), and a design where one warp owns a row
// serialises that row's dependent gathers (19 ms at the cplaw x3 point,
// measured on an H100).  The sum order within a row therefore varies from
// run to run: the result is not bit-deterministic.  What bounds it: the B
// row gathers (128 bytes per live slot and n-tile), at 8 in flight per warp.
// On a scrambled graph (the gather kind's matrices) those rows are random
// over a B far larger than the 50 MB L2, so nearly every one comes from
// device memory.

#include <cstdint>

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int SP_BN = 32;       // columns per block: one per lane
constexpr int SP_WARPS = 16;
constexpr int SP_THREADS = SP_WARPS * 32;
constexpr int SP_STAGE = 2048;  // slots staged in shared memory at a time
constexpr int SP_BATCH = 8;     // slots per warp step: B loads in flight
constexpr int SP_TMO_MAX = 1024;

__device__ __forceinline__ float contrib(float v, float bv, int mode)
{
    const float x = __fmul_rn(v, bv);  // no FMA contraction into the add
    if (mode == 0) return x;                           // highest
    const __nv_bfloat16 hi = __float2bfloat16_rn(x);
    const float h = __bfloat162float(hi);
    if (mode == 2) return h;                           // default
    return __fadd_rn(h, __bfloat162float(__float2bfloat16_rn(x - h)));  // x3
}

// HAS_C: the tile starts as the block of C (the spill); otherwise at zero
// and c is never read (the gather kind)
template <bool HAS_C>
__global__ void __launch_bounds__(SP_THREADS)
spill_blocks_kernel(const int32_t* __restrict__ rel,
                    const int32_t* __restrict__ cols,
                    const float* __restrict__ vals,
                    const int32_t* __restrict__ blk_ptr,
                    const float* __restrict__ c,
                    const float* __restrict__ b,
                    float* __restrict__ out,
                    int64_t TMo, int64_t Q, int64_t n, int64_t n_tiles,
                    int mode)
{
    extern __shared__ float tile[];  // TMo x SP_BN
    __shared__ int32_t s_rel[SP_STAGE];
    __shared__ int32_t s_col[SP_STAGE];
    __shared__ float s_val[SP_STAGE];

    const int tid = threadIdx.x;
    const int warp = tid >> 5, lane = tid & 31;
    const int64_t nt = blockIdx.x % n_tiles;
    const int64_t blk = blockIdx.x / n_tiles;
    const int64_t row0 = blk * TMo;  // first row of C
    const int64_t n0 = nt * SP_BN;
    const int64_t col = n0 + lane;
    const bool col_ok = col < n;

    for (int64_t i = tid; i < TMo * SP_BN; i += SP_THREADS) {
        if constexpr (HAS_C) {
            const int64_t r = i / SP_BN, j = i % SP_BN;
            tile[i] = n0 + j < n ? c[(size_t)(row0 + r) * n + n0 + j] : 0.0f;
        } else {
            tile[i] = 0.0f;
        }
    }

    const int64_t q0 = (int64_t)blk_ptr[blk] * Q;
    const int64_t q1 = (int64_t)blk_ptr[blk + 1] * Q;
    for (int64_t qs = q0; qs < q1; qs += SP_STAGE) {
        const int cnt = (int)min((int64_t)SP_STAGE, q1 - qs);
        __syncthreads();  // the previous stage is consumed (and the tile set)
        for (int i = tid; i < cnt; i += SP_THREADS) {
            s_rel[i] = rel[qs + i];
            s_col[i] = cols[qs + i];
            s_val[i] = vals[qs + i];
        }
        __syncthreads();
        for (int i0 = warp * SP_BATCH; i0 < cnt; i0 += SP_WARPS * SP_BATCH) {
            float bv[SP_BATCH];
#pragma unroll
            for (int u = 0; u < SP_BATCH; ++u) {
                const int i = i0 + u;
                // pad slots (rel == TMo) are skipped, never multiplied by 0
                const bool live = i < cnt && s_rel[i] < TMo && col_ok;
                bv[u] = live ? b[(size_t)s_col[i] * n + col] : 0.0f;
            }
#pragma unroll
            for (int u = 0; u < SP_BATCH; ++u) {
                const int i = i0 + u;
                if (i < cnt && s_rel[i] < TMo && col_ok)
                    atomicAdd(&tile[s_rel[i] * SP_BN + lane],
                              contrib(s_val[i], bv[u], mode));
            }
        }
    }
    __syncthreads();

    for (int64_t i = tid; i < TMo * SP_BN; i += SP_THREADS) {
        const int64_t r = i / SP_BN, j = i % SP_BN;
        if (n0 + j < n) out[(size_t)(row0 + r) * n + n0 + j] = tile[i];
    }
}

template <bool HAS_C>
int launch_blocks(const void* rel, const void* cols, const void* vals,
                  const void* blk_ptr, const void* c, const void* b, void* out,
                  int64_t nblk, int64_t TMo, int64_t Q, int64_t n,
                  int64_t mode, void* stream)
{
    if (nblk < 0 || TMo <= 0 || TMo > SP_TMO_MAX || Q <= 0 || n < 0 ||
        mode < 0 || mode > 2)
        return (int)cudaErrorInvalidValue;
    const int64_t n_tiles = (n + SP_BN - 1) / SP_BN;
    const int64_t blocks = nblk * n_tiles;
    if (blocks > 0x7fffffff) return (int)cudaErrorInvalidConfiguration;
    const int smem = (int)(TMo * SP_BN * sizeof(float));
    cudaError_t err = cudaFuncSetAttribute(
        spill_blocks_kernel<HAS_C>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        smem);
    if (err != cudaSuccess) return (int)err;
    if (blocks > 0)
        spill_blocks_kernel<HAS_C><<<(unsigned)blocks, SP_THREADS, smem,
                                     (cudaStream_t)stream>>>(
            static_cast<const int32_t*>(rel), static_cast<const int32_t*>(cols),
            static_cast<const float*>(vals), static_cast<const int32_t*>(blk_ptr),
            static_cast<const float*>(c), static_cast<const float*>(b),
            static_cast<float*>(out), TMo, Q, n, n_tiles, (int)mode);
    return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// rel (ns, 1, Q), cols / vals (ns, Q), blk_ptr (nblk + 1,), c / out (M, n)
// with M = nblk * TMo, b (rows > every live col, n); mode 0 highest,
// 1 x3, 2 default.
int crp_spill_blocks(const void* rel, const void* cols, const void* vals,
                     const void* blk_ptr, const void* c, const void* b,
                     void* out, int64_t nblk, int64_t TMo, int64_t Q,
                     int64_t n, int64_t mode, void* stream)
{
    if (!c) return (int)cudaErrorInvalidValue;
    return launch_blocks<true>(rel, cols, vals, blk_ptr, c, b, out, nblk, TMo,
                               Q, n, mode, stream);
}

// the same with no C: out (M, n) holds the packed nonzeros' product alone
int crp_gather_blocks(const void* rel, const void* cols, const void* vals,
                      const void* blk_ptr, const void* b, void* out,
                      int64_t nblk, int64_t TMo, int64_t Q, int64_t n,
                      int64_t mode, void* stream)
{
    return launch_blocks<false>(rel, cols, vals, blk_ptr, nullptr, b, out,
                                nblk, TMo, Q, n, mode, stream);
}

const char* crp_error_string(int code)
{
    return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
