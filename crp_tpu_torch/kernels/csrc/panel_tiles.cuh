// Tile kernels shared by the windowed (window_sg.cu, window.cu), the fused
// halo (halo.cu) and the ragged (ragged.cu) SpMM entries, and the chunk
// lookup and flags of #12 that the DMMA body (dd_tc.cu) shares.
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
// With CHUNKED (the fused halo kernels, halo.cu) B lives in its owners'
// shards, wherever they are, and chunk_src is a table of pointers, one per
// HALO_TK-row chunk of B: the chunk's first row in its owner's shard, or
// null past the matrix.  B row r is row r % HALO_TK of the rows chunk
// r / HALO_TK points at, or zero.  There every start is a multiple of
// HALO_TK, so a k slice (BK rows, BK dividing HALO_TK) never crosses a chunk
// and looks its chunk up once.  The other kernels compile without the
// lookup.
//
// With FLAGS (#12 across processes, halo.cu) the owners are other ranks'
// buffers, written while this kernel may already run, and chunk_src holds
// (row pointer, arrive word) pairs: each chunk's rows and its owner's
// arrival word (HaloFlags below), fetched by one 16-byte load.  Before a
// block first reads a chunk of an owner it has not waited for, one thread
// spins on that word, and a block barrier gives the other threads the
// acquire.  A window's chunks ascend, so do their owners: a block waits at
// most once an owner its window spans.  A wait that gives up leaves every
// later chunk of the block dead (zeros) and every barrier reached; the
// caller's done kernel turns C into NaN.  FLAGS implies CHUNKED; the other
// kernels compile without it.
//
// The TPU kernels walk a sequential grid and carry C across steps in VMEM.
// Here blocks run unordered: each block owns one (BM x BN) output tile of
// one group and walks that group's chunks itself, k-slice by k-slice as one
// linear loop, so the prefetch of the next slices runs across chunk
// boundaries and no state crosses blocks.  Blocks are numbered N-tile
// fastest, so the N tiles of one (group, M tile) run on neighbouring blocks
// and the later reads of an A slice come from L2.
//
// One tile body: panel_tf32x3_kernel (fp32 at HIGHEST on the TF32 tensor
// cores, fed by a cp.async shared-memory ring, see its section: #6 and
// #12).  The kernels on bf16 panels, x3 (#1, #5, #4, #12 and the ragged
// #7) and the one-pass default (#2, #4, #12 and the ragged #8), and #3 and
// #4 at HIGHEST (TF32X3), run on wgmma fed by TMA instead (x3_wgmma.cuh);
// every fp64 entry (#3, #4, #6, #12) runs on the FP64 tensor cores, #11's
// DMMA body with its windowed and its ragged walk (dd_tc.cu), which takes
// the chunk lookup and the flags of #12 from here.

#pragma once

#include <cstdint>
#include <cstdio>
#include <cstring>

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace crp {

using bf16 = __nv_bfloat16;

constexpr int HALO_TK = 128;  // rows of one B ownership chunk (chunk_src)

// The flags of #12 across processes (halo.cu, spmm_halo.py HaloPeers).
// Each rank owns three 64-bit words: arrive (its loads of B so far, written
// once its B is in place) and done (its launches so far, written once a
// launch has read its owners' rows) live in device memory mapped into every
// peer; status (0, or why a wait gave up) lives in this rank's pinned host
// memory, which the host reads without a sync.  A rank that gave up sets
// HALO_FAILED in the words it writes from then on, so that its peers give
// up at once rather than at their bound.
constexpr unsigned long long HALO_FAILED = 1ull << 62;
enum HaloCode { HALO_ARRIVAL = 1, HALO_READERS = 2, HALO_PEER_FAILED = 3, HALO_GAVE_UP = 4 };

struct HaloFlags {
    unsigned long long epoch;                 // the loads every owner must have made
    unsigned long long bound_ns;              // the longest a wait spins
    unsigned long long* status;               // this rank's status word
};

__device__ __forceinline__ unsigned long long ld_acquire_sys(const unsigned long long* p)
{
    unsigned long long v;
    asm volatile("ld.acquire.sys.u64 %0, [%1];\n" : "=l"(v) : "l"(p) : "memory");
    return v;
}

__device__ __forceinline__ unsigned long long ld_relaxed_sys(const unsigned long long* p)
{
    unsigned long long v;
    asm volatile("ld.relaxed.sys.u64 %0, [%1];\n" : "=l"(v) : "l"(p) : "memory");
    return v;
}

__device__ __forceinline__ void st_relaxed_sys(unsigned long long* p, unsigned long long v)
{
    asm volatile("st.relaxed.sys.u64 [%0], %1;\n" :: "l"(p), "l"(v) : "memory");
}

__device__ __forceinline__ unsigned long long global_ns()
{
    unsigned long long t;
    asm volatile("mov.u64 %0, %%globaltimer;\n" : "=l"(t));
    return t;
}

// One thread: spin until *word reaches need (an acquire at system scope),
// for at most bound_ns of wall time (%globaltimer: a descheduled peer
// context does not stop it), backing off with __nanosleep.  Returns 0, or
// the code it wrote to the status word (kind | where << 8): the bound ran
// out, the peer set HALO_FAILED, or another wait of this rank gave up
// first (the status word was set: give up at once too).
__device__ __forceinline__ int halo_wait(const unsigned long long* word, unsigned long long need,
                                         unsigned long long bound_ns,
                                         unsigned long long* status, int kind, int64_t where)
{
    unsigned long long v = ld_acquire_sys(word);
    int code = 0;
    if (v & HALO_FAILED) {
        code = HALO_PEER_FAILED;
    } else if (v < need) {
        const unsigned long long t0 = global_ns();
        unsigned ns = 64;
        for (;;) {
            if (ld_relaxed_sys(status) != 0) {
                code = HALO_GAVE_UP;
                break;
            }
            if (global_ns() - t0 > bound_ns) {
                code = kind;
                break;
            }
            __nanosleep(ns);
            if (ns < 8192) ns *= 2;
            v = ld_acquire_sys(word);
            if (v & HALO_FAILED) {
                code = HALO_PEER_FAILED;
                break;
            }
            if (v >= need) break;
        }
    }
    if (code && code != HALO_GAVE_UP && ld_relaxed_sys(status) == 0)
        st_relaxed_sys(status, (unsigned long long)code | ((unsigned long long)where << 8));
    return code;
}

// A block's gate before it reads B row r (FLAGS, see above): every thread
// calls it with the same r and the arrive word of r's chunk (null past the
// matrix); where that owner is one the block has not waited for, thread 0
// waits and the barrier hands on its acquire.  After a wait gave up,
// *failed stays set and no further wait runs.
template <bool FLAGS>
__device__ __forceinline__ void halo_gate_block(const HaloFlags& flags, int64_t r,
                                                const unsigned long long* word,
                                                const unsigned long long** gate, bool* failed)
{
    if constexpr (FLAGS) {
        const int64_t chunk = r / HALO_TK;
        if (word && word != *gate && !*failed) {
            *gate = word;
            *failed = __syncthreads_or(
                threadIdx.x == 0
                && halo_wait(word, flags.epoch, flags.bound_ns, flags.status, HALO_ARRIVAL,
                             chunk) != 0);
        }
    }
}

// chunk range of group g (see above)
__device__ __forceinline__ void group_chunks(const int32_t* group_ptr,
                                             int64_t g, int64_t* s_begin,
                                             int64_t* s_end)
{
    *s_begin = group_ptr ? group_ptr[g] : g;
    *s_end = group_ptr ? group_ptr[g + 1] : g + 1;
}

// first row of the k slice whose B rows start at row r, in the rows *b
// points at on return, and whether the rows exist (see CHUNKED above: *b
// leaves pointing at the chunk's rows; with FLAGS *word the arrive word of
// the chunk's owner)
template <bool CHUNKED, bool FLAGS = false, typename T>
__device__ __forceinline__ int64_t b_slice_row(const int32_t* chunk_src,
                                               int64_t r, bool* live, const T** b,
                                               const unsigned long long** word = nullptr)
{
    if constexpr (!CHUNKED) {
        *live = true;
        return r;
    } else if constexpr (FLAGS) {
        const ulonglong2 pair = reinterpret_cast<const ulonglong2*>(chunk_src)[r / HALO_TK];
        const T* rows = reinterpret_cast<const T*>(pair.x);
        *word = reinterpret_cast<const unsigned long long*>(pair.y);
        *live = rows != nullptr;
        if (rows) *b = rows;
        return r % HALO_TK;
    } else {
        const T* rows = reinterpret_cast<const T* const*>(chunk_src)[r / HALO_TK];
        *live = rows != nullptr;
        if (rows) *b = rows;
        return r % HALO_TK;
    }
}

// ------------------------------------------------------------ 3xTF32 path
//
// fp32 panels times fp32 B at HIGHEST on the TF32 tensor cores.  As each
// operand x is read from shared memory into an MMA fragment it is split
// into big = tf32(x), rounded to nearest with ties away from zero (the
// bits of cvt.rna; split_tf32 below), and small = tf32(x - big), the same
// rounding of the exact remainder against the big the MMA reads.  Every
// 8-deep k step then runs three mma.sync.m16n8k8 TF32 products, small
// terms first as x3 orders its bf16 ones: a_small b_big + a_big b_small +
// a_big b_big.  What is dropped (a_small b_small, and the two smalls' own
// rounding) is at most 3 * 2^-22 |a b| per product, against fp32's 2^-24
// per rounding: the plain version's function (fp32 products, IEEE sums)
// to within TOL_PLAIN.  As in the wgmma body (x3_wgmma.cuh), each 32-row k
// slice sums into a fresh accumulator that is added to the running sum with IEEE fp32 adds
// (the tensor cores' own accumulation does not round to nearest).
//
// The block owns a 128 x 64 output tile with 4 warps (2 along M x 2 along
// N, 64 x 32 each: 16 m16n8 tiles, 3 x 16 MMAs per k step).  A (128 x 32)
// and B (32 x 64) slices go into a ring of TF_STAGES shared-memory stages
// by cp.async (16-byte copies, or 4-byte ones for B when n % 4 != 0 or B
// is not 16-byte aligned: odd n is masked, never padded), so TF_STAGES - 1 slices are in flight while
// one is multiplied, with one barrier per slice.  B rows of a dead chunk
// (chunk_src -1) and columns at or past n are zero-filled by the copy
// itself (source size 0).  The padded pitches make every fragment read
// conflict-free.  110.6 KB of dynamic shared memory and at most 255
// registers a thread leave room for two blocks (8 warps) on an SM.

constexpr int TF_BM = 128;
constexpr int TF_BN = 64;
constexpr int TF_BK = 32;
constexpr int TF_THREADS = 128;
constexpr int TF_STAGES = 4;
constexpr int TF_A_LD = TF_BK + 4;  // floats; 16-byte rows, conflict-free reads
constexpr int TF_B_LD = TF_BN + 8;
constexpr int TF_A_STAGE = TF_BM * TF_A_LD;
constexpr int TF_B_STAGE = TF_BK * TF_B_LD;
constexpr int TF_SMEM = TF_STAGES * (TF_A_STAGE + TF_B_STAGE) * (int)sizeof(float);

// dst <- BYTES of src, or BYTES of zeros when !ok (source size 0: src is
// not read)
template <int BYTES>
__device__ __forceinline__ void cp_async(uint32_t dst, const float* src, bool ok)
{
    const int size = ok ? BYTES : 0;
    if constexpr (BYTES == 16)
        asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
                     :: "r"(dst), "l"(src), "r"(size) : "memory");
    else
        asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n"
                     :: "r"(dst), "l"(src), "r"(size) : "memory");
}

__device__ __forceinline__ void cp_async_commit()
{
    asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait()
{
    asm volatile("cp.async.wait_group %0;\n" :: "n"(N) : "memory");
}

// The MMA operands of x: the TF32 products read only the top 19 bits of
// each, so adding half a TF32 ulp (0x1000) to the bits and leaving the
// truncation to the tensor cores rounds to nearest with ties away from zero,
// the bits of cvt.rna.tf32.f32 (which compiles to a finiteness test and a
// select besides: 13% slower at the p = 4 headline shard on an H100).  small is the same rounding
// of the exact remainder x - big, with big's low 13 bits cleared as the
// MMA reads it.  A NaN x may carry out of big's bits, but its remainder is
// the canonical NaN, which the clamp keeps a NaN: C is NaN where a NaN
// enters, and an inf makes a NaN remainder, as with cvt.rna.
__device__ __forceinline__ void split_tf32(float x, uint32_t& big, uint32_t& small)
{
    const uint32_t hi = __float_as_uint(x) + 0x1000u;
    const float rem = x - __uint_as_float(hi & 0xffffe000u);
    big = hi;
    small = (uint32_t)min((int)__float_as_uint(rem), 0x7fffefff) + 0x1000u;
}

// d += a b, one m16n8k8 TF32 product (fragments in the PTX ISA's layout)
__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1)
{
    asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
        "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// B_VEC: B's rows are 16-byte aligned (n % 4 == 0 and B is), 16-byte copies
template <bool CHUNKED, bool B_VEC, bool FLAGS = false>
__global__ void __launch_bounds__(TF_THREADS, 2)
panel_tf32x3_kernel(const int32_t* __restrict__ group_ptr,
                    const int32_t* __restrict__ starts,
                    const float* __restrict__ tiles,
                    const float* __restrict__ b,
                    float* __restrict__ c,
                    int64_t TM, int64_t W, int64_t n, int64_t n_tiles,
                    const int32_t* __restrict__ chunk_src,
                    const HaloFlags flags)
{
    static_assert(!FLAGS || CHUNKED, "the flags gate the chunk lookup");
    extern __shared__ __align__(16) float tf_smem[];
    float* const As = tf_smem;                          // [STAGES][BM][A_LD]
    float* const Bs = tf_smem + TF_STAGES * TF_A_STAGE;  // [STAGES][BK][B_LD]

    const int tid = threadIdx.x;
    const int64_t tile = blockIdx.x;
    const int64_t nt = tile % n_tiles;
    const int64_t row0 = (tile / n_tiles) * TF_BM;
    const int64_t g = row0 / TM;  // TM % TF_BM == 0
    const int64_t r_in = row0 - g * TM;
    const int64_t n0 = nt * TF_BN;
    int64_t s_begin, s_end;
    group_chunks(group_ptr, g, &s_begin, &s_end);
    const int64_t nk = W / TF_BK;
    const int64_t nt_k = (s_end - s_begin) * nk;

    // Copies: each thread owns one 16-byte A column (tid % 8) of rows
    // tid / 8 + 16 i, and one B column (16 bytes at tid % 16, or one float
    // at tid % 64) of rows spaced 8 (or 2) apart; one source pointer each,
    // walked down the rows, so no per-copy offsets stay live.
    constexpr int A_ROWS = TF_THREADS / 8;                      // rows per pass
    constexpr int B_COLS = B_VEC ? TF_BN / 4 : TF_BN;          // copies per row
    constexpr int B_ROWS = TF_THREADS / B_COLS;
    const int a_r = tid / 8, a_k = (tid % 8) * 4;
    const int b_r = tid / B_COLS, b_c = (tid % B_COLS) * (B_VEC ? 4 : 1);
    const bool col_ok = n0 + b_c < n;
    const unsigned long long* gate = nullptr;  // FLAGS: the owner last waited for
    bool failed = false;

    // slice t of the group's walk into ring stage `stage`
    auto load_tile = [&](int64_t t, int stage) {
        const int64_t s = s_begin + t / nk;
        const int64_t k0 = (t % nk) * TF_BK;
        bool live;
        const float* bb = b;
        const unsigned long long* word = nullptr;
        const int64_t b_row0 =
            b_slice_row<CHUNKED, FLAGS>(chunk_src, starts[s] + k0, &live, &bb, &word);
        const float* a_src = tiles + (size_t)(s * TM + r_in + a_r) * W + k0 + a_k;
        uint32_t a_dst = (uint32_t)__cvta_generic_to_shared(
            As + stage * TF_A_STAGE + a_r * TF_A_LD + a_k);
#pragma unroll
        for (int i = 0; i < TF_BM / A_ROWS; ++i) {
            cp_async<16>(a_dst, a_src, true);
            a_src += (size_t)A_ROWS * W;
            a_dst += A_ROWS * TF_A_LD * 4;
        }
        halo_gate_block<FLAGS>(flags, starts[s] + k0, word, &gate, &failed);  // A in flight
        if constexpr (FLAGS) live = live && !failed;
        const bool ok = live && col_ok;
        const float* b_src = ok ? bb + (size_t)(b_row0 + b_r) * n + n0 + b_c : b;
        const size_t b_step = ok ? (size_t)B_ROWS * n : 0;
        uint32_t b_dst = (uint32_t)__cvta_generic_to_shared(
            Bs + stage * TF_B_STAGE + b_r * TF_B_LD + b_c);
#pragma unroll
        for (int i = 0; i < TF_BK / B_ROWS; ++i) {
            cp_async<B_VEC ? 16 : 4>(b_dst, b_src, ok);
            b_src += b_step;
            b_dst += B_ROWS * TF_B_LD * 4;
        }
    };

    const int warp = tid >> 5, lane = tid & 31;
    const int wm = warp >> 1;              // 64-row slab of the tile
    const int wn = warp & 1;               // 32-column slab of the tile
    const int gq = lane >> 2, tq = lane & 3;  // the fragments' group and thread

    float acc[4][4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j)
#pragma unroll
            for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.0f;

    auto compute_tile = [&](int stage) {
        // A fragment rows gq, gq + 8 and columns tq, tq + 4 of each m16 tile;
        // B fragment rows tq, tq + 4 and column gq of each n8 tile
        const float* as = As + stage * TF_A_STAGE + (wm * 64 + gq) * TF_A_LD + tq;
        const float* bs = Bs + stage * TF_B_STAGE + tq * TF_B_LD + wn * 32 + gq;
        float part[4][4][4];
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
            for (int j = 0; j < 4; ++j)
#pragma unroll
                for (int e = 0; e < 4; ++e) part[i][j][e] = 0.0f;
#pragma unroll
        for (int kk = 0; kk < TF_BK; kk += 8) {
            uint32_t bb[4][2], bl[4][2];
#pragma unroll
            for (int j = 0; j < 4; ++j)
#pragma unroll
                for (int h = 0; h < 2; ++h)
                    split_tf32(bs[(kk + 4 * h) * TF_B_LD + j * 8], bb[j][h], bl[j][h]);
#pragma unroll
            for (int i = 0; i < 4; ++i) {
                uint32_t ab[4], al[4];
#pragma unroll
                for (int q = 0; q < 4; ++q)  // (gq, tq) (gq+8, tq) (gq, tq+4) (gq+8, tq+4)
                    split_tf32(as[(i * 16 + (q & 1) * 8) * TF_A_LD + kk + (q >> 1) * 4],
                               ab[q], al[q]);
#pragma unroll
                for (int j = 0; j < 4; ++j) {
                    mma_tf32(part[i][j], al, bb[j][0], bb[j][1]);
                    mma_tf32(part[i][j], ab, bl[j][0], bl[j][1]);
                    mma_tf32(part[i][j], ab, bb[j][0], bb[j][1]);
                }
            }
        }
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
            for (int j = 0; j < 4; ++j)
#pragma unroll
                for (int e = 0; e < 4; ++e) acc[i][j][e] += part[i][j][e];
    };

    // the ring: slices 0 .. STAGES-2 in flight before the loop; at step kt,
    // once slice kt has landed and every warp is past step kt - 1, slice
    // kt + STAGES - 1 goes into the stage step kt - 1 read
#pragma unroll
    for (int st = 0; st < TF_STAGES - 1; ++st) {
        if (st < nt_k) load_tile(st, st);
        cp_async_commit();
    }
    for (int64_t kt = 0; kt < nt_k; ++kt) {
        cp_async_wait<TF_STAGES - 2>();
        __syncthreads();
        const int64_t next = kt + TF_STAGES - 1;
        if (next < nt_k) load_tile(next, (int)(next % TF_STAGES));
        cp_async_commit();
        compute_tile((int)(kt % TF_STAGES));
    }
    cp_async_wait<0>();

    // C fragment rows gq, gq + 8 and columns 2 tq, 2 tq + 1 of each tile;
    // the ragged N edge is masked here (n is not padded)
#pragma unroll
    for (int i = 0; i < 4; ++i) {
#pragma unroll
        for (int j = 0; j < 4; ++j) {
            const int64_t r = row0 + wm * 64 + i * 16 + gq;
            const int64_t col = n0 + wn * 32 + j * 8 + 2 * tq;
#pragma unroll
            for (int e = 0; e < 4; ++e) {
                if (col + (e & 1) < n)
                    c[(size_t)(r + (e >> 1) * 8) * n + col + (e & 1)] = acc[i][j][e];
            }
        }
    }
}

// the ring's shared memory is dynamic: allow it, and the carveout that
// fits two blocks on an SM
template <bool CHUNKED, bool B_VEC, bool FLAGS = false>
cudaError_t tf32x3_prepare()
{
    cudaError_t e = cudaFuncSetAttribute(panel_tf32x3_kernel<CHUNKED, B_VEC, FLAGS>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         TF_SMEM);
    if (e != cudaSuccess) return e;
    return cudaFuncSetAttribute(panel_tf32x3_kernel<CHUNKED, B_VEC, FLAGS>,
                                cudaFuncAttributePreferredSharedMemoryCarveout,
                                (int)cudaSharedmemCarveoutMaxShared);
}

template <bool CHUNKED, bool B_VEC, bool FLAGS>
cudaError_t tf32x3_run(const void* group_ptr, const void* starts, const void* tiles,
                       const void* b, void* c, int64_t blocks, int64_t TM, int64_t W,
                       int64_t n, int64_t n_tiles, void* stream, const void* chunk_src,
                       const HaloFlags& flags)
{
    const cudaError_t e = tf32x3_prepare<CHUNKED, B_VEC, FLAGS>();
    if (e != cudaSuccess) return e;
    panel_tf32x3_kernel<CHUNKED, B_VEC, FLAGS>
        <<<(unsigned)blocks, TF_THREADS, TF_SMEM, (cudaStream_t)stream>>>(
            static_cast<const int32_t*>(group_ptr),
            static_cast<const int32_t*>(starts), static_cast<const float*>(tiles),
            static_cast<const float*>(b), static_cast<float*>(c), TM, W, n, n_tiles,
            static_cast<const int32_t*>(chunk_src), flags);
    return cudaGetLastError();
}

// CHUNKED: chunk_src is the chunks' row pointers (b only a valid address)
// and rows16 says whether every one is on 16 bytes; FLAGS: the waits of #12
// across processes (flags), chunk_src the (row pointer, arrive word) pairs
template <bool CHUNKED, bool FLAGS = false>
int launch_tf32x3(const void* group_ptr, const void* starts, const void* tiles,
                  const void* b, void* c, int64_t G, int64_t TM, int64_t W,
                  int64_t n, void* stream, const void* chunk_src = nullptr,
                  bool rows16 = false, HaloFlags flags = {})
{
    if (G < 0 || TM <= 0 || TM % TF_BM || W <= 0 || W % TF_BK || n < 0)
        return (int)cudaErrorInvalidValue;
    if ((uintptr_t)tiles % 16) return (int)cudaErrorMisalignedAddress;
    const int64_t n_tiles = (n + TF_BN - 1) / TF_BN;
    const int64_t blocks = G * (TM / TF_BM) * n_tiles;
    if (blocks > 0x7fffffff) return (int)cudaErrorInvalidConfiguration;
    if (blocks == 0) return (int)cudaGetLastError();
    if (n % 4 == 0 && (CHUNKED ? rows16 : (uintptr_t)b % 16 == 0))
        return (int)tf32x3_run<CHUNKED, true, FLAGS>(group_ptr, starts, tiles, b, c, blocks,
                                                     TM, W, n, n_tiles, stream, chunk_src,
                                                     flags);
    return (int)tf32x3_run<CHUNKED, false, FLAGS>(group_ptr, starts, tiles, b, c, blocks, TM,
                                                  W, n, n_tiles, stream, chunk_src, flags);
}

// " <copy>.registers=.. <copy>.local_bytes=.. <copy>.blocks_per_sm=.." of
// one kernel launched with `threads` threads and `smem` bytes of dynamic
// shared memory (its attributes already set): registers, local (spill)
// bytes and resident blocks per SM
template <typename Kernel>
cudaError_t kernel_resources(Kernel kernel, int threads, int smem, const char* copy,
                             char* out, int len)
{
    cudaFuncAttributes attr;
    cudaError_t e = cudaFuncGetAttributes(&attr, kernel);
    int blocks = 0;
    if (e == cudaSuccess)
        e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, kernel, threads, smem);
    if (e != cudaSuccess) return e;
    snprintf(out, len, " %s.registers=%d %s.local_bytes=%d %s.blocks_per_sm=%d", copy,
             attr.numRegs, copy, (int)attr.localSizeBytes, copy, blocks);
    return cudaSuccess;
}

template <bool CHUNKED, bool B_VEC, bool FLAGS = false>
cudaError_t tf32x3_resources(const char* copy, char* out, int len)
{
    const cudaError_t e = tf32x3_prepare<CHUNKED, B_VEC, FLAGS>();
    if (e != cudaSuccess) return e;
    return kernel_resources(panel_tf32x3_kernel<CHUNKED, B_VEC, FLAGS>, TF_THREADS, TF_SMEM,
                            copy, out, len);
}

// The ring and resources of the 3xTF32 kernels as "key=value" pairs
// separated by spaces (at most len bytes, NUL included): the ring's stages,
// dynamic shared memory bytes, threads and block tile, then per kernel,
// "b16" (16-byte B copies) and "b4" (4-byte B copies), its resources; with
// CHUNKED also "flag16" and "flag4", the same with the waits of #12 across
// processes
template <bool CHUNKED>
int tf32x3_layout(char* out, int len)
{
    int used = snprintf(out, len, "stages=%d smem_bytes=%d threads=%d BM=%d BN=%d BK=%d",
                        TF_STAGES, TF_SMEM, TF_THREADS, TF_BM, TF_BN, TF_BK);
    using Report = cudaError_t (*)(const char*, char*, int);
    struct Kernel { const char* copy; Report report; };
    const Kernel kernels[4] = {{"b16", tf32x3_resources<CHUNKED, true>},
                               {"b4", tf32x3_resources<CHUNKED, false>},
                               {"flag16", tf32x3_resources<CHUNKED, true, CHUNKED>},
                               {"flag4", tf32x3_resources<CHUNKED, false, CHUNKED>}};
    for (int i = 0; i < (CHUNKED ? 4 : 2); ++i) {
        const cudaError_t e = kernels[i].report(kernels[i].copy, out + used, len - used);
        if (e != cudaSuccess) return (int)e;
        used += (int)strlen(out + used);
    }
    return (int)cudaSuccess;
}

}  // namespace crp
