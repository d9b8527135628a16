// What the tile bodies share: the pack's layout, the chunk lookup and the
// flags of #12, the TF32 split and the cp.async helpers.  The bodies are
// the wgmma body fed by TMA (x3_wgmma.cuh: every entry on bf16 panels or
// fp32 TF32 planes, in window_sg.cu, window.cu, halo.cu and ragged.cu) and
// the DMMA body on the FP64 tensor cores (dd_tc.cu: every fp64 entry).
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
// spins on that word (halo_wait) and hands the acquire on to the threads
// that copy B (a warp barrier in the wgmma body, a named barrier in the
// DMMA body).  A window's chunks ascend, so do their owners: a block waits
// at most once an owner its window spans.  A wait that gives up leaves
// every later chunk of the block dead (zeros) and every barrier reached;
// the caller's done kernel turns C into NaN.  FLAGS implies CHUNKED; the
// other kernels compile without it.
//
// The TPU kernels walk a sequential grid and carry C across steps in VMEM.
// Here blocks run unordered: each block owns one (BM x BN) output tile of
// one group and walks that group's chunks itself, k-slice by k-slice as one
// linear loop, so the prefetch of the next slices runs across chunk
// boundaries and no state crosses blocks.  Blocks are numbered N-tile
// fastest, so the N tiles of one (group, M tile) run on neighbouring blocks
// and the later reads of an A slice come from L2.

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

// ------------------------------------------------------------ cp.async

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

// ------------------------------------------------------------ the TF32 split
//
// fp32 operands at HIGHEST on the TF32 tensor cores (the wgmma body's TF32
// mode, x3_wgmma.cuh, and the packs' TF32 planes, device_pack.py): each
// operand x is split into big = tf32(x), rounded to nearest with ties away
// from zero (the bits of cvt.rna; split_tf32 below), and small = tf32(x -
// big), the same rounding of the exact remainder against the big the
// products read.  Each 8-deep k step then runs three TF32 products, small
// terms first as x3 orders its bf16 ones: a_small b_big + a_big b_small +
// a_big b_big.  What is dropped (a_small b_small, and the two smalls' own
// rounding) is at most 3 * 2^-22 |a b| per product, against fp32's 2^-24
// per rounding: the plain version's function (fp32 products, IEEE sums)
// to within TOL_PLAIN.

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

}  // namespace crp
