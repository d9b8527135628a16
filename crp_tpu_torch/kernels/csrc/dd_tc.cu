// Hopper kernels for the fp64 SpMM on the FP64 tensor cores: one DMMA
// body, ragged_dd_kernel, with two walks, and on the windowed walk B read
// through a chunk table (CHUNKED) and gated on flags in peer memory (FLAGS).
//
// The ragged walk: group g owns the chunks s in [group_ptr[g],
// group_ptr[g + 1]), chunk s is a dense (TM, Wc) fp64 panel over the B
// rows [starts[s], starts[s] + Wc), and the entry computes
//
//     C[g*TM + r, j] = sum_{s of g} sum_{k < Wc} A[s, r, k] * B[starts[s] + k, j]
//
// in fp64 into the (G*TM, n) output, every element of which is written (a
// group with no chunk, or with zero dummy chunks, comes out zero).  It
// reads the same step arrays as the ragged kernels (ragged.cu).  The
// windowed walk (WINDOW) is the uniform pack's: group g owns the one chunk
// s = g, group_ptr is not read and starts is ws, as in the tile kernels of
// panel_tiles.cuh with group_ptr == nullptr.
//
// CHUNKED (#12, the fused halo kernel, on the windowed walk): B lives in
// its owners' shards, and b is a table of pointers, one per HALO_TK-row
// chunk of B (panel_tiles.cuh: the chunk's first row in its owner's
// shard, null past the matrix).  Every window start is a multiple of
// HALO_TK and a 32-row k slice divides it, so a slice never crosses a
// chunk: the producers look its pointer up once (b_slice_row), before they
// wait for the stage to free.  A dead chunk's rows are zero-filled by the
// copy (source size 0), as the columns past n are.  FLAGS (#12 across
// processes; CHUNKED, the table's entries (row pointer, arrive word)
// pairs): before the producers' first B copy from an owner they have not
// waited for, once the stage's A copies are issued, producer thread 0
// spins on the owner's arrive word (panel_tiles.cuh halo_wait) and a named
// barrier over the 128 producers (barrier 1, which the consumers never
// reach) hands on its acquire and whether it gave up.  The memo is the
// owner last waited for: a block that moves on to a tile whose window
// starts at another owner may wait again on one it has seen (only an
// acquire), and never skips a wait.  After a give-up every later chunk of
// the block is dead, but the producers still make every stage's copies and
// arrivals, so no consumer waits on a stage that does not come; the
// caller's done kernel (halo.cu) turns C into NaN.  The other kernels
// compile without either: both flags default off.
//
// Replaces (crp_tpu/kernels/):
//   crp_ragged_dd_f64tc <- _ragged_kernel_dd (spmm_dd_mxu.py), which
//                          reaches fp64-class accuracy on a TPU, whose
//                          matrix unit has no fp64, by cutting A into 7
//                          bf16 integer slices (Ozaki), B into 7 more in
//                          the kernel, and summing 34 exact bf16 passes in
//                          double-float.  Hopper's tensor cores multiply
//                          fp64 directly (DMMA), so the port keeps the
//                          contract (the same total cover, C to <= 1e-12)
//                          and drops the mechanism: one fp64 pass, fp64
//                          panels, fp64 B and C.  wgmma has no fp64 form;
//                          mma.sync is the route.
//   crp_ragged_f64      <- _ragged_kernel (spmm_ragged.py) on fp64: the
//                          ragged walk on the ragged pack's fp64 panels,
//                          the same instantiation as crp_ragged_dd_f64tc
//   crp_window_sg_f64   <- _window_kernel_sg (spmm_pallas.py) on fp64: the
//                          windowed walk on the uniform pack's panels
//   crp_window_f64      <- _window_kernel (spmm_pallas.py) on fp64, every
//                          multi-shard pack: the same arrays, so the same
//                          instantiation as crp_window_sg_f64
//   crp_halo_f64        <- _halo_kernel (spmm_halo.py) on fp64, one card:
//                          the windowed walk with B through the chunk table
//   crp_halo_f64_flags  <- the same across processes, its arrival
//                          semaphores the owners' arrive words (FLAGS)
//
// Layout: a tile is a 128-row slice of a group (all of it at TM = 128)
// and a 128-column n-tile, so each B chunk is read once per n-tile, by
// one block.  One block an SM (the grid is as many as the card holds at
// once) walks the tiles blockIdx.x, blockIdx.x + gridDim.x, ...: the
// tiles in flight are neighbours, n-tile fastest, and share the panels and
// B rows in L2; a tile's epilogue overlaps the next tile's first copies.
// The block is three warpgroups.  Two consume: 8 warps, 2 along M x 4
// along N, each owning a 64 x 32 slab, 4 x 4 tiles of 16 x 8 and 64 fp64
// accumulators (128 registers) a thread.  One produces: its 128 threads
// copy every slice.  setmaxnreg gives a consumer thread 224 registers and
// a producer 48, 56 with the flags' waits (an SM sub-partition holds one
// warp of each warpgroup: 48 + 2 x 224 of its 512 registers a lane).
// Without it a launch of 3 warps a sub-partition holds every thread to 168
// registers, and the consumers spill (a producer warp in place of the
// warpgroup did).
//
// Shape: Hopper's mma.sync.m16n8k8.f64 (sm_90).  DD_MMA_M and DD_MMA_K
// select m16n8k4, m16n8k16 or Ampere's m8n8k4 (two to a 16 x 8 tile) in
// its place: crp_tpu_torch.cli.dd_split times each, and on the H100
// m16n8k8 was the fastest (the three m16n8 shapes within 2%), m8n8k4 held
// to about half their rate.  Their
// fragments (the PTX ISA's, as CUTLASS's SM90_16x8x{4,8,16}_F64F64F64F64_TN
// traits give them) are, with gq = lane / 4 and tq = lane % 4: A (16 x K)
// a[q] at row gq + 8 (q % 2), column tq + 4 (q / 2); B (K x 8) b[q] at row
// tq + 4 q, column gq; C (16 x 8) c[e] at row gq + 8 (e / 2), column
// 2 tq + e % 2.
//
// Feed: each tile's chunks are walked as one run of 32-deep k slices
// (chunk after chunk in group_ptr order, k upward) through a ring of
// DD_STAGES shared-memory stages (A 128 x 32 and B 32 x 128 doubles, 69 KB
// a stage), one full and one empty mbarrier a stage.  The producers fill
// a stage once every consumer warp has released it (empty) by cp.async:
// the A slice of the panel by 16-byte copies, the B slice (32 rows from
// row starts[s] + k0, 128 columns) by 16-byte copies where n is even and
// B starts on 16 bytes, else by 8-byte ones; columns at or past n are
// zero-filled by the copy itself (source size 0), so odd n is masked, not
// padded.  Each producer's cp.async.mbarrier.arrive completes the stage's
// full barrier when its copies land; a consumer warp waits on it,
// multiplies, and releases the stage.  No block-wide barrier in the loop:
// a warp waits only for its data.  The pitches (A 36, B 132 doubles) put
// every half-warp's fragment reads on 16 distinct 8-byte banks.
//
// Order: each C element is one accumulator chain, the products of its
// group's chunks in group_ptr order and k upward, one DMMA after another;
// nothing is split across blocks or warps and there is no atomic, so a
// launch equals the next one bit for bit (and every shape, ring depth and
// k slice gives the same bits).
//
// What bounds it: the products.  At the banded fp64 point (S = 3,402
// chunks of 128 x 512, n = 256) the panels' 114 GFLOP take 1.70 ms at the
// FP64 tensor cores' 67 TFLOP/s; the body without its copies takes as
// long as the whole body (dd_split), its copies alone (7.1 GB from L2:
// the panels twice, the B chunks once; 1.78 GB of panels from device
// memory) about 0.7 of it.  On fp64 `auto`'s packs of #3 (banded, W =
// 768) and #6 (cplaw and the headline, Wc = 128) it runs at 1.10-1.12x the
// products' bound; products alone take 0.94-0.96 of the whole, copies
// alone 0.78-0.93 (crp_tpu_torch.cli.f64_ab --split, H100 SXM at 700 W):
// on 128-deep chunks both streams bound it.

#include <algorithm>
#include <cstdint>
#include <cstdio>
#include <cstring>

#include <cuda_runtime.h>

#include "panel_tiles.cuh"  // HALO_TK, the chunk lookup and the flags of #12

namespace {

constexpr int DD_BM = 128;   // block rows: a group at TM = 128
constexpr int DD_BN = 128;   // block columns
constexpr int DD_BK = 32;    // k slice a stage
constexpr int DD_STAGES = 3;
constexpr int DD_WARPS_N = 4;  // consumer warps along N (2 along M)
constexpr int DD_CONSUMERS = 256;  // two warpgroups
constexpr int DD_PRODUCERS = 128;  // and one that copies
constexpr int DD_THREADS = DD_CONSUMERS + DD_PRODUCERS;
// registers a thread after setmaxnreg: an SM sub-partition holds one warp
// of each warpgroup, 48 + 2 * 224 of its 512 registers a lane
constexpr int DD_PRODUCER_REGS = 48;
constexpr int DD_CONSUMER_REGS = 224;
// FLAGS: the producers' waits spill at 48 (24 bytes with 16-byte B
// copies; H100, nvcc 12.9); 56 + 2 x 224 = 504 of 512 fits, and the
// launch's 384 x 168 registers hold 128 x 56 + 256 x 224 exactly
constexpr int DD_FLAG_PRODUCER_REGS = 56;
constexpr int DD_MMA_M = 16;   // the DMMA shape: m16n8k{4,8,16}, or m8n8k4
constexpr int DD_MMA_K = 8;
constexpr int DD_WM = DD_BM / (DD_CONSUMERS / 32 / DD_WARPS_N);  // 64 rows a warp
constexpr int DD_WN = DD_BN / DD_WARPS_N;                        // 32 columns a warp
constexpr int DD_A_LD = DD_BK + 4;  // smem pitches (doubles): conflict-free fragments
constexpr int DD_B_LD = DD_BN + 4;
constexpr int DD_A_STAGE = DD_BM * DD_A_LD;
constexpr int DD_B_STAGE = DD_BK * DD_B_LD;
constexpr int DD_RING = DD_STAGES * (DD_A_STAGE + DD_B_STAGE) * (int)sizeof(double);
constexpr int DD_SMEM = DD_RING + 2 * DD_STAGES * 8;  // and a full and an empty mbarrier a stage
constexpr int DD_MT = DD_WM / 16;  // 16 x 8 tiles of a warp: 4 x 4
constexpr int DD_NT = DD_WN / 8;

static_assert(DD_MMA_M == 16 || (DD_MMA_M == 8 && DD_MMA_K == 4), "DMMA shape");
static_assert(DD_MMA_K == 4 || DD_MMA_K == 8 || DD_MMA_K == 16, "DMMA shape");
static_assert(DD_BK % DD_MMA_K == 0 && DD_A_LD % 16 == 4 && DD_B_LD % 16 == 4,
              "k slice and pitches");

// dst <- BYTES of src, or BYTES of zeros when !ok (source size 0: src is
// not read)
template <int BYTES>
__device__ __forceinline__ void cp_async(uint32_t dst, const double* src, bool ok)
{
    const int size = ok ? BYTES : 0;
    if constexpr (BYTES == 16)
        asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
                     :: "r"(dst), "l"(src), "r"(size) : "memory");
    else
        asm volatile("cp.async.ca.shared.global [%0], [%1], 8, %2;\n"
                     :: "r"(dst), "l"(src), "r"(size) : "memory");
}

__device__ __forceinline__ void cp_async_wait_all()
{
    asm volatile("cp.async.wait_all;\n" ::: "memory");
}

__device__ __forceinline__ void mbar_init(uint32_t bar, int count)
{
    asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" :: "r"(bar), "r"(count)
                 : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar)
{
    asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" :: "r"(bar) : "memory");
}

// an arrival on bar once every earlier cp.async of this thread has landed
__device__ __forceinline__ void mbar_arrive_cp_async(uint32_t bar)
{
    asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];\n" :: "r"(bar)
                 : "memory");
}

// wait until the phase of parity `parity` has completed
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity)
{
    uint32_t done;
    do {
        asm volatile("{\n.reg .pred p;\n"
                     "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
                     "selp.u32 %0, 1, 0, p;\n}\n"
                     : "=r"(done) : "r"(bar), "r"(parity) : "memory");
    } while (!done);
}

// whether pred holds on any of the producer warpgroup's threads: a named
// barrier (1) over its DD_PRODUCERS threads, which the consumers never
// reach; it also orders their memory accesses as a block barrier would
__device__ __forceinline__ bool producers_any(bool pred)
{
    uint32_t any;
    asm volatile("{\n.reg .pred p;\n"
                 "setp.ne.u32 p, %1, 0;\n"
                 "bar.red.or.pred p, 1, %2, p;\n"
                 "selp.u32 %0, 1, 0, p;\n}\n"
                 : "=r"(any) : "r"((uint32_t)pred), "n"(DD_PRODUCERS) : "memory");
    return any != 0;
}

// d += a b on one 16 x 8 tile, fp64 on the tensor cores: one Hopper
// m16n8k{4,8,16}, or two Ampere m8n8k4 (rows gq and gq + 8: the m16n8k4
// fragments are theirs side by side)
__device__ __forceinline__ void dmma(double (&d)[4], const double (&a)[DD_MMA_K / 2],
                                     const double (&b)[DD_MMA_K / 4])
{
    if constexpr (DD_MMA_M == 8) {
        asm("mma.sync.aligned.m8n8k4.row.col.f64.f64.f64.f64 "
            "{%0, %1}, {%2}, {%3}, {%0, %1};\n"
            : "+d"(d[0]), "+d"(d[1]) : "d"(a[0]), "d"(b[0]));
        asm("mma.sync.aligned.m8n8k4.row.col.f64.f64.f64.f64 "
            "{%0, %1}, {%2}, {%3}, {%0, %1};\n"
            : "+d"(d[2]), "+d"(d[3]) : "d"(a[1]), "d"(b[0]));
    } else if constexpr (DD_MMA_K == 4) {
        asm("mma.sync.aligned.m16n8k4.row.col.f64.f64.f64.f64 "
            "{%0, %1, %2, %3}, {%4, %5}, {%6}, {%0, %1, %2, %3};\n"
            : "+d"(d[0]), "+d"(d[1]), "+d"(d[2]), "+d"(d[3])
            : "d"(a[0]), "d"(a[1]), "d"(b[0]));
    } else if constexpr (DD_MMA_K == 8) {
        asm("mma.sync.aligned.m16n8k8.row.col.f64.f64.f64.f64 "
            "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
            "{%0, %1, %2, %3};\n"
            : "+d"(d[0]), "+d"(d[1]), "+d"(d[2]), "+d"(d[3])
            : "d"(a[0]), "d"(a[1]), "d"(a[2]), "d"(a[3]), "d"(b[0]),
              "d"(b[1]));
    } else {
        asm("mma.sync.aligned.m16n8k16.row.col.f64.f64.f64.f64 "
            "{%0, %1, %2, %3}, {%4, %5, %6, %7, %8, %9, %10, %11}, "
            "{%12, %13, %14, %15}, {%0, %1, %2, %3};\n"
            : "+d"(d[0]), "+d"(d[1]), "+d"(d[2]), "+d"(d[3])
            : "d"(a[0]), "d"(a[1]), "d"(a[2]), "d"(a[3]), "d"(a[4]),
              "d"(a[5]), "d"(a[6]), "d"(a[7]), "d"(b[0]), "d"(b[1]),
              "d"(b[2]), "d"(b[3]));
    }
}

// the chunks [chunk_begin, chunk_end) of group g: group_ptr's range, or
// with WINDOW the one chunk s = g (group_ptr is not read)
template <bool WINDOW>
__device__ __forceinline__ int chunk_begin(const int32_t* group_ptr, int64_t g)
{
    if constexpr (WINDOW) return (int)g;
    else return group_ptr[g];
}

template <bool WINDOW>
__device__ __forceinline__ int chunk_end(const int32_t* group_ptr, int64_t g)
{
    if constexpr (WINDOW) return (int)g + 1;
    else return group_ptr[g + 1];
}

// tile `tile` of the grid: its first C row, its group and first row in it,
// its first column
struct Tile {
    int64_t row0, g, r_in, n0;
};

__device__ __forceinline__ Tile tile_at(int64_t tile, int64_t TM, int64_t n_tiles)
{
    Tile t;
    t.row0 = (tile / n_tiles) * DD_BM;
    t.g = t.row0 / TM;  // TM % DD_BM == 0
    t.r_in = t.row0 - t.g * TM;
    t.n0 = (tile % n_tiles) * DD_BN;
    return t;
}

// B_VEC: n is even and B starts on 16 bytes (under CHUNKED: every chunk's
// rows do), so every B row piece of two doubles is 16-byte aligned: 16-byte
// copies; else 8-byte ones.  WINDOW: the windowed walk (one chunk a group,
// s = g).  CHUNKED: b is the chunk table; FLAGS: of (row pointer, arrive
// word) pairs, the waits bounded by flags (see above)
template <bool B_VEC, bool WINDOW, bool CHUNKED = false, bool FLAGS = false>
__global__ void __launch_bounds__(DD_THREADS, 1)
ragged_dd_kernel(const int32_t* __restrict__ group_ptr,
                 const int32_t* __restrict__ starts,
                 const double* __restrict__ panels,
                 const double* __restrict__ b,
                 double* __restrict__ c,
                 int64_t TM, int64_t W, int64_t n, int64_t n_tiles, int64_t tiles,
                 bool c_vec, const crp::HaloFlags flags)
{
    static_assert(!CHUNKED || WINDOW, "the chunk table serves the windowed walk (#12)");
    static_assert(!FLAGS || CHUNKED, "the flags gate the chunk lookup");
    extern __shared__ __align__(16) double dd_smem[];
    double* const As = dd_smem;                           // [STAGES][BM][A_LD]
    double* const Bs = dd_smem + DD_STAGES * DD_A_STAGE;  // [STAGES][BK][B_LD]
    const uint32_t full0 = (uint32_t)__cvta_generic_to_shared(dd_smem) + DD_RING;
    const uint32_t empty0 = full0 + 8 * DD_STAGES;

    const int tid = threadIdx.x;
    const int warp = tid >> 5, lane = tid & 31;
    const int nk = (int)(W / DD_BK);  // k slices a chunk

    if (tid == 0) {
        for (int s = 0; s < DD_STAGES; ++s) {
            mbar_init(full0 + 8 * s, DD_PRODUCERS);           // the producers' copies
            mbar_init(empty0 + 8 * s, DD_CONSUMERS / 32);     // one per consumer warp
        }
        asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    }
    __syncthreads();

    // slice t of the block's walk (over its tiles, each tile's chunks in
    // group_ptr order, each chunk's slices k upward) goes into stage
    // t % STAGES, whose use is phase (t / STAGES) & 1 of its barriers
    if (tid >= DD_CONSUMERS) {
        // the producers: thread p copies the 16-byte A pieces p % (BK / 2)
        // of the rows p / (BK / 2) + A_ROWS i, and the B piece p % B_COLS
        // (16 bytes, or 8 where !B_VEC) of the rows p / B_COLS + B_ROWS i
        asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n"
                     :: "n"(FLAGS ? DD_FLAG_PRODUCER_REGS : DD_PRODUCER_REGS));
        constexpr int A_ROWS = DD_PRODUCERS / (DD_BK / 2);    // rows a pass
        constexpr int B_COLS = B_VEC ? DD_BN / 2 : DD_BN;    // copies a row
        constexpr int B_ROWS = DD_PRODUCERS / B_COLS;
        constexpr int B_BYTES = B_VEC ? 16 : 8;
        const int p = tid - DD_CONSUMERS;
        const int a_r = p / (DD_BK / 2), a_k = (p % (DD_BK / 2)) * 2;
        const int b_r = p / B_COLS, b_c = (p % B_COLS) * (B_VEC ? 2 : 1);
        [[maybe_unused]] const unsigned long long* gate = nullptr;  // FLAGS: the owner
        [[maybe_unused]] bool failed = false;  // last waited for; a wait of the block gave up
        int t = 0;
        for (int64_t tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
            const Tile tl = tile_at(tile, TM, n_tiles);
            const bool col_ok = tl.n0 + b_c < n;
            const int s_end = chunk_end<WINDOW>(group_ptr, tl.g);
            for (int s = chunk_begin<WINDOW>(group_ptr, tl.g); s < s_end; ++s) {
                const int64_t start = __ldg(starts + s);
                for (int k0 = 0; k0 < W; k0 += DD_BK, ++t) {
                    const int st = t % DD_STAGES;
                    // CHUNKED: the slice's rows, row b_row on of `rows`, and
                    // with FLAGS its owner's arrive word (see above)
                    [[maybe_unused]] const double* rows = b;
                    [[maybe_unused]] int64_t b_row = 0;
                    [[maybe_unused]] bool live = true;
                    [[maybe_unused]] const unsigned long long* word = nullptr;
                    if constexpr (CHUNKED)
                        b_row = crp::b_slice_row<true, FLAGS>(
                            reinterpret_cast<const int32_t*>(b), start + k0, &live, &rows,
                            &word);
                    mbar_wait(empty0 + 8 * st, ((t / DD_STAGES) & 1) ^ 1);
                    const double* a_src =
                        panels + (size_t)((int64_t)s * TM + tl.r_in + a_r) * W + k0 + a_k;
                    uint32_t a_dst = (uint32_t)__cvta_generic_to_shared(
                        As + st * DD_A_STAGE + a_r * DD_A_LD + a_k);
#pragma unroll
                    for (int i = 0; i < DD_BM / A_ROWS; ++i) {
                        cp_async<16>(a_dst, a_src, true);
                        a_src += (size_t)A_ROWS * W;
                        a_dst += A_ROWS * DD_A_LD * 8;
                    }
                    if constexpr (CHUNKED) {
                        if constexpr (FLAGS) {  // the slice's owner arrived (see above)
                            if (word && word != gate && !failed) {
                                gate = word;
                                failed = producers_any(
                                    p == 0 && crp::halo_wait(word, flags.epoch, flags.bound_ns,
                                                             flags.status, crp::HALO_ARRIVAL,
                                                             (start + k0) / crp::HALO_TK) != 0);
                            }
                            live = live && !failed;
                        }
                        // a dead chunk, or the columns past n: zeros, read
                        // from nowhere (the panels are only a valid address)
                        const bool ok = live && col_ok;
                        const double* b_src =
                            ok ? rows + (size_t)(b_row + b_r) * n + tl.n0 + b_c : panels;
                        const size_t b_step = ok ? (size_t)B_ROWS * n : 0;
                        uint32_t b_dst = (uint32_t)__cvta_generic_to_shared(
                            Bs + st * DD_B_STAGE + b_r * DD_B_LD + b_c);
#pragma unroll
                        for (int i = 0; i < DD_BK / B_ROWS; ++i) {
                            cp_async<B_BYTES>(b_dst, b_src, ok);
                            b_src += b_step;
                            b_dst += B_ROWS * DD_B_LD * 8;
                        }
                    } else {  // apart from the chunked copy: #11's, #3's, #6's SASS kept
                        const double* b_src =
                            col_ok ? b + (size_t)(start + k0 + b_r) * n + tl.n0 + b_c : b;
                        const size_t b_step = col_ok ? (size_t)B_ROWS * n : 0;
                        uint32_t b_dst = (uint32_t)__cvta_generic_to_shared(
                            Bs + st * DD_B_STAGE + b_r * DD_B_LD + b_c);
#pragma unroll
                        for (int i = 0; i < DD_BK / B_ROWS; ++i) {
                            cp_async<B_BYTES>(b_dst, b_src, col_ok);
                            b_src += b_step;
                            b_dst += B_ROWS * DD_B_LD * 8;
                        }
                    }
                    mbar_arrive_cp_async(full0 + 8 * st);
                }
            }
        }
        cp_async_wait_all();
        return;
    }

    // the consumers: warp (wm, wn) owns a 64 x 32 slab of each tile
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" :: "n"(DD_CONSUMER_REGS));
    const int wm = warp / DD_WARPS_N;
    const int wn = warp % DD_WARPS_N;
    const int gq = lane >> 2, tq = lane & 3;
    double acc[DD_MT][DD_NT][4];

    auto compute_slice = [&](int stage) {
        const double* as = As + stage * DD_A_STAGE + (wm * DD_WM + gq) * DD_A_LD + tq;
        const double* bs = Bs + stage * DD_B_STAGE + tq * DD_B_LD + wn * DD_WN + gq;
#pragma unroll
        for (int kk = 0; kk < DD_BK; kk += DD_MMA_K) {
            double bf[DD_NT][DD_MMA_K / 4];
#pragma unroll
            for (int j = 0; j < DD_NT; ++j)
#pragma unroll
                for (int q = 0; q < DD_MMA_K / 4; ++q)
                    bf[j][q] = bs[(kk + 4 * q) * DD_B_LD + j * 8];
#pragma unroll
            for (int i = 0; i < DD_MT; ++i) {
                double af[DD_MMA_K / 2];
#pragma unroll
                for (int q = 0; q < DD_MMA_K / 2; ++q)
                    af[q] = as[(i * 16 + 8 * (q & 1)) * DD_A_LD + kk + 4 * (q >> 1)];
#pragma unroll
                for (int j = 0; j < DD_NT; ++j) dmma(acc[i][j], af, bf[j]);
            }
        }
    };

    int t = 0;
    for (int64_t tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
        const Tile tl = tile_at(tile, TM, n_tiles);
        const int nt_k =
            (chunk_end<WINDOW>(group_ptr, tl.g) - chunk_begin<WINDOW>(group_ptr, tl.g)) * nk;
#pragma unroll
        for (int i = 0; i < DD_MT; ++i)
#pragma unroll
            for (int j = 0; j < DD_NT; ++j)
#pragma unroll
                for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.0;
        for (int kt = 0; kt < nt_k; ++kt, ++t) {
            const int st = t % DD_STAGES;
            mbar_wait(full0 + 8 * st, (t / DD_STAGES) & 1);
            compute_slice(st);
            __syncwarp();
            if (lane == 0) mbar_arrive(empty0 + 8 * st);
        }

        // the n edge is masked here (n is not padded); two doubles at a
        // time where C's rows start on 16 bytes
#pragma unroll
        for (int i = 0; i < DD_MT; ++i) {
#pragma unroll
            for (int j = 0; j < DD_NT; ++j) {
                const int64_t col = tl.n0 + wn * DD_WN + j * 8 + 2 * tq;
#pragma unroll
                for (int h = 0; h < 2; ++h) {
                    double* out =
                        c + (size_t)(tl.row0 + wm * DD_WM + i * 16 + gq + 8 * h) * n + col;
                    if (c_vec && col + 1 < n) {
                        *reinterpret_cast<double2*>(out) =
                            make_double2(acc[i][j][2 * h], acc[i][j][2 * h + 1]);
                    } else {
                        if (col < n) out[0] = acc[i][j][2 * h];
                        if (col + 1 < n) out[1] = acc[i][j][2 * h + 1];
                    }
                }
            }
        }
    }
}

// the ring's shared memory is dynamic: allow it, and the carveout
template <bool B_VEC, bool WINDOW, bool CHUNKED = false, bool FLAGS = false>
cudaError_t dd_prepare()
{
    auto kernel = ragged_dd_kernel<B_VEC, WINDOW, CHUNKED, FLAGS>;
    cudaError_t e =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, DD_SMEM);
    if (e != cudaSuccess) return e;
    return cudaFuncSetAttribute(kernel, cudaFuncAttributePreferredSharedMemoryCarveout,
                                (int)cudaSharedmemCarveoutMaxShared);
}

template <bool B_VEC, bool WINDOW, bool CHUNKED, bool FLAGS>
cudaError_t dd_run(const void* group_ptr, const void* starts, const void* panels,
                   const void* b, void* c, int64_t tiles, int64_t TM, int64_t W,
                   int64_t n, int64_t n_tiles, bool c_vec, const crp::HaloFlags& flags,
                   void* stream)
{
    cudaError_t e = dd_prepare<B_VEC, WINDOW, CHUNKED, FLAGS>();
    if (e != cudaSuccess) return e;
    // as many blocks as the card holds at once, each walking tiles
    int dev = 0, sms = 0, per_sm = 0;
    e = cudaGetDevice(&dev);
    if (e == cudaSuccess) e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    auto kernel = ragged_dd_kernel<B_VEC, WINDOW, CHUNKED, FLAGS>;
    if (e == cudaSuccess)
        e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, DD_THREADS, DD_SMEM);
    if (e != cudaSuccess) return e;
    const int64_t grid = std::min(tiles, (int64_t)sms * std::max(per_sm, 1));
    kernel<<<(unsigned)grid, DD_THREADS, DD_SMEM, (cudaStream_t)stream>>>(
        static_cast<const int32_t*>(group_ptr), static_cast<const int32_t*>(starts),
        static_cast<const double*>(panels), static_cast<const double*>(b),
        static_cast<double*>(c), TM, W, n, n_tiles, tiles, c_vec, flags);
    return cudaGetLastError();
}

// " <name>.registers=.. <name>.local_bytes=.. <name>.blocks_per_sm=.." of
// one instantiation
template <bool B_VEC, bool WINDOW, bool CHUNKED = false, bool FLAGS = false>
cudaError_t dd_resources(const char* name, char* out, int len)
{
    const cudaError_t e = dd_prepare<B_VEC, WINDOW, CHUNKED, FLAGS>();
    if (e != cudaSuccess) return e;
    return crp::kernel_resources(ragged_dd_kernel<B_VEC, WINDOW, CHUNKED, FLAGS>, DD_THREADS,
                                 DD_SMEM, name, out, len);
}

// An entry: check what the body takes (TM % 128, Wc % 32, panels on 16
// bytes, group_ptr unless WINDOW, and under FLAGS the pairs' table on 16
// bytes), then launch it with 16-byte B copies where n is even and B starts
// on 16 bytes (under CHUNKED, where every chunk's rows do: rows16; b is
// then the table), else 8-byte ones.  Returns the CUDA error of a refusal
// or of the launch.
template <bool WINDOW, bool CHUNKED = false, bool FLAGS = false>
int dd_entry(const void* group_ptr, const void* starts, const void* panels, const void* b,
             void* c, int64_t G, int64_t TM, int64_t Wc, int64_t n, void* stream,
             bool rows16 = false, crp::HaloFlags flags = {})
{
    if ((!WINDOW && !group_ptr) || G < 0 || TM <= 0 || TM % DD_BM || Wc <= 0 ||
        Wc % DD_BK || n < 0)
        return (int)cudaErrorInvalidValue;
    if ((uintptr_t)panels % 16 || (FLAGS && (uintptr_t)b % 16))
        return (int)cudaErrorMisalignedAddress;
    const int64_t n_tiles = (n + DD_BN - 1) / DD_BN;
    const int64_t tiles = G * (TM / DD_BM) * n_tiles;
    if (tiles > 0x7fffffff) return (int)cudaErrorInvalidConfiguration;
    if (tiles == 0) return (int)cudaSuccess;
    const bool c_vec = n % 2 == 0 && (uintptr_t)c % 16 == 0;
    const bool b_vec = n % 2 == 0 && (CHUNKED ? rows16 : (uintptr_t)b % 16 == 0);
    return (int)(b_vec ? dd_run<true, WINDOW, CHUNKED, FLAGS>(group_ptr, starts, panels, b, c,
                                                              tiles, TM, Wc, n, n_tiles,
                                                              c_vec, flags, stream)
                       : dd_run<false, WINDOW, CHUNKED, FLAGS>(group_ptr, starts, panels, b,
                                                               c, tiles, TM, Wc, n, n_tiles,
                                                               c_vec, flags, stream));
}

}  // namespace

extern "C" {

// group_ptr (G + 1,), starts (S,), panels (S, TM, Wc) fp64 starting on 16
// bytes, b (rows >= max(starts) + Wc, n) fp64, c (G*TM, n) fp64; TM % 128
// == 0, Wc % 32 == 0.
int crp_ragged_dd_f64tc(const void* group_ptr, const void* starts,
                        const void* panels, const void* b, void* c, int64_t G,
                        int64_t TM, int64_t Wc, int64_t n, void* stream)
{
    return dd_entry<false>(group_ptr, starts, panels, b, c, G, TM, Wc, n, stream);
}

// #6 on fp64: the ragged pack's arrays, as crp_ragged_dd_f64tc takes them
int crp_ragged_f64(const void* group_ptr, const void* starts,
                   const void* panels, const void* b, void* c, int64_t G,
                   int64_t TM, int64_t Wc, int64_t n, void* stream)
{
    return dd_entry<false>(group_ptr, starts, panels, b, c, G, TM, Wc, n, stream);
}

// #3 on fp64: ws (G,), tiles (G, TM, W) fp64 starting on 16 bytes, b
// (rows >= max(ws) + W, n) fp64, c (G*TM, n) fp64; TM % 128 == 0,
// W % 32 == 0
int crp_window_sg_f64(const void* ws, const void* tiles, const void* b,
                      void* c, int64_t G, int64_t TM, int64_t W, int64_t n,
                      void* stream)
{
    return dd_entry<true>(nullptr, ws, tiles, b, c, G, TM, W, n, stream);
}

// #4 on fp64: one shard of a multi-shard window pack, the arrays #3 takes
int crp_window_f64(const void* ws, const void* tiles, const void* b, void* c,
                   int64_t G, int64_t TM, int64_t W, int64_t n, void* stream)
{
    return dd_entry<true>(nullptr, ws, tiles, b, c, G, TM, W, n, stream);
}

// #12 on fp64, one card: rows the chunks' row pointers (halo.cu), ws (G,)
// the global window starts (multiples of HALO_TK), tiles (G, TM, W) fp64
// starting on 16 bytes, c (G*TM, n) fp64; rows16 says whether every row
// pointer is on 16 bytes
int crp_halo_f64(const void* rows, const void* ws, const void* tiles, void* c, int64_t G,
                 int64_t TM, int64_t W, int64_t n, int64_t rows16, void* stream)
{
    return dd_entry<true, true>(nullptr, ws, tiles, rows, c, G, TM, W, n, stream,
                                rows16 != 0);
}

// #12 on fp64 across processes (halo.cu's *_flags entries): rows the
// chunks' (row pointer, arrive word) pairs (16-byte aligned), status this
// rank's status word, epoch the loads every owner must have made, bound_ns
// the longest a wait spins
int crp_halo_f64_flags(const void* rows, const void* ws, const void* tiles, void* c,
                       void* status, int64_t G, int64_t TM, int64_t W, int64_t n,
                       int64_t rows16, int64_t epoch, int64_t bound_ns, void* stream)
{
    const crp::HaloFlags flags = {(unsigned long long)epoch, (unsigned long long)bound_ns,
                                  static_cast<unsigned long long*>(status)};
    return dd_entry<true, true, true>(nullptr, ws, tiles, rows, c, G, TM, W, n, stream,
                                      rows16 != 0, flags);
}

// the kernel's resources as "key=value" pairs: the ring's stages and
// dynamic shared memory, threads (the consumers' among them), the
// registers setmaxnreg gives a consumer and a producer thread, the block
// tile, the DMMA shape and, for its kernels with 16-byte and 8-byte B
// copies, on the ragged walk ("b16", "b8": #11, #6), the windowed walk
// ("w16", "w8": #3, #4), with B through the chunk table ("c16", "c8": #12)
// and with the flags' waits ("f16", "f8": #12 across processes), the
// registers it is launched with, local (spill) bytes and resident blocks
// per SM
int crp_dd_layout(char* out, int len)
{
    int used = snprintf(out, len,
                        "stages=%d smem_bytes=%d threads=%d consumers=%d "
                        "consumer_registers=%d producer_registers=%d "
                        "flag_producer_registers=%d BM=%d BN=%d BK=%d mma_m=%d mma_n=8 "
                        "mma_k=%d",
                        DD_STAGES, DD_SMEM, DD_THREADS, DD_CONSUMERS, DD_CONSUMER_REGS,
                        DD_PRODUCER_REGS, DD_FLAG_PRODUCER_REGS, DD_BM, DD_BN, DD_BK,
                        DD_MMA_M, DD_MMA_K);
    using Report = cudaError_t (*)(const char*, char*, int);
    struct Kernel { const char* name; Report report; };
    const Kernel kernels[] = {{"b16", dd_resources<true, false>},
                              {"b8", dd_resources<false, false>},
                              {"w16", dd_resources<true, true>},
                              {"w8", dd_resources<false, true>},
                              {"c16", dd_resources<true, true, true>},
                              {"c8", dd_resources<false, true, true>},
                              {"f16", dd_resources<true, true, true, true>},
                              {"f8", dd_resources<false, true, true, true>}};
    for (const Kernel& k : kernels) {
        const cudaError_t e = k.report(k.name, out + used, len - used);
        if (e != cudaSuccess) return (int)e;
        used += (int)strlen(out + used);
    }
    return (int)cudaSuccess;
}

const char* crp_error_string(int code)
{
    return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
