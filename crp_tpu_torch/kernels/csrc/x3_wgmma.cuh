// The wgmma tile body, fed by TMA, of the kernels on bf16 panels: at x3 on
// the hi/lo pair, the super-grouped #1 (crp_window_sg_presplit) and #5
// (crp_window_sg_presplit_ab) in window_sg.cu, the non-super-grouped #4
// (crp_window_x3, every multi-shard pack) in window.cu, the fused halo
// kernel #12 (crp_halo_x3) in halo.cu and the ragged #7
// (crp_ragged_presplit) in ragged.cu; in one bf16 pass on the hi panels,
// the default entries: the super-grouped #2 (crp_window_sg_bf16) in
// window_sg.cu, #4 (crp_window_bf16) in window.cu, #12 (crp_halo_bf16) in
// halo.cu and the ragged #8 (crp_ragged_bf16) in ragged.cu; at highest on
// fp32 data, three TF32 products on the panels' TF32 planes (TF32X3,
// below): the super-grouped #3 (crp_window_sg_f32) in window_sg.cu, #4
// (crp_window_f32) in window.cu, #12 (crp_halo_f32, crp_halo_f32_flags)
// in halo.cu and the ragged #6 (crp_ragged_f32) in ragged.cu.  The
// kernel's MODE (WgMode below) picks the products, CHUNKED and RAGGED the
// walk; every mode takes every walk but PAIR_B (#5's alone).
//
// A uniform pack: group g holds the bf16 hi and lo (TM, W) panels of A
// over the B rows [ws[g], ws[g] + W), and
//
//     C[g*TM + r, j] = sum_k (al*bh + ah*bl + ah*bh)[r, k, j]
//
// with B split here to bf16 hi/lo in RNE (x - hi exact in fp32, then
// rounded), or arriving pre-split as two bf16 planes (PAIR_B, #5: the
// caller's split is the same RNE split, so the products and C are #1's
// bit for bit).  The panels are split once when they are packed: the
// multi-shard packs of #4 and #12 densify straight to the pair at x3, and
// to the hi plane alone at default (TMA copies bytes and can neither split
// nor round), the same RNE split the TPU kernels make of their fp32 panels
// on every read.
//
// With CHUNKED (#12 at every point) B lives in its owners' shards and
// chunk_src is a table of pointers, one per HALO_TK-row chunk of B: the
// chunk's first row in its owner's shard, null past the matrix (b only a
// valid address).  Every window start is a multiple of HALO_TK, so a stage
// (64 rows, or TF32X3's 32: a chunk is two stages or four) never straddles
// two chunks: the producer loads its stage's pointer once, before it waits
// for the stage to free, so that the load's latency hides under the wait.
// The other kernels compile without the lookup.
//
// With FLAGS (#12 across processes) the owners are other ranks' buffers
// and chunk_src holds (row pointer, arrive word) pairs, the word its
// owner's arrival word, loaded with the pointer before the stage wait:
// before the producer's first B copy from an owner it has not waited for
// (once the stage's panel tiles are in flight), its lane 0 spins on that
// word (panel_tiles.cuh halo_wait) and a warp barrier hands the acquire to
// the other lanes; only the producer reads B.  A window's chunks ascend, so do their owners: at
// most one wait an owner the window spans.  A wait that gives up makes
// every later chunk of the block dead, so the producer still makes each
// stage's 1 + 32 arrivals and the consumers never wait on a stage that
// does not come; the caller's done kernel turns C into NaN.
//
// With RAGGED (#7, #8, and #6 at highest) the panels are a ragged pack's
// (S, TM, W) chunks: group g owns the chunks s in [group_ptr[g],
// group_ptr[g + 1]), chunk s over the B rows [ws[s], ws[s] + W), and
// C[g*TM + r, j] sums the mode's products over all of g's chunks.  A block
// walks its group's chunks as one run of ceil(W / BK) stages each (BK = 64,
// TF32X3's 32), the ring's stage index running straight across chunk
// boundaries: stage k of chunk s is the box at column BK k, row s*TM +
// (row0 - g*TM) of the (S*TM, W) view, over B rows ws[s] + BK k.  TM % 128 == 0, so a
// box never straddles two chunks; dummy chunks (zero panels at start 0)
// are walked like any other, and the pack's group_ptr stops short of a
// shard's trailing no-op steps.  The other kernels compile without it.
//
// ONE_PASS (#2, #4, #12, #8): C[g*TM + r, j] = sum_k (ah*bh)[r, k, j], B
// cast to bf16 by the caller (as the TPU kernel's caller does for #2).  A
// stage holds the hi tile and one bf16 B plane, half an x3 stage, so its
// ring is twice as deep (6 stages); one wgmma per k16 in place of three, its
// B fragment read by one ldmatrix.trans (5% faster than 2-byte loads,
// PERF.md).  The fresh partial per 32-row slice stays (carried over a whole
// 5632-row window the tensor cores' own sum drifts ~2e-6, outside the 1e-6
// the kernel is held to).  Each slice's products are waited for before its
// adds, as at x3: the two consumer warpgroups interleave, so overlapping a
// slice's adds with its products (two fresh partials in turn,
// wgmma.wait_group 1) bought under 1% when measured (PERF.md).
//
// TF32X3 (#3, #4, #12, #6 at highest): C[g*TM + r, j] = sum_k (as*bb +
// ab*bs + ab*bb)[r, k, j] with both operands split to TF32 big/small as
// split_tf32 (panel_tiles.cuh) splits them: big rounded as cvt.rna rounds,
// small the same rounding of the exact remainder, the three products of
// panel_tiles.cuh's TF32 split.  TF32 wgmma is m64nNk8 and takes its
// shared-memory operand K-major only, so the transposed product below is
// forced.  The tensor cores read the top 19 bits of an fp32 shared-memory
// operand, a truncation, and TMA copies bytes, so the panels arrive split:
// the pack holds two fp32 planes of the operand bits split_tf32 hands the
// tensor cores (big: x + half a TF32 ulp, which the truncation turns into
// cvt.rna's value; small: the same of the remainder), split once at init
// (device_pack's "tf32" mode; #3's and #4's entries take the small plane
// G*TM*W floats after the big one, #12's and #6's the two planes apart).
// A 128-byte swizzle row holds 32 fp32 values: one TMA box is (128 rows x
// 32 k), and a stage, one 32-row fresh-accumulator slice, holds the big and
// the small tile and 32 rows of fp32 B, 4 stages deep.  Per slice
// the consumers run twelve wgmma.m64n128k8, three per k8 step, small terms
// first, in two groups of six (the fragments of two k8 steps at a time,
// as x3's per slice: ptxas gives the block 168 registers a thread).  B's k
// slice is split in registers as at x3, its fp32 pitch X3_TF_B_LD keeping
// the tf32 fragment's reads (4 k rows a quad) on distinct banks.  Splitting
// each landed tile in the ring instead (three splitter warps beside the
// producer, the pack JAX's fp32 panels) measured 1.37x slower on an H100
// (PERF.md; cli/f64_ab.py --point highest, its design:ring copy).
//
// The body computes the transposed product, C^T = B^T A^T, so that each
// operand sits where wgmma wants it:
//   * the panels' (TM, W) rows are K-major, wgmma's shared-memory operand
//     (N = 128 panel rows a block).  TMA copies each (128 x 64) hi and lo
//     tile straight into a ring of WgRing::STAGES shared-memory stages with
//     128-byte swizzle, completing on an mbarrier; no thread touches these,
//     the dominant bytes.  The tensor maps span the (G*TM, W) bf16 views
//     (for #12 the p shards' groups, flattened); columns past W come in as
//     zeros (the tensor's edge);
//   * B's slice is wgmma's register operand (M = 64 columns of B per
//     consumer warpgroup).  One producer warp copies it into the same stage
//     as fp32 with cp.async (16-byte copies, or, when n or B's alignment
//     forbids them, plain loads and stores; rows past W, rows of a dead
//     chunk and columns past n are zeros), and each consumer thread reads
//     its m64 x k16 fragment elements and splits them to bf16 hi/lo in
//     registers.  No split plane is written back.
// Per k16 step three wgmma.m64n128k16 run, small terms first as in every
// x3 kernel: (bh, A_lo), (bl, A_hi), (bh, A_hi).  The products of each
// 32-row k slice go into a fresh accumulator (wgmma's scale-d = 0), added
// to the running sum with IEEE fp32 adds: the tensor cores' own
// accumulation does not round to nearest (carried over a whole 5632-row
// window it drifted ~2e-6 from an IEEE sum at the windowed headline, the
// rule of every tensor-core body here).
//
// The block: warps 0-7 are two consumer warpgroups, each owning 64 of the
// block's 128 columns of B (and C) over its 128 panel rows; warp 8 is the
// producer.  288 threads at one block an SM leave 224 registers a thread,
// room for the running sum and the fresh partial (64 + 64 fp32) and the
// fragments without setmaxnreg.  Blocks are numbered n tile fastest, so the
// n tiles of one (group, 128-row tile) run on neighbouring SMs and the
// second read of a panel comes from L2.  The epilogue stages C^T through
// shared memory and writes C row-major with 16-byte stores; n is masked,
// never padded.
//
// What bounds it on an H100 (x3: three bf16 passes at 989 TF/s against the
// hi/lo panels once from HBM at 3.35 TB/s): at the p = 1 headline (G = 852,
// TM = 256, W = 5632, n = 256) 1.89 TFLOP, 1.91 ms, over 4.91 GB of panels
// (1.47 ms); at one p = 4 headline shard (#4: G = 214, W = 5632) 0.47 TFLOP,
// 0.48 ms, over 1.23 GB (0.37 ms); over all four shards (#12: 4 x 214
// groups) 1.90 TFLOP, 1.92 ms, over 4.94 GB.  Every block also reads its B
// window (64 rows x 128 columns a stage, as many bytes as the two panel
// tiles) from L2.  ONE_PASS at the headline: 0.63 TFLOP (0.64 ms) over 2.46
// GB of hi panels (0.73 ms): the bytes bound it, as they bound #4 on one p =
// 4 shard (0.62 GB, 0.18 ms) and #12 on all four (2.47 GB, 0.74 ms).  At the
// cplaw ragged pack (S = 12,322 chunks, TM = 512, W = 128, n = 256) the
// bytes bound both modes: x3 1.24 TFLOP (1.25 ms) against 3.23 GB of hi/lo
// panels, 0.81 GB of B and 0.81 GB of C (1.45 ms); one pass 0.41 TFLOP
// against 1.62 GB of hi panels, B in bf16 and C (0.84 ms).  There a block
// walks 8 chunks of 2 stages on average, against 88 stages at the headline,
// so its fixed costs (barrier init, filling the ring, the C epilogue) weigh
// about 5x more.  TF32X3: three TF32 passes at 495 TF/s, 3.81 ms at the
// p = 1 headline (#3) over 9.82 GB of TF32 planes (2.93 ms), 0.96 ms on one
// p = 4 shard (#4) over 2.47 GB, 3.83 ms over all four (#12) over 9.87 GB
// (2.95 ms), 2.50 ms at cplaw's highest ragged pack (#6: 4 stages a chunk)
// over about 6.5 GB (1.9 ms): the products bound it.

#pragma once

#include <cuda.h>  // CUtensorMap and its enums; the encoder comes from the runtime

#include "panel_tiles.cuh"

namespace crp {

constexpr int X3_BN = 128;     // panel rows a block (wgmma N)
constexpr int X3_BM = 128;     // B / C columns a block: 2 warpgroups x m64
constexpr int X3_BK = 64;      // k rows a stage: one 128-byte swizzled bf16 row
constexpr int X3_SLICE = 32;   // k rows summed into one fresh accumulator
constexpr int X3_CONSUMERS = 256;  // two warpgroups
constexpr int X3_THREADS = X3_CONSUMERS + 32;  // and the producer warp
constexpr int X3_A_TILE = X3_BN * X3_BK * 2;  // bytes of one hi or lo tile
constexpr int X3_B_LD = X3_BM + 4;    // fp32 pitch: conflict-free fragment reads
constexpr int X3_P_LD = X3_BM + 8;    // bf16 pitch of a B plane
constexpr int X3_B_BYTES = 2 * X3_BK * X3_P_LD * 2;  // >= X3_BK * X3_B_LD * 4
constexpr int X3_C_LD = X3_BN + 4;    // fp32 pitch of the staged C^T tile
constexpr int X3_TF_B_LD = X3_BM + 8;  // TF32X3's fp32 pitch: 4 k rows on distinct banks
static_assert(X3_BK * X3_B_LD * 4 <= X3_B_BYTES, "fp32 B slice fits the stage");
static_assert(X3_BN * X3_SLICE * 4 == X3_A_TILE, "a 128 x 32 fp32 tile: a bf16 tile's bytes");

// What a block multiplies: three bf16 products on fp32 B split in
// registers (SPLIT_B: #1, #4, #12, #7) or on B pre-split to two bf16 planes
// (PAIR_B: #5), or one bf16 product of the hi panels and a bf16 B
// (ONE_PASS: #2, #4, #12, #8), or three TF32 products of the panels' TF32
// big/small planes and fp32 B split in registers (TF32X3: #3, #4, #12, #6
// at highest)
enum class WgMode { SPLIT_B, PAIR_B, ONE_PASS, TF32X3 };

// The ring of a mode: a stage holds the hi tile (and x3's lo tile), then
// the B slice, as fp32 or as bf16 planes (X3_P_LD pitch); a one-pass stage
// is half as large, so its ring is twice as deep.  A TF32X3 stage is one
// 32-row slice: the big and the small tile (fp32, 32 k a row) and 32 rows
// of fp32 B
template <WgMode MODE>
struct WgRing {
    static constexpr bool ONE = MODE == WgMode::ONE_PASS;
    static constexpr bool TF32 = MODE == WgMode::TF32X3;
    static constexpr int BK = TF32 ? X3_SLICE : X3_BK;      // k rows a stage
    static constexpr int B_LD = TF32 ? X3_TF_B_LD : X3_B_LD;  // fp32 B pitch
    static constexpr int A_BYTES = (ONE ? 1 : 2) * X3_A_TILE;
    static constexpr int B_BYTES =
        ONE ? X3_BK * X3_P_LD * 2 : TF32 ? X3_SLICE * X3_TF_B_LD * 4 : X3_B_BYTES;
    static constexpr int STAGE = A_BYTES + B_BYTES;
    static constexpr int STAGES = ONE ? 6 : TF32 ? 4 : 3;
    static constexpr int SMEM = STAGES * STAGE + 2 * STAGES * 8 + 1024;
    static_assert(STAGE % 1024 == 0, "swizzled tiles need 1024-byte stage bases");
    static_assert(X3_BN * X3_C_LD * 4 <= STAGES * STAGE, "C^T fits the ring");
    static_assert(SMEM <= 232448, "the ring fits a block's shared memory");
};

__device__ __forceinline__ uint32_t smem_u32(const void* p)
{
    return (uint32_t)__cvta_generic_to_shared(p);
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

__device__ __forceinline__ void mbar_arrive_tx(uint32_t bar, int bytes)
{
    asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
                 :: "r"(bar), "r"(bytes) : "memory");
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

// the (X3_BK x X3_BN) box of `map` at column x, row y into dst
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map,
                                         uint32_t bar, int x, int y)
{
    asm volatile("cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes"
                 " [%0], [%1, {%3, %4}], [%2];\n"
                 :: "r"(dst), "l"((uint64_t)map), "r"(bar), "r"(x), "r"(y) : "memory");
}

// wgmma's descriptor of a K-major, 128-byte-swizzled operand at smem
// address `addr`: 8-row groups 1024 bytes apart (the leading offset is
// unused for this layout)
__device__ __forceinline__ uint64_t sw128_desc(uint32_t addr)
{
    return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)1 << 16)
           | ((uint64_t)(1024 >> 4) << 32) | ((uint64_t)1 << 62);
}

__device__ __forceinline__ void wgmma_fence()
{
    asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit_wait()
{
    asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
    asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}

// keeps the compiler from moving reads of d across the wgmma wait
__device__ __forceinline__ void fence_operands(float (&d)[64])
{
#pragma unroll
    for (int i = 0; i < 64; ++i) asm volatile("" : "+f"(d[i]) :: "memory");
}

// d (+)= a b: a the m64 x k16 bf16 register fragment, b the K-major
// (16 x 128) tile described by desc; scale_d = 0 starts a fresh sum
__device__ __forceinline__ void wgmma_128(float (&d)[64], const uint32_t (&a)[4],
                                          uint64_t desc, int scale_d)
{
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
        "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
        "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
        "{%64, %65, %66, %67}, %68, p, 1, 1, 0;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
          "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
          "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
          "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
          "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
          "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
          "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
          "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]),
          "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
          "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(scale_d));
}

// d (+)= a b in TF32: a the m64 x k8 register fragment (tf32 operand bits),
// b the K-major (8 x 128) fp32 tile described by desc, of which the tensor
// cores read the top 19 bits; scale_d = 0 starts a fresh sum
__device__ __forceinline__ void wgmma_tf32(float (&d)[64], const uint32_t (&a)[4],
                                           uint64_t desc, int scale_d)
{
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k8.f32.tf32.tf32 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
        "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
        "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
        "{%64, %65, %66, %67}, %68, p, 1, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
          "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
          "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
          "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
          "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
          "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
          "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
          "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]),
          "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
          "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(scale_d));
}

// RNE bf16 hi and lo of (x0, x1), x0 in the low half of each word: the
// split of split8 and of the pack, never a truncation
__device__ __forceinline__ void split_pair(float x0, float x1, uint32_t& hi, uint32_t& lo)
{
    const __nv_bfloat162 h = __floats2bfloat162_rn(x0, x1);
    const __nv_bfloat162 l =
        __floats2bfloat162_rn(x0 - __low2float(h), x1 - __high2float(h));
    hi = *reinterpret_cast<const uint32_t*>(&h);
    lo = *reinterpret_cast<const uint32_t*>(&l);
}

__device__ __forceinline__ uint32_t pack_pair(bf16 x0, bf16 x1)
{
    return (uint32_t)__bfloat16_as_ushort(x0) | ((uint32_t)__bfloat16_as_ushort(x1) << 16);
}

// The producer warp's B copy of stage rows [k0, k0 + BK) of the window (B
// rows b_row0 + k) and columns [n0, n0 + X3_BM), as fp32 (ld B_LD, the
// ring's) or as the bf16 planes (ld X3_P_LD: two with PAIR_B, one with
// ONE_PASS); rows at or past W and columns at or past n are zeros.  B_VEC:
// 16-byte cp.async copies, one arrival on bar when they land; else plain
// loads and stores, then one arrival (release: the stores are visible to
// the threads that wait on bar).
template <WgMode MODE, bool B_VEC>
__device__ __forceinline__ void x3_load_b(uint8_t* dst, const void* b, const bf16* b_lo,
                                          int64_t b_row0, int k0, int W, int n, int n0,
                                          int lane, uint32_t bar)
{
    constexpr bool B_PAIR = MODE == WgMode::PAIR_B;
    constexpr int BK = WgRing<MODE>::BK, B_LD = WgRing<MODE>::B_LD;
    if constexpr (MODE == WgMode::ONE_PASS) {
        const bf16* bh = static_cast<const bf16*>(b);
        if constexpr (B_VEC) {
            // 8 columns of a row a lane: lanes 0-15 the even rows, 16-31 the odd
            const int col = (lane % 16) * 8, r0 = lane / 16;
            const bool col_ok = n0 + col < n;
            uint32_t d = smem_u32(dst) + (r0 * X3_P_LD + col) * 2;
#pragma unroll 8
            for (int i = 0; i < X3_BK / 2; ++i) {
                const int r = 2 * i + r0;
                const bool ok = col_ok && k0 + r < W;
                const bf16* src = ok ? bh + (b_row0 + k0 + r) * n + n0 + col : bh;
                cp_async<16>(d, reinterpret_cast<const float*>(src), ok);
                d += 2 * X3_P_LD * 2;
            }
            mbar_arrive_cp_async(bar);
        } else {
            bf16* ph = reinterpret_cast<bf16*>(dst);
            const bf16 zero = __float2bfloat16_rn(0.0f);
#pragma unroll 4
            for (int r = 0; r < X3_BK; ++r) {
                const bool row_ok = k0 + r < W;
                const int64_t off = (b_row0 + k0 + r) * n + n0;
#pragma unroll
                for (int q = 0; q < X3_BM / 32; ++q) {
                    const int j = lane + 32 * q;
                    ph[r * X3_P_LD + j] = row_ok && n0 + j < n ? bh[off + j] : zero;
                }
            }
            mbar_arrive(bar);
        }
    } else if constexpr (B_VEC) {
        // fp32: lane owns 4 columns of every row; B_PAIR: 8 columns of one plane
        constexpr int PER_ROW = B_PAIR ? X3_BM / 8 : X3_BM / 4;  // copies a row a plane
        const int col = (lane % PER_ROW) * (B_PAIR ? 8 : 4);
        const int plane = B_PAIR ? lane / PER_ROW : 0;
        const bool col_ok = n0 + col < n;
        const char* src0 = B_PAIR && plane ? (const char*)b_lo : (const char*)b;
        constexpr int ES = B_PAIR ? 2 : 4;
        constexpr int LD = B_PAIR ? X3_P_LD : B_LD;
        uint32_t d = smem_u32(dst) + (plane * X3_BK * LD + col) * ES;
#pragma unroll 8
        for (int r = 0; r < BK; ++r) {
            const bool ok = col_ok && k0 + r < W;
            const float* src = (const float*)(ok ? src0 + ((b_row0 + k0 + r) * n + n0 + col) * ES
                                                 : src0);
            cp_async<16>(d, src, ok);
            d += LD * ES;
        }
        mbar_arrive_cp_async(bar);
    } else if constexpr (!B_PAIR) {
        float* bs = reinterpret_cast<float*>(dst);
        const float* bf = static_cast<const float*>(b);
#pragma unroll 4
        for (int r = 0; r < BK; ++r) {
            const bool row_ok = k0 + r < W;
            const float* src = bf + (b_row0 + k0 + r) * n + n0;
#pragma unroll
            for (int q = 0; q < X3_BM / 32; ++q) {
                const int j = lane + 32 * q;
                bs[r * B_LD + j] = row_ok && n0 + j < n ? src[j] : 0.0f;
            }
        }
        mbar_arrive(bar);
    } else {
        bf16* ph = reinterpret_cast<bf16*>(dst);
        bf16* pl = ph + X3_BK * X3_P_LD;
        const bf16* bh = static_cast<const bf16*>(b);
        const bf16 zero = __float2bfloat16_rn(0.0f);
#pragma unroll 4
        for (int r = 0; r < X3_BK; ++r) {
            const bool row_ok = k0 + r < W;
            const int64_t off = (b_row0 + k0 + r) * n + n0;
#pragma unroll
            for (int q = 0; q < X3_BM / 32; ++q) {
                const int j = lane + 32 * q;
                const bool ok = row_ok && n0 + j < n;
                ph[r * X3_P_LD + j] = ok ? bh[off + j] : zero;
                pl[r * X3_P_LD + j] = ok ? b_lo[off + j] : zero;
            }
        }
        mbar_arrive(bar);
    }
}

// The consumer thread's hi and lo fragments of the k16 step at stage row kk
// (ONE_PASS: hi only, fl untouched): rows j0 and j0 + 8 (B columns) of the
// m64 x k16 operand, columns (k rows of B) 2 tq, 2 tq + 1 and the same + 8,
// in the PTX ISA's register layout
template <WgMode MODE>
__device__ __forceinline__ void x3_fragments(const uint8_t* stage_b, int kk, int j0, int tq,
                                             uint32_t (&fh)[4], uint32_t (&fl)[4])
{
    if constexpr (MODE == WgMode::SPLIT_B) {
        const float* bs = reinterpret_cast<const float*>(stage_b) + (kk + 2 * tq) * X3_B_LD + j0;
#pragma unroll
        for (int q = 0; q < 4; ++q) {  // (j0, k) (j0 + 8, k) (j0, k + 8) (j0 + 8, k + 8)
            const float* p = bs + (q >> 1) * 8 * X3_B_LD + (q & 1) * 8;
            split_pair(p[0], p[X3_B_LD], fh[q], fl[q]);
        }
    } else if constexpr (MODE == WgMode::ONE_PASS) {
        // the same four 8 x 8 blocks in one ldmatrix, transposed: lane l
        // gives the address of row l & 7 of block l >> 3 (a 16-byte row of
        // 8 B columns; the padded pitch keeps the 8 rows on distinct banks)
        const int lane = threadIdx.x & 31, m = lane >> 3;
        const bf16* p = reinterpret_cast<const bf16*>(stage_b)
                        + (kk + (lane & 7) + 8 * (m >> 1)) * X3_P_LD + j0 - (lane >> 2)
                        + 8 * (m & 1);
        asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
                     : "=r"(fh[0]), "=r"(fh[1]), "=r"(fh[2]), "=r"(fh[3])
                     : "r"(smem_u32(p)) : "memory");
    } else {
        const bf16* ph = reinterpret_cast<const bf16*>(stage_b) + (kk + 2 * tq) * X3_P_LD + j0;
        const bf16* pl = ph + X3_BK * X3_P_LD;
#pragma unroll
        for (int q = 0; q < 4; ++q) {
            const int o = (q >> 1) * 8 * X3_P_LD + (q & 1) * 8;
            fh[q] = pack_pair(ph[o], ph[o + X3_P_LD]);
            fl[q] = pack_pair(pl[o], pl[o + X3_P_LD]);
        }
    }
}

// TF32X3: the consumer thread's big and small fragments of k8 step ks of
// the stage's fp32 B slice, split by split_tf32: rows j0 and j0 + 8 (B
// columns) of the m64 x k8 operand, columns (k rows of B) tq and tq + 4, in
// the PTX ISA's register layout
__device__ __forceinline__ void tf32_fragments(const uint8_t* stage_b, int ks, int j0, int tq,
                                               uint32_t (&fb)[4], uint32_t (&fs)[4])
{
    const float* bs =
        reinterpret_cast<const float*>(stage_b) + (8 * ks + tq) * X3_TF_B_LD + j0;
#pragma unroll
    for (int q = 0; q < 4; ++q)  // (j0, k) (j0 + 8, k) (j0, k + 4) (j0 + 8, k + 4)
        split_tf32(bs[(q >> 1) * 4 * X3_TF_B_LD + (q & 1) * 8], fb[q], fs[q]);
}

template <WgMode MODE, bool B_VEC, bool CHUNKED = false, bool RAGGED = false,
          bool FLAGS = false>
__global__ void __launch_bounds__(X3_THREADS, 1)
x3_wgmma_kernel(const __grid_constant__ CUtensorMap a_hi,
                const __grid_constant__ CUtensorMap a_lo,
                const int32_t* __restrict__ ws,
                const void* __restrict__ b,
                const bf16* __restrict__ b_lo,
                float* __restrict__ c,
                int64_t TM, int W, int n, int n_tiles,
                const int32_t* __restrict__ chunk_src,
                const int32_t* __restrict__ group_ptr,
                const HaloFlags flags)
{
    using Ring = WgRing<MODE>;
    static_assert(!(CHUNKED && MODE == WgMode::PAIR_B),
                  "the chunk lookup serves #12 (SPLIT_B and ONE_PASS)");
    static_assert(!FLAGS || CHUNKED, "the flags gate the chunk lookup");
    static_assert(!(RAGGED && (CHUNKED || MODE == WgMode::PAIR_B)),
                  "the ragged walk serves #7 (SPLIT_B) and #8 (ONE_PASS)");
    extern __shared__ __align__(16) uint8_t x3_smem_raw[];
    uint8_t* const smem =
        x3_smem_raw + ((1024 - (smem_u32(x3_smem_raw) & 1023)) & 1023);
    const uint32_t full0 = smem_u32(smem + Ring::STAGES * Ring::STAGE);
    const uint32_t empty0 = full0 + Ring::STAGES * 8;

    const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
    const int64_t tile = blockIdx.x;
    const int n0 = (int)(tile % n_tiles) * X3_BM;
    const int64_t row0 = (tile / n_tiles) * X3_BN;  // first panel (and C) row
    const int64_t g = row0 / TM;                    // TM % X3_BN == 0
    const int nk = (W + Ring::BK - 1) / Ring::BK;   // stages of the window (a chunk)
    int64_t s0 = g;   // RAGGED: the group's chunks [s0, s0 + stages / nk)
    int stages = nk;  // the block's walk
    if constexpr (RAGGED) {
        s0 = group_ptr[g];
        stages = (int)(group_ptr[g + 1] - s0) * nk;
    }

    if (tid == 0) {
        for (int s = 0; s < Ring::STAGES; ++s) {
            mbar_init(full0 + 8 * s, 1 + 32);  // the TMA arrival and the 32 B copiers
            mbar_init(empty0 + 8 * s, X3_CONSUMERS / 32);  // one per consumer warp
        }
        asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    }
    __syncthreads();

    if (warp == X3_CONSUMERS / 32) {  // the producer
        const int64_t b_row0 = RAGGED ? 0 : ws[g];
        const unsigned long long* gate = nullptr;  // FLAGS: the owner last waited for
        bool failed = false;
        for (int t = 0; t < stages; ++t) {
            const int s = t % Ring::STAGES;
            const void* rows = b;     // CHUNKED: the stage's chunk (see above)
            const unsigned long long* word = nullptr;  // FLAGS: its owner's arrive word
            if constexpr (FLAGS) {
                const ulonglong2 pair = reinterpret_cast<const ulonglong2*>(
                    chunk_src)[(b_row0 + t * Ring::BK) / HALO_TK];
                rows = reinterpret_cast<const void*>(pair.x);
                word = reinterpret_cast<const unsigned long long*>(pair.y);
            } else if constexpr (CHUNKED) {
                rows = reinterpret_cast<const void* const*>(
                    chunk_src)[(b_row0 + t * Ring::BK) / HALO_TK];
            }
            mbar_wait(empty0 + 8 * s, ((t / Ring::STAGES) & 1) ^ 1);
            uint8_t* st = smem + s * Ring::STAGE;
            int kt = t;               // the stage's BK-row step in its window
            int64_t a_row = row0;     // its first panel row
            int64_t b_row = b_row0;   // stage row k is row b_row + kt BK + k of b
            if constexpr (RAGGED) {   // step kt of chunk ch, over the B rows at ws[ch]
                const int64_t ch = s0 + t / nk;
                kt = t % nk;
                a_row = ch * TM + row0 - g * TM;
                b_row = ws[ch];
            }
            if (lane == 0) {
                mbar_arrive_tx(full0 + 8 * s, Ring::A_BYTES);
                tma_load(smem_u32(st), &a_hi, full0 + 8 * s, kt * Ring::BK, (int)a_row);
                if constexpr (!Ring::ONE)
                    tma_load(smem_u32(st) + X3_A_TILE, &a_lo, full0 + 8 * s, kt * Ring::BK,
                             (int)a_row);
            }
            if constexpr (FLAGS) {    // the stage's owner arrived (see above), while the
                                      // panel tiles' TMA is in flight
                const int64_t chunk = (b_row0 + t * Ring::BK) / HALO_TK;
                if (word && word != gate && !failed) {
                    gate = word;
                    int code = 0;
                    if (lane == 0)
                        code = halo_wait(word, flags.epoch, flags.bound_ns, flags.status,
                                         HALO_ARRIVAL, chunk);
                    failed = __shfl_sync(0xffffffffu, code, 0) != 0;
                    __syncwarp();
                }
                if (failed) rows = nullptr;
            }
            int w_end = W;            // stage rows at or past it are zeros
            if constexpr (CHUNKED) {  // stage row k is row (t BK) % HALO_TK + k of rows
                b_row = (t * Ring::BK) % HALO_TK - t * Ring::BK;
                w_end = rows ? W : 0;  // a dead chunk: every row zero
                if (!rows) rows = b;
            }
            x3_load_b<MODE, B_VEC>(st + Ring::A_BYTES, rows, b_lo, b_row, kt * Ring::BK,
                                   w_end, n, n0, lane, full0 + 8 * s);
        }
        cp_async_commit();
        cp_async_wait<0>();
        return;
    }

    // consumers: warpgroup wg owns columns [64 wg, 64 wg + 64) of the block
    const int wg = warp >> 2;
    const int gq = lane >> 2, tq = lane & 3;
    const int j0 = wg * 64 + (warp & 3) * 16 + gq;
    float acc[64], part[64];
#pragma unroll
    for (int i = 0; i < 64; ++i) acc[i] = part[i] = 0.0f;

    if constexpr (Ring::TF32) {
        for (int t = 0; t < stages; ++t) {
            const int s = t % Ring::STAGES;
            mbar_wait(full0 + 8 * s, (t / Ring::STAGES) & 1);
            __syncwarp();  // wgmma's .aligned forms need the warp converged
            const uint8_t* st = smem + s * Ring::STAGE;
            const uint32_t big_addr = smem_u32(st), small_addr = big_addr + X3_A_TILE;
#pragma unroll
            for (int h = 0; h < X3_SLICE / 16; ++h) {  // two k8 steps a group
                uint32_t fb[2][4], fs[2][4];
#pragma unroll
                for (int kk = 0; kk < 2; ++kk)
                    tf32_fragments(st + Ring::A_BYTES, 2 * h + kk, j0, tq, fb[kk], fs[kk]);
                wgmma_fence();
#pragma unroll
                for (int kk = 0; kk < 2; ++kk) {
                    const int ks = 2 * h + kk;
                    const uint32_t koff = ks * 32;  // 8 fp32 along the row
                    const uint64_t db = sw128_desc(big_addr + koff);
                    wgmma_tf32(part, fb[kk], sw128_desc(small_addr + koff), ks);  // 0: fresh
                    wgmma_tf32(part, fs[kk], db, 1);
                    wgmma_tf32(part, fb[kk], db, 1);
                }
                wgmma_commit_wait();
            }
            fence_operands(part);
#pragma unroll
            for (int i = 0; i < 64; ++i) acc[i] += part[i];
            __syncwarp();
            if (lane == 0) mbar_arrive(empty0 + 8 * s);
        }
    } else {
        for (int t = 0; t < stages; ++t) {
            const int s = t % Ring::STAGES;
            mbar_wait(full0 + 8 * s, (t / Ring::STAGES) & 1);
            __syncwarp();  // wgmma's .aligned forms need the warp converged
            const uint8_t* st = smem + s * Ring::STAGE;
            const uint32_t hi_addr = smem_u32(st), lo_addr = hi_addr + X3_A_TILE;
            const int kt = RAGGED ? t % nk : t;  // the stage's step in its window
#pragma unroll
            for (int h = 0; h < X3_BK / X3_SLICE; ++h) {
                if (kt * X3_BK + h * X3_SLICE >= W) break;  // W % 32 == 0: nothing left
                uint32_t fh[2][4], fl[2][4];  // fl: x3 only
#pragma unroll
                for (int ks = 0; ks < 2; ++ks)
                    x3_fragments<MODE>(st + Ring::A_BYTES, h * X3_SLICE + ks * 16, j0, tq,
                                       fh[ks], fl[ks]);
                wgmma_fence();
#pragma unroll
                for (int ks = 0; ks < 2; ++ks) {
                    const uint32_t koff = (h * 2 + ks) * 32;  // 16 bf16 along the row
                    const uint64_t dh = sw128_desc(hi_addr + koff);
                    if constexpr (Ring::ONE) {
                        wgmma_128(part, fh[ks], dh, ks);  // ah bh alone; ks = 0: a fresh sum
                    } else {
                        const uint64_t dl = sw128_desc(lo_addr + koff);
                        wgmma_128(part, fh[ks], dl, ks);  // the slice's first: a fresh sum
                        wgmma_128(part, fl[ks], dh, 1);
                        wgmma_128(part, fh[ks], dh, 1);
                    }
                }
                wgmma_commit_wait();
                fence_operands(part);
#pragma unroll
                for (int i = 0; i < 64; ++i) acc[i] += part[i];
            }
            __syncwarp();
            if (lane == 0) mbar_arrive(empty0 + 8 * s);
        }
    }

    // epilogue: C^T fragments into a (128 rows x 128 columns) C tile in the
    // ring's memory once both warpgroups are done with it, then row-major
    // 16-byte stores (scalar where n % 4 != 0), columns at or past n masked
    asm volatile("bar.sync 1, %0;\n" :: "n"(X3_CONSUMERS) : "memory");
    float* cs = reinterpret_cast<float*>(smem);
#pragma unroll
    for (int i = 0; i < 16; ++i)
#pragma unroll
        for (int e = 0; e < 4; ++e)  // row j0 (+8) of C^T, column 8 i + 2 tq (+1)
            cs[(8 * i + 2 * tq + (e & 1)) * X3_C_LD + j0 + 8 * (e >> 1)] = acc[4 * i + e];
    asm volatile("bar.sync 1, %0;\n" :: "n"(X3_CONSUMERS) : "memory");
#pragma unroll 4
    for (int q = 0; q < X3_BN * X3_BM / 4 / X3_CONSUMERS; ++q) {
        const int idx = tid + q * X3_CONSUMERS;
        const int r = idx / (X3_BM / 4), col = n0 + (idx % (X3_BM / 4)) * 4;
        if (col >= n) continue;
        const float4 v = *reinterpret_cast<const float4*>(cs + r * X3_C_LD + col - n0);
        float* dst = c + (row0 + r) * n + col;
        if (n % 4 == 0) {
            *reinterpret_cast<float4*>(dst) = v;
        } else {
            const float x[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
            for (int e = 0; e < 4; ++e)
                if (col + e < n) dst[e] = x[e];
        }
    }
}

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                 const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// libcuda's cuTensorMapEncodeTiled, looked up through the runtime (no -lcuda)
inline cudaError_t encode_tiled(EncodeTiled* fn)
{
    static EncodeTiled cached = nullptr;
    if (!cached) {
        void* p = nullptr;
        cudaDriverEntryPointQueryResult q;
#if CUDART_VERSION >= 12050
        const cudaError_t e = cudaGetDriverEntryPointByVersion(
            "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &q);
#else
        const cudaError_t e =
            cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &q);
#endif
        if (e != cudaSuccess) return e;
        if (q != cudaDriverEntryPointSuccess || !p) return cudaErrorSymbolNotFound;
        cached = reinterpret_cast<EncodeTiled>(p);
    }
    *fn = cached;
    return cudaSuccess;
}

// the tensor map of a (rows, W) bf16 panel view: (X3_BK x X3_BN) boxes,
// 128-byte swizzle, zeros past the edge; with f32 an fp32 view, (X3_SLICE x
// X3_BN) boxes (a 128-byte row either way)
inline cudaError_t panel_map(CUtensorMap* map, const void* panels, int64_t rows, int64_t W,
                             bool f32 = false)
{
    EncodeTiled fn;
    const cudaError_t e = encode_tiled(&fn);
    if (e != cudaSuccess) return e;
    const cuuint64_t dims[2] = {(cuuint64_t)W, (cuuint64_t)rows};
    const cuuint64_t strides[1] = {(cuuint64_t)W * (f32 ? 4 : 2)};
    const cuuint32_t box[2] = {(cuuint32_t)(f32 ? X3_SLICE : X3_BK), X3_BN};
    const cuuint32_t unit[2] = {1, 1};
    const CUresult r = fn(map, f32 ? CU_TENSOR_MAP_DATA_TYPE_FLOAT32
                                   : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16,
                          2, const_cast<void*>(panels),
                          dims, strides, box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE,
                          CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                          CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
    return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

template <WgMode MODE, bool B_VEC, bool CHUNKED = false, bool RAGGED = false,
          bool FLAGS = false>
cudaError_t x3_prepare()
{
    return cudaFuncSetAttribute(x3_wgmma_kernel<MODE, B_VEC, CHUNKED, RAGGED, FLAGS>,
                                cudaFuncAttributeMaxDynamicSharedMemorySize,
                                WgRing<MODE>::SMEM);
}

// SPLIT_B: b is fp32 B; PAIR_B: b is B's bf16 hi plane and b_lo its lo
// plane (split_b_bf16); ONE_PASS: b is B cast to bf16, and al and b_lo are
// not read; TF32X3: ah and al are the panels' big and small planes
// (fp32, each of the panels' shape), b fp32 B, and b_lo is not read.  The panels must be 16-byte
// aligned (TMA); B of any alignment
// (16-byte copies where n and B allow them).  CHUNKED: B's rows come
// through chunk_src's row pointers (see above), every ws is a multiple of
// HALO_TK, and rows16 says whether every row pointer is on 16 bytes.  RAGGED: the
// panels are the (S, TM, W) chunks, ws their starts and group_ptr the
// groups' chunk ranges (see above).  FLAGS: the waits of #12 across
// processes (flags; chunk_src the (row pointer, arrive word) pairs, see
// above).
template <WgMode MODE, bool CHUNKED = false, bool RAGGED = false, bool FLAGS = false>
int launch_wgmma(const void* ws, const void* ah, const void* al, const void* b,
                 const void* b_lo, void* c, int64_t G, int64_t TM, int64_t W, int64_t n,
                 void* stream, const void* chunk_src = nullptr,
                 const void* group_ptr = nullptr, bool rows16 = false, HaloFlags flags = {})
{
    // a stage starts a multiple of BK rows past a HALO_TK-aligned window
    // start: it lies in one B chunk
    static_assert(HALO_TK % WgRing<MODE>::BK == 0, "a stage never straddles two B chunks");
    constexpr bool ONE = WgRing<MODE>::ONE, TF32 = WgRing<MODE>::TF32;
    if (G < 0 || TM <= 0 || TM % X3_BN || W <= 0 || W % X3_SLICE || n < 0
        || (CHUNKED && !chunk_src) || (RAGGED && !group_ptr))
        return (int)cudaErrorInvalidValue;
    if ((uintptr_t)ah % 16 || (!ONE && (uintptr_t)al % 16))
        return (int)cudaErrorMisalignedAddress;
    const int64_t n_tiles = (n + X3_BM - 1) / X3_BM;
    const int64_t blocks = G * (TM / X3_BN) * n_tiles;
    if (blocks > 0x7fffffff || G * TM > 0x7fffffff || W > 0x7fffffff || n > 0x7fffffff)
        return (int)cudaErrorInvalidConfiguration;
    if (blocks == 0) return (int)cudaGetLastError();
    // RAGGED: the entry is not given S, the chunk count, so the maps span
    // every row a 32-bit box coordinate reaches; group_ptr, trusted as by
    // every ragged kernel, keeps each box inside the S TM rows of the pack
    const int64_t rows = RAGGED ? 0x7fffffff : G * TM;
    // cuTensorMapEncodeTiled makes the maps and needs a context current on
    // this thread; a thread that has made no runtime call yet (autograd's
    // device thread, in a backward) has none, so bind the current device's
    // primary context first (CUDA 12's cudaSetDevice does, with no sync)
    int dev = 0;
    cudaError_t e = cudaGetDevice(&dev);
    if (e == cudaSuccess) e = cudaSetDevice(dev);
    if (e != cudaSuccess) return (int)e;
    CUtensorMap hi, lo;
    e = panel_map(&hi, ah, rows, W, TF32);
    if (e == cudaSuccess) e = panel_map(&lo, ONE ? ah : al, rows, W, TF32);
    if (e != cudaSuccess) return (int)e;
    const bool fp32_b = MODE == WgMode::SPLIT_B || TF32;
    const bool vec = n % (fp32_b ? 4 : 8) == 0
                     && (CHUNKED ? rows16 : (uintptr_t)b % 16 == 0)
                     && (MODE != WgMode::PAIR_B || (uintptr_t)b_lo % 16 == 0);
    e = vec ? x3_prepare<MODE, true, CHUNKED, RAGGED, FLAGS>()
            : x3_prepare<MODE, false, CHUNKED, RAGGED, FLAGS>();
    if (e != cudaSuccess) return (int)e;
    const auto kernel = vec ? x3_wgmma_kernel<MODE, true, CHUNKED, RAGGED, FLAGS>
                            : x3_wgmma_kernel<MODE, false, CHUNKED, RAGGED, FLAGS>;
    kernel<<<(unsigned)blocks, X3_THREADS, WgRing<MODE>::SMEM, (cudaStream_t)stream>>>(
        hi, lo, static_cast<const int32_t*>(ws), b, static_cast<const bf16*>(b_lo),
        static_cast<float*>(c), TM, (int)W, (int)n, (int)n_tiles,
        static_cast<const int32_t*>(chunk_src), static_cast<const int32_t*>(group_ptr),
        flags);
    return (int)cudaGetLastError();
}

template <WgMode MODE, bool B_VEC, bool CHUNKED = false, bool RAGGED = false,
          bool FLAGS = false>
cudaError_t x3_resources(const char* copy, char* out, int len)
{
    const cudaError_t e = x3_prepare<MODE, B_VEC, CHUNKED, RAGGED, FLAGS>();
    if (e != cudaSuccess) return e;
    return kernel_resources(x3_wgmma_kernel<MODE, B_VEC, CHUNKED, RAGGED, FLAGS>, X3_THREADS,
                            WgRing<MODE>::SMEM, copy, out, len);
}

// The ring and resources of the wgmma kernels of one library as
// "key=value" pairs separated by spaces (at most len bytes, NUL included):
// the x3 ring's stages, dynamic shared memory bytes, threads and block tile
// (BM columns of B, BN panel rows, BK k rows a stage), then per kernel its
// resources: "b16" and "b4" (#1, #4 and with RAGGED #7, fp32 B by 16-byte
// copies or by plain 4-byte loads), with CHUNKED "chunk16" and "chunk4" in
// their place (#12, B's rows through chunk_src); with SG (window_sg.cu)
// also "pair16" and "pair2" (#5, the bf16 planes likewise); then the
// one-pass ring ("one.stages", "one.smem_bytes") and its kernels "one16"
// and "one2" (#2, #4 or with RAGGED #8, the bf16 B plane by 16-byte copies
// or by plain 2-byte loads), with CHUNKED "chunkone16" and "chunkone2" in
// their place (#12 at default); with CHUNKED, then, the same four with the
// waits of #12 across processes: "flag16", "flag4", "flagone16", "flagone2";
// with TF32 the TF32X3 ring ("tf32.stages", "tf32.smem_bytes", "tf32.BK")
// and its kernels "tf32_16" and "tf32_4" (#3, #4 or with RAGGED #6 at
// highest, fp32 B by 16-byte copies or by plain loads), with CHUNKED
// "chunktf32_16", "chunktf32_4", "flagtf32_16" and "flagtf32_4" in their
// place (#12 at highest, on one card and across processes)
template <bool SG, bool CHUNKED, bool RAGGED = false, bool TF32 = false>
inline int x3_layout(char* out, int len)
{
    static_assert(SG + CHUNKED + RAGGED <= 1, "no library builds two of them");
    using X3 = WgRing<WgMode::SPLIT_B>;
    using One = WgRing<WgMode::ONE_PASS>;
    using Tf = WgRing<WgMode::TF32X3>;
    int used = snprintf(out, len,
                        "stages=%d smem_bytes=%d threads=%d BM=%d BN=%d BK=%d"
                        " one.stages=%d one.smem_bytes=%d",
                        X3::STAGES, X3::SMEM, X3_THREADS, X3_BM, X3_BN, X3_BK, One::STAGES,
                        One::SMEM);
    if constexpr (TF32)
        used += snprintf(out + used, len - used, " tf32.stages=%d tf32.smem_bytes=%d tf32.BK=%d",
                         Tf::STAGES, Tf::SMEM, Tf::BK);
    using Report = cudaError_t (*)(const char*, char*, int);
    struct Kernel { const char* copy; Report report; };
    constexpr WgMode SPLIT = WgMode::SPLIT_B, ONE = WgMode::ONE_PASS;
    Kernel kernels[12] = {
        {CHUNKED ? "chunk16" : "b16", x3_resources<SPLIT, true, CHUNKED, RAGGED>},
        {CHUNKED ? "chunk4" : "b4", x3_resources<SPLIT, false, CHUNKED, RAGGED>}};
    int count = 2;
    if constexpr (SG) {
        kernels[count++] = {"pair16", x3_resources<WgMode::PAIR_B, true>};
        kernels[count++] = {"pair2", x3_resources<WgMode::PAIR_B, false>};
    }
    kernels[count++] = {CHUNKED ? "chunkone16" : "one16",
                        x3_resources<ONE, true, CHUNKED, RAGGED>};
    kernels[count++] = {CHUNKED ? "chunkone2" : "one2",
                        x3_resources<ONE, false, CHUNKED, RAGGED>};
    if constexpr (CHUNKED) {
        kernels[count++] = {"flag16", x3_resources<SPLIT, true, true, false, true>};
        kernels[count++] = {"flag4", x3_resources<SPLIT, false, true, false, true>};
        kernels[count++] = {"flagone16", x3_resources<ONE, true, true, false, true>};
        kernels[count++] = {"flagone2", x3_resources<ONE, false, true, false, true>};
    }
    constexpr WgMode TF = WgMode::TF32X3;
    if constexpr (TF32 && CHUNKED) {
        kernels[count++] = {"chunktf32_16", x3_resources<TF, true, true>};
        kernels[count++] = {"chunktf32_4", x3_resources<TF, false, true>};
        kernels[count++] = {"flagtf32_16", x3_resources<TF, true, true, false, true>};
        kernels[count++] = {"flagtf32_4", x3_resources<TF, false, true, false, true>};
    } else if constexpr (TF32) {
        kernels[count++] = {"tf32_16", x3_resources<TF, true, false, RAGGED>};
        kernels[count++] = {"tf32_4", x3_resources<TF, false, false, RAGGED>};
    }
    for (int i = 0; i < count; ++i) {
        const cudaError_t e = kernels[i].report(kernels[i].copy, out + used, len - used);
        if (e != cudaSuccess) return (int)e;
        used += (int)strlen(out + used);
    }
    return (int)cudaSuccess;
}

}  // namespace crp
