// Hopper kernels for the fused spill of the ragged SpMM and for the gather
// kind.
//
// The spilled nonzeros of a ragged pack are regrouped on the host into
// steps of Q slots, each step inside one TMo-row block of the (M, n)
// output (crp_tpu/kernels/spmm_ragged.py pack_spill_blocks); the gather
// pack holds every nonzero of a shard the same way (pack_gather_blocks).
// Within a block the slots are in column order, so a row's slots are
// scattered over the block's steps.  These kernels do not read that pack:
// they read its row-ordered view (spmm_ragged.spill_row_view, built once
// at init on the device), which holds the live slots only (pad slots, rel
// == TMo, never appear, so they never reach a product), stably sorted by
// output row:
//
//   vcols (Z,), vvals (Z,)  the slots' columns and values, row by row,
//                           within a row in the pack's order;
//   items (I + 1, 4) int32  the work items, in row order: (row, first
//                           slot, part, part0).  Item i holds the slots
//                           [items[i].first, items[i + 1].first), at most
//                           L of them, all of row `row`; a row with slots
//                           has one item or several (a power-law hub),
//                           which number their partials part0, part0 + 1,
//                           ... (part the item's own; -1 and -1 for a row
//                           of one item); rows with no slot come as runs,
//                           an item with no slot for the -part0 rows from
//                           `row` on (part -1); the sentinel item I, and
//                           the items that pad a shard to the longest,
//                           have row -1 and no slot;
//   parts (P,) int32        for each partial, how many its row has.
//
// The entries write every row of the complete
//
//     out[r, :] = C[r, :] + sum over the live slots q of row r of contrib(q)
//
// with contrib(q) = vals[q] * B[cols[q], :] rounded as the TPU kernel does
// at each operating point: the fp32 product (highest), its bf16 hi + lo
// (x3), or its bf16 rounding (default).  crp_gather_blocks takes no C: a
// row with no slot comes out zero.  A row with no slot is C copied (the
// spill), bit for bit, with the rows of its run a few at a time.
//
// Replaces _spill_block_kernel: crp_spill_blocks its has_c=True form (via
// spmm_spill_pallas), crp_gather_blocks its has_c=False form (via
// spmm_gather_chunked, the gather kind).  The TPU kernel routes rows with a
// one-hot MXU product and takes the gathered B rows as one (ns*Q, n) XLA
// stream; here the kernel reads B[cols[q]] itself.
//
// Layout: a unit of work is one item over one tile of 128 columns (two
// units an item at n = 256); a warp takes one unit at a time, 8 warps a
// block, as many blocks as the card holds at once (3 an SM: at most 85
// registers a thread, 24 warps an SM), and warp w of the W in the grid
// walks the units w, w + W, w + 2 W, ...  The lanes span the tile with
// V-float loads (V = 4 where n % 4 == 0 and B, C and the output start on
// 16 bytes, else 2 or 1, chosen at launch): lane l holds the 4 columns (j
// * 32 + l) * V + [0, V), j < 4 / V, in registers.  The item's slots are
// read 32 at a time, one per lane, and broadcast by __shfl_sync; their B
// row pieces are loaded RW_BATCH at a time (2 KB in flight a warp) and
// added in slot order.  While a unit's last B rows are in flight, the warp
// loads the unit's C row and the next unit's first slots; the next
// descriptor is loaded when the unit starts.  So a warp's chain of
// dependent loads is its B rows alone, and many small warps keep many
// chains going: on the H100 more warps with fewer rows in flight each
// gathered faster than fewer warps with more (spill_split's variants).
// C is read and the output written evict-first, so that L2 keeps B's rows.
//
// The sum order is fixed, the same at every launch and for every load
// width: each element of an item's partial is 0 + contrib(first slot) +
// contrib(second slot) + ... in the view's order, each add an IEEE fp32
// add (__fadd_rn, no contraction); a row of one item writes C + partial
// (the spill) or the partial; a row of several writes its partials to a
// workspace, and the warp that finishes last (elected by a counter per
// row and tile, the only atomic) adds them in item order, 0 + p0 + p1 +
// ..., then C + that sum.  spmm_ragged.spill_rows_ordered emulates it,
// bit for bit.  There is no shared memory and no atomic on a value.
// What bounds it: the B row gathers (n * 4 bytes per live slot).  On a
// scrambled graph (the gather kind's matrices) those rows are random over
// a B far larger than the 50 MB L2, so nearly every one comes from device
// memory.

#include <cstdint>
#include <cstdio>
#include <cstring>

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int RW_WARPS = 8;  // warps a block
constexpr int RW_THREADS = RW_WARPS * 32;
// resident blocks an SM: at most 85 registers a thread (the kernels of
// 4-byte loads, which hold more addresses a row: 2 blocks and 128)
constexpr int RW_MIN_BLOCKS = 3;
constexpr int RW_ACC = 4;    // columns a lane holds: a tile is 32 * 4 columns
constexpr int RW_TILE = 32 * RW_ACC;
constexpr int RW_BATCH = 4;  // B rows a warp has in flight
constexpr int RW_COPY = 4;   // rows of a run with no slot a warp copies at once
constexpr unsigned FULL = 0xffffffffu;

// MODE 0 highest, 1 x3, 2 default
template <int MODE>
__device__ __forceinline__ float contrib(float v, float bv)
{
    const float x = __fmul_rn(v, bv);  // no FMA contraction into the add
    if constexpr (MODE == 0) return x;
    const float h = __bfloat162float(__float2bfloat16_rn(x));
    if constexpr (MODE == 2) return h;
    return __fadd_rn(h, __bfloat162float(__float2bfloat16_rn(x - h)));
}

// the cache policy of a load: B rows through L1 (read-only path); the
// workspace's partials, written by other blocks of the launch, from L2;
// C, read once, evict-first
enum { LD_NC, LD_CG, LD_CS };

template <int P, typename T>
__device__ __forceinline__ T ld(const T* p)
{
    if constexpr (P == LD_CG) return __ldcg(p);
    else if constexpr (P == LD_CS) return __ldcs(p);
    else return __ldg(p);
}

template <int V, int P = LD_NC>
__device__ __forceinline__ void load_vec(const float* p, float* x)
{
    if constexpr (V == 4) {
        const float4 t = ld<P>(reinterpret_cast<const float4*>(p));
        x[0] = t.x; x[1] = t.y; x[2] = t.z; x[3] = t.w;
    } else if constexpr (V == 2) {
        const float2 t = ld<P>(reinterpret_cast<const float2*>(p));
        x[0] = t.x; x[1] = t.y;
    } else {
        x[0] = ld<P>(p);
    }
}

// STREAM: the output, written once, evict-first (B's rows keep L2)
template <int V, bool STREAM = false>
__device__ __forceinline__ void store_vec(float* p, const float* x)
{
    if constexpr (V == 4) {
        const float4 t = make_float4(x[0], x[1], x[2], x[3]);
        if constexpr (STREAM) __stcs(reinterpret_cast<float4*>(p), t);
        else *reinterpret_cast<float4*>(p) = t;
    } else if constexpr (V == 2) {
        const float2 t = make_float2(x[0], x[1]);
        if constexpr (STREAM) __stcs(reinterpret_cast<float2*>(p), t);
        else *reinterpret_cast<float2*>(p) = t;
    } else {
        if constexpr (STREAM) __stcs(p, x[0]);
        else p[0] = x[0];
    }
}

// row r of an (M, n) matrix over the tile at column t0 (zero past n)
template <int V, int P>
__device__ __forceinline__ void load_tile(const float* __restrict__ m, int r, int n, int t0,
                                          int lane, float (&x)[RW_ACC])
{
    constexpr int NV = RW_ACC / V;
    const float* p = m + (size_t)r * (size_t)n;
#pragma unroll
    for (int j = 0; j < NV; ++j) {
        const int col = t0 + (j * 32 + lane) * V;
        if (col < n) {
            load_vec<V, P>(p + col, &x[j * V]);
        } else {
#pragma unroll
            for (int e = 0; e < V; ++e) x[j * V + e] = 0.0f;
        }
    }
}

// row r of an (M, n) matrix over the tile at column t0 := x
template <int V, bool STREAM>
__device__ __forceinline__ void store_tile(float* __restrict__ m, int r, int n, int t0,
                                           int lane, const float (&x)[RW_ACC])
{
    constexpr int NV = RW_ACC / V;
    float* p = m + (size_t)r * (size_t)n;
#pragma unroll
    for (int j = 0; j < NV; ++j) {
        const int col = t0 + (j * 32 + lane) * V;
        if (col < n) store_vec<V, STREAM>(p + col, &x[j * V]);
    }
}

// the slots [q0, q0 + 32) of an item ending at s1, one per lane
__device__ __forceinline__ void load_window(const int32_t* __restrict__ vcols,
                                            const float* __restrict__ vvals, int q0, int s1,
                                            int lane, int& col, float& val)
{
    col = 0;
    val = 0.0f;
    if (q0 + lane < s1) {
        col = __ldg(vcols + q0 + lane);
        val = __ldg(vvals + q0 + lane);
    }
}

// the item's partial over the tile at column t0: acc = 0 + contrib(s0) +
// contrib(s0 + 1) + ... + contrib(s1 - 1), elementwise, in that order.
// (col0, val0) is the window at s0, loaded by the caller.  Once the
// item's last B rows are in flight it loads what comes after: C's row
// crow over the tile into cv (crow >= 0) and the window at q_n of an item
// ending at s1_n into (col_n, val_n) (q_n >= 0)
template <int V, int MODE>
__device__ __forceinline__ void item_sum(const int32_t* __restrict__ vcols,
                                         const float* __restrict__ vvals,
                                         const float* __restrict__ b,
                                         const float* __restrict__ c, int n, int t0, int s0,
                                         int s1, int lane, int col0, float val0, int crow,
                                         int q_n, int s1_n, float (&cv)[RW_ACC], int& col_n,
                                         float& val_n, float (&acc)[RW_ACC])
{
    constexpr int NV = RW_ACC / V;
#pragma unroll
    for (int e = 0; e < RW_ACC; ++e) acc[e] = 0.0f;
    int my_col = col0;
    float my_val = val0;
    for (int q0 = s0; q0 < s1; q0 += 32) {
        const int cnt = min(32, s1 - q0);
        if (q0 != s0) load_window(vcols, vvals, q0, s1, lane, my_col, my_val);
        for (int u0 = 0; u0 < cnt; u0 += RW_BATCH) {
            float bv[RW_BATCH][RW_ACC];
#pragma unroll
            for (int u = 0; u < RW_BATCH; ++u) {
                const int k = u0 + u;
                const int col = __shfl_sync(FULL, my_col, k & 31);
                const float* brow = b + (size_t)col * (size_t)n;
#pragma unroll
                for (int j = 0; j < NV; ++j) {
                    const int cc = t0 + (j * 32 + lane) * V;
                    if (k < cnt && cc < n) {
                        load_vec<V, LD_NC>(brow + cc, &bv[u][j * V]);
                    } else {
#pragma unroll
                        for (int e = 0; e < V; ++e) bv[u][j * V + e] = 0.0f;
                    }
                }
            }
            if (q0 + u0 + RW_BATCH >= s1) {  // the last B rows are in flight
                if (crow >= 0) load_tile<V, LD_CS>(c, crow, n, t0, lane, cv);
                if (q_n >= 0) load_window(vcols, vvals, q_n, s1_n, lane, col_n, val_n);
            }
#pragma unroll
            for (int u = 0; u < RW_BATCH; ++u) {
                const int k = u0 + u;
                const float v = __shfl_sync(FULL, my_val, k & 31);
                if (k < cnt) {
#pragma unroll
                    for (int e = 0; e < RW_ACC; ++e)
                        acc[e] = __fadd_rn(acc[e], contrib<MODE>(v, bv[u][e]));
                }
            }
        }
    }
}

// HAS_C: out = C + the row's sum (the spill); otherwise the sum alone, and
// c is never read (the gather kind).  A unit of work is one item over one
// column tile; warp w of the grid's W walks the units w, w + W, w + 2 W,
// ... with unit u item u / n_tiles, tile u % n_tiles (W = step_items *
// n_tiles + step_tiles).  The next unit's descriptor is loaded when a unit
// starts; while a unit's last B rows are in flight the warp loads its C
// row and the next unit's first slots
template <bool HAS_C, int V, int MODE>
__global__ void __launch_bounds__(RW_THREADS, V == 1 ? RW_MIN_BLOCKS - 1 : RW_MIN_BLOCKS)
spill_rows_kernel(const int32_t* __restrict__ vcols, const float* __restrict__ vvals,
                  const int4* __restrict__ items, const int32_t* __restrict__ parts,
                  const float* __restrict__ c, const float* __restrict__ b,
                  float* __restrict__ out, float* __restrict__ work,
                  int32_t* __restrict__ counters, int I, int M, int n, int n_tiles,
                  int step_items, int step_tiles)
{
    const int lane = threadIdx.x & 31;
    const int unit = blockIdx.x * RW_WARPS + (threadIdx.x >> 5);
    int item = unit / n_tiles, tile = unit % n_tiles;
    if (item >= I) return;

    // the current unit: descriptor, end, first window
    int4 it = items[item];
    int s1 = items[item + 1].y;
    int col0, col_n = 0;
    float val0, val_n = 0.0f;
    load_window(vcols, vvals, it.y, s1, lane, col0, val0);

    while (true) {
        int tile_n = tile + step_tiles, item_n = item + step_items;
        if (tile_n >= n_tiles) {
            tile_n -= n_tiles;
            ++item_n;
        }
        const bool more = item_n < I;
        int4 it_n = make_int4(-1, 0, -1, -1);
        int s1_n = 0;
        if (more) {  // in flight while this unit runs
            it_n = items[item_n];
            s1_n = items[item_n + 1].y;
        }
        const int t0 = tile * RW_TILE;
        const int row = it.x, s0 = it.y, part = it.z, part0 = it.w;
        const int q_n = more ? it_n.y : -1;  // the next unit's first slot

        if (row < 0 || row >= M) {  // an item that pads a shard
            if (more) load_window(vcols, vvals, it_n.y, s1_n, lane, col_n, val_n);
        } else if (s1 == s0) {  // a run of rows with no slot: C (spill) or zero
            if (more) load_window(vcols, vvals, it_n.y, s1_n, lane, col_n, val_n);
            const int nrows = min(max(-part0, 1), M - row);
            for (int r0 = 0; r0 < nrows; r0 += RW_COPY) {
                float x[RW_COPY][RW_ACC];
#pragma unroll
                for (int u = 0; u < RW_COPY; ++u) {
                    if (HAS_C && r0 + u < nrows) {
                        load_tile<V, LD_CS>(c, row + r0 + u, n, t0, lane, x[u]);
                    } else {
#pragma unroll
                        for (int e = 0; e < RW_ACC; ++e) x[u][e] = 0.0f;
                    }
                }
#pragma unroll
                for (int u = 0; u < RW_COPY; ++u)
                    if (r0 + u < nrows)
                        store_tile<V, true>(out, row + r0 + u, n, t0, lane, x[u]);
            }
        } else if (part < 0) {  // the row's one item
            float acc[RW_ACC], cv[RW_ACC];
            item_sum<V, MODE>(vcols, vvals, b, c, n, t0, s0, s1, lane, col0, val0,
                              HAS_C ? row : -1, q_n, s1_n, cv, col_n, val_n, acc);
            if (HAS_C) {
#pragma unroll
                for (int e = 0; e < RW_ACC; ++e) acc[e] = __fadd_rn(cv[e], acc[e]);
            }
            store_tile<V, true>(out, row, n, t0, lane, acc);
        } else {  // one item of a row of several: its partial into the workspace
            float acc[RW_ACC], cv[RW_ACC];
            item_sum<V, MODE>(vcols, vvals, b, c, n, t0, s0, s1, lane, col0, val0, -1, q_n,
                              s1_n, cv, col_n, val_n, acc);
            store_tile<V, false>(work, part, n, t0, lane, acc);
            __threadfence();  // the partial is visible before the count says so
            __syncwarp();
            int32_t* count = counters + (int64_t)part0 * n_tiles + tile;
            int arrived = 0;
            if (lane == 0) arrived = atomicAdd(count, 1);
            arrived = __shfl_sync(FULL, arrived, 0);
            const int np = parts[part0];
            if (arrived == np - 1) {
                // the last of the row's items to finish this tile: its
                // partials in item order
                __threadfence();
                float tot[RW_ACC];
#pragma unroll
                for (int e = 0; e < RW_ACC; ++e) tot[e] = 0.0f;
                for (int p0 = part0; p0 < part0 + np; p0 += RW_BATCH) {
                    float w[RW_BATCH][RW_ACC];
#pragma unroll
                    for (int u = 0; u < RW_BATCH; ++u) {
                        if (p0 + u < part0 + np)
                            load_tile<V, LD_CG>(work, p0 + u, n, t0, lane, w[u]);
                    }
#pragma unroll
                    for (int u = 0; u < RW_BATCH; ++u) {
                        if (p0 + u < part0 + np) {
#pragma unroll
                            for (int e = 0; e < RW_ACC; ++e)
                                tot[e] = __fadd_rn(tot[e], w[u][e]);
                        }
                    }
                }
                if (HAS_C) {
                    float cr[RW_ACC];
                    load_tile<V, LD_CS>(c, row, n, t0, lane, cr);
#pragma unroll
                    for (int e = 0; e < RW_ACC; ++e) tot[e] = __fadd_rn(cr[e], tot[e]);
                }
                store_tile<V, true>(out, row, n, t0, lane, tot);
            }
        }

        if (!more) return;
        item = item_n;
        tile = tile_n;
        it = it_n;
        s1 = s1_n;
        col0 = col_n;
        val0 = val_n;
    }
}

// the widest load every row of b, c (when given) and out allows
int load_width(const void* c, const void* b, const void* out, int64_t n)
{
    for (int v : {4, 2}) {
        const uintptr_t align = (uintptr_t)v * sizeof(float);
        if (n % v == 0 && (uintptr_t)b % align == 0 && (uintptr_t)out % align == 0 &&
            (!c || (uintptr_t)c % align == 0))
            return v;
    }
    return 1;
}

template <bool HAS_C, int V, int MODE>
int launch_v(const void* vcols, const void* vvals, const void* items, const void* parts,
             const void* c, const void* b, void* out, void* work, void* counters,
             int64_t n_items, int64_t M, int64_t n, cudaStream_t stream)
{
    // as many blocks as the card holds at once, each warp walking its units
    if (n == 0 || n_items == 0) return (int)cudaSuccess;  // nothing to write
    int dev = 0, sms = 0, per_sm = 0;
    cudaError_t e = cudaGetDevice(&dev);
    if (e == cudaSuccess) e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (e == cudaSuccess)
        e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
            &per_sm, spill_rows_kernel<HAS_C, V, MODE>, RW_THREADS, 0);
    if (e != cudaSuccess) return (int)e;
    const int64_t n_tiles = (n + RW_TILE - 1) / RW_TILE;
    const int64_t blocks = min((n_items * n_tiles + RW_WARPS - 1) / RW_WARPS,
                               (int64_t)max(per_sm, 1) * sms);
    const int stride = (int)blocks * RW_WARPS;
    if (blocks > 0)
        spill_rows_kernel<HAS_C, V, MODE><<<(unsigned)blocks, RW_THREADS, 0, stream>>>(
            static_cast<const int32_t*>(vcols), static_cast<const float*>(vvals),
            static_cast<const int4*>(items), static_cast<const int32_t*>(parts),
            static_cast<const float*>(c), static_cast<const float*>(b),
            static_cast<float*>(out), static_cast<float*>(work),
            static_cast<int32_t*>(counters), (int)n_items, (int)M, (int)n, (int)n_tiles,
            stride / (int)n_tiles, stride % (int)n_tiles);
    return (int)cudaGetLastError();
}

template <bool HAS_C, int V>
int launch_mode(const void* vcols, const void* vvals, const void* items, const void* parts,
                const void* c, const void* b, void* out, void* work, void* counters,
                int64_t n_items, int64_t M, int64_t n, int mode, cudaStream_t stream)
{
    switch (mode) {
    case 0:
        return launch_v<HAS_C, V, 0>(vcols, vvals, items, parts, c, b, out, work, counters,
                                     n_items, M, n, stream);
    case 1:
        return launch_v<HAS_C, V, 1>(vcols, vvals, items, parts, c, b, out, work, counters,
                                     n_items, M, n, stream);
    default:
        return launch_v<HAS_C, V, 2>(vcols, vvals, items, parts, c, b, out, work, counters,
                                     n_items, M, n, stream);
    }
}

template <bool HAS_C>
int launch_rows(const void* vcols, const void* vvals, const void* items,
                const void* parts, const void* c, const void* b, void* out, void* work,
                void* counters, int64_t n_items, int64_t M, int64_t n, int64_t mode,
                void* stream)
{
    if (n_items < 0 || M < 0 || n < 0 || mode < 0 || mode > 2 || !items)
        return (int)cudaErrorInvalidValue;
    // rows, columns, slots and partials are int32 inside the kernel
    if (n_items > INT32_MAX / 2 || M > INT32_MAX || n > INT32_MAX / 4)
        return (int)cudaErrorInvalidValue;
    if ((uintptr_t)items % 16) return (int)cudaErrorMisalignedAddress;
    const cudaStream_t s = (cudaStream_t)stream;
    switch (load_width(c, b, out, n)) {
    case 4:
        return launch_mode<HAS_C, 4>(vcols, vvals, items, parts, c, b, out, work, counters,
                                  n_items, M, n, (int)mode, s);
    case 2:
        return launch_mode<HAS_C, 2>(vcols, vvals, items, parts, c, b, out, work, counters,
                                  n_items, M, n, (int)mode, s);
    default:
        return launch_mode<HAS_C, 1>(vcols, vvals, items, parts, c, b, out, work, counters,
                                  n_items, M, n, (int)mode, s);
    }
}

template <bool HAS_C, int V, int MODE>
cudaError_t kernel_resources(int& regs, int& local, int& blocks)
{
    cudaFuncAttributes attr;
    cudaError_t e = cudaFuncGetAttributes(&attr, spill_rows_kernel<HAS_C, V, MODE>);
    int per_sm = 0;
    if (e == cudaSuccess)
        e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
            &per_sm, spill_rows_kernel<HAS_C, V, MODE>, RW_THREADS, 0);
    regs = max(regs, attr.numRegs);
    local = max(local, (int)attr.localSizeBytes);
    blocks = min(blocks, per_sm);
    return e;
}

// " <name>.registers=.. <name>.local_bytes=.. <name>.blocks_per_sm=..", the
// most registers and local (spill) bytes and the fewest resident blocks per
// SM over the kernel's three modes
template <bool HAS_C, int V>
cudaError_t resources(const char* name, char* out, int len)
{
    int regs = 0, local = 0, blocks = 1 << 30;
    cudaError_t e = kernel_resources<HAS_C, V, 0>(regs, local, blocks);
    if (e == cudaSuccess) e = kernel_resources<HAS_C, V, 1>(regs, local, blocks);
    if (e == cudaSuccess) e = kernel_resources<HAS_C, V, 2>(regs, local, blocks);
    if (e != cudaSuccess) return e;
    snprintf(out, len, " %s.registers=%d %s.local_bytes=%d %s.blocks_per_sm=%d", name,
             regs, name, local, name, blocks);
    return cudaSuccess;
}

}  // namespace

extern "C" {

// vcols (Z,) int32, vvals (Z,) fp32, items (n_items + 1, 4) int32 (16-byte
// aligned), parts (P,) int32: the row-ordered view; c / out (M, n); b (rows
// > every column in vcols, n); work (P, n) fp32 and counters (P * ceil(n /
// 128),) int32, zero at the launch: the hub rows' partials and their
// arrival counts, one a row and 128-column tile; mode 0 highest, 1 x3, 2
// default.
int crp_spill_blocks(const void* vcols, const void* vvals, const void* items,
                     const void* parts, const void* c, const void* b, void* out,
                     void* work, void* counters, int64_t n_items, int64_t M, int64_t n,
                     int64_t mode, void* stream)
{
    if (!c) return (int)cudaErrorInvalidValue;
    return launch_rows<true>(vcols, vvals, items, parts, c, b, out, work, counters,
                             n_items, M, n, mode, stream);
}

// the same with no C: out (M, n) holds the packed nonzeros' product alone
int crp_gather_blocks(const void* vcols, const void* vvals, const void* items,
                      const void* parts, const void* b, void* out, void* work,
                      void* counters, int64_t n_items, int64_t M, int64_t n,
                      int64_t mode, void* stream)
{
    return launch_rows<false>(vcols, vvals, items, parts, nullptr, b, out, work,
                              counters, n_items, M, n, mode, stream);
}

// the kernels' resources as "key=value" pairs: warps a block, columns a
// tile, B rows in flight a warp, and for the spill ("c4", "c2",
// "c1": the load width) and the gather ("g4", "g2", "g1") kernels
// registers, local (spill) bytes and resident blocks per SM
int crp_spill_layout(char* out, int len)
{
    int used = snprintf(out, len, "warps=%d tile_cols=%d batch=%d", RW_WARPS, RW_TILE,
                        RW_BATCH);
    using Report = cudaError_t (*)(const char*, char*, int);
    struct Kernel { const char* name; Report report; };
    const Kernel kernels[6] = {
        {"c4", resources<true, 4>}, {"c2", resources<true, 2>}, {"c1", resources<true, 1>},
        {"g4", resources<false, 4>}, {"g2", resources<false, 2>},
        {"g1", resources<false, 1>}};
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
