// Hopper kernels of the fused halo exchange + windowed SpMM.  A launch
// covers G row groups of TM rows: on one card every group of the p row
// shards of a multi-shard engine (shard i's groups i*G .. i*G + G - 1),
// across processes (one rank a shard) the groups of this rank's shard, and
//
//     C[g*TM + r, j] = sum_{k < W} A[g, r, k] * B[ws[g] + k, j]
//
// with A the dense window panels, ws the global window starts (multiples of
// 128), B the global B, and C the (G*TM, n) output.  B is never assembled:
// it lives in p owner shards of 128-row aligned row blocks, each at its own
// address, and `rows` is a device table of pointers, one per 128-row chunk
// of B: the chunk's first row in its owner's shard, null past the matrix.
// The caller makes it from the plan's (owner, row) pairs and the owners'
// base pointers (spmm_halo.py chunk_rows).  So each row group reads its
// window straight from the owners' rows, with no receive buffer and no
// exchange copy.  On one card the owners are the shards of one stacked
// (p, max_k, n) buffer; across processes they are the ranks' own B
// buffers, mapped into every peer by CUDA IPC, so the one-card and the
// cross-process kernel are one code path.
//
// Replaces crp_tpu/kernels/spmm_halo.py _halo_kernel (wrapper
// halo_spmm_local).  On a TPU each shard is its own chip: the kernel pushes
// every owned 128-row chunk into the consumers' window buffers by remote
// DMA, gates its window reads on per-owner arrival semaphores, and starts
// with a barrier so that one exec's pushes never land in a buffer the last
// exec still reads.  Here the push becomes the read through the chunks'
// pointers.  On one card stream order (B written before the launch, C read
// after it) is the barrier.  Across processes three kinds of flag words
// in peer memory take the place of the TPU kernel's semaphores, and no
// host barrier runs between launches (panel_tiles.cuh HaloFlags; the
// caller, spmm_halo.py HaloPeers, keeps the counts):
//   * the barrier before the pushes: before a rank overwrites its B,
//     crp_halo_wait spins (one thread, on the stream) until every rank
//     that reads its rows has counted as many done launches as it has;
//   * the arrival semaphores: once its B is written, crp_halo_signal sets
//     the rank's arrive word to its load count with a system-scope release,
//     and the flagged entries (crp_halo_*_flags) wait, a block at a time,
//     for each owner's arrive word before their first read of its rows
//     (their `rows` holds each chunk's row pointer and its owner's arrive
//     word side by side, one 16-byte load);
//   * the send drain: after the launch, crp_halo_done sets the rank's done
//     word to its launch count, a trailing one-block kernel on the same
//     stream, so it follows the last read of every block.  A last-block
//     pattern (a counter every block bumps) would add an atomic and a fence
//     to each block of the shared bodies, and only a kernel after every
//     block can turn all of C into NaN when a wait gave up.
// Every wait is bounded in wall time (%globaltimer): four processes on one
// card take turns, so an owner may be descheduled while a peer spins.  A
// wait that gives up writes the rank's status word (pinned host memory,
// read by the host without a sync), every later wait of the rank gives up
// at once, crp_halo_done fills C with NaN, and the rank's flag words carry
// HALO_FAILED from then on, so that its peers give up too.  The one-card
// entries compile without the waits (FLAGS false).  At the pack's
// operating point, as the TPU kernel:
//   crp_halo_x3    <- "x3": the panels arrive as bf16 hi/lo, split once in
//                     RNE when they are packed, B split to bf16 hi/lo in
//                     registers, acc += al*bh + ah*bl + ah*bh in fp32: #4's
//                     wgmma body fed by TMA (x3_wgmma.cuh) with the chunk
//                     lookup on the producer's B copy, once a 64-row stage
//   crp_halo_bf16  <- DEFAULT: the panels' bf16 hi plane, rounded once in
//                     RNE when they are packed, and B cast to bf16 by the
//                     caller, one product: #4's one-pass wgmma body
//                     (x3_wgmma.cuh, ONE_PASS) with the same chunk lookup
//   crp_halo_f32   <- HIGHEST: 3xTF32 on the TF32 tensor cores, #4's
//                     wgmma body in its TF32X3 mode (x3_wgmma.cuh) with the
//                     same chunk lookup, once a 32-row stage: the panels'
//                     TF32 big and small planes, split once when they are
//                     packed (TMA copies bytes; the tensor cores truncate an
//                     fp32 operand), B split in registers
//   crp_halo_f64   <- fp64 panels: an entry of dd_tc.cu, #11's DMMA body
//                     on the FP64 tensor cores (the windowed walk, with the
//                     chunk lookup, CHUNKED, and the waits, FLAGS, in its
//                     producer warpgroup); its done kernel is this file's
// Each body is #4's (window.cu) with the chunk lookup on the B load, the
// per-32-row IEEE sums included.  At the p = 4 headline (4 x 214 groups,
// W = 5632, n = 256) a pass is 632 GFLOP: x3's three bf16 passes 1.92 ms
// at 989 TF/s (over 4.94 GB of hi/lo panels, 1.47 ms at 3.35 TB/s),
// DEFAULT's one pass 0.64 ms, bound by its 2.47 GB of hi panels (0.74 ms),
// HIGHEST's three TF32 passes 3.83 ms at 495 TF/s (over 9.87 GB of TF32
// planes, 2.95 ms), fp64's one pass 9.43 ms at the FP64 tensor cores' 67
// TF/s (over 9.87 GB of panels, 2.95 ms).

#include "panel_tiles.cuh"
#include "x3_wgmma.cuh"

namespace crp {

inline HaloFlags halo_flags(void* status, int64_t epoch, int64_t bound_ns)
{
    return {(unsigned long long)epoch, (unsigned long long)bound_ns,
            static_cast<unsigned long long*>(status)};
}

__global__ void halo_wait_kernel(const unsigned long long* const* done, int64_t n_readers,
                                 unsigned long long need, unsigned long long bound_ns,
                                 unsigned long long* status)
{
    for (int64_t i = 0; i < n_readers; ++i)
        if (halo_wait(done[i], need, bound_ns, status, HALO_READERS, i)) return;
}

__device__ __forceinline__ void st_release_sys(unsigned long long* p, unsigned long long v)
{
    asm volatile("st.release.sys.u64 [%0], %1;\n" :: "l"(p), "l"(v) : "memory");
}

__global__ void halo_signal_kernel(unsigned long long* word, const unsigned long long* status,
                                   unsigned long long value)
{
    // the writes of B came before this kernel on the stream; the fence and
    // the release make them visible to a peer that acquires the word
    __threadfence_system();
    st_release_sys(word, value | (ld_relaxed_sys(status) ? HALO_FAILED : 0));
}

__global__ void halo_done_kernel(unsigned long long* word, const unsigned long long* status,
                                 uint32_t* c, unsigned long long value, int64_t c_words)
{
    __shared__ int failed;
    if (threadIdx.x == 0) failed = ld_relaxed_sys(status) != 0;
    __syncthreads();
    if (threadIdx.x == 0) {
        __threadfence_system();
        st_release_sys(word, value | (failed ? HALO_FAILED : 0));
    }
    if (failed)
        for (int64_t i = threadIdx.x; i < c_words; i += blockDim.x) c[i] = 0xffffffffu;
}

}  // namespace crp

extern "C" {

// rows16: every chunk pointer is on 16 bytes (16-byte B copies where n
// allows them)
int crp_halo_x3(const void* rows, const void* ws, const void* ah, const void* al, void* c,
                int64_t G, int64_t TM, int64_t W, int64_t n, int64_t rows16, void* stream)
{
    return crp::launch_wgmma<crp::WgMode::SPLIT_B, true>(ws, ah, al, rows, nullptr, c, G, TM,
                                                          W, n, stream, rows, nullptr,
                                                          rows16 != 0);
}

// the wgmma body's rings and resources, crp_halo_x3's, crp_halo_bf16's and
// crp_halo_f32's, each with its flagged twin (crp::x3_layout)
int crp_x3_layout(char* out, int len)
{
    return crp::x3_layout<false, true, false, true>(out, len);
}

int crp_halo_bf16(const void* rows, const void* ws, const void* ah, void* c, int64_t G,
                  int64_t TM, int64_t W, int64_t n, int64_t rows16, void* stream)
{
    return crp::launch_wgmma<crp::WgMode::ONE_PASS, true>(ws, ah, nullptr, rows, nullptr, c,
                                                          G, TM, W, n, stream, rows, nullptr,
                                                          rows16 != 0);
}

// big, small: the (G, TM, W) TF32 planes (see x3_wgmma.cuh)
int crp_halo_f32(const void* rows, const void* ws, const void* big, const void* small,
                 void* c, int64_t G, int64_t TM, int64_t W, int64_t n, int64_t rows16,
                 void* stream)
{
    return crp::launch_wgmma<crp::WgMode::TF32X3, true>(ws, big, small, rows, nullptr, c, G,
                                                         TM, W, n, stream, rows, nullptr,
                                                         rows16 != 0);
}

// #12 across processes, the same three entries with the waits (see above):
// rows the chunks' (row pointer, arrive word) pairs (16-byte aligned),
// status this rank's status word, epoch the loads every owner must have
// made, bound_ns the longest a wait spins; rows16 says whether every row
// pointer is on 16 bytes
int crp_halo_x3_flags(const void* rows, const void* ws, const void* ah, const void* al,
                      void* c, void* status, int64_t G, int64_t TM, int64_t W, int64_t n,
                      int64_t rows16, int64_t epoch, int64_t bound_ns, void* stream)
{
    if ((uintptr_t)rows % 16) return (int)cudaErrorMisalignedAddress;
    return crp::launch_wgmma<crp::WgMode::SPLIT_B, true, false, true>(
        ws, ah, al, rows, nullptr, c, G, TM, W, n, stream, rows, nullptr, rows16 != 0,
        crp::halo_flags(status, epoch, bound_ns));
}

int crp_halo_bf16_flags(const void* rows, const void* ws, const void* ah, void* c,
                        void* status, int64_t G, int64_t TM, int64_t W, int64_t n,
                        int64_t rows16, int64_t epoch, int64_t bound_ns, void* stream)
{
    if ((uintptr_t)rows % 16) return (int)cudaErrorMisalignedAddress;
    return crp::launch_wgmma<crp::WgMode::ONE_PASS, true, false, true>(
        ws, ah, nullptr, rows, nullptr, c, G, TM, W, n, stream, rows, nullptr, rows16 != 0,
        crp::halo_flags(status, epoch, bound_ns));
}

int crp_halo_f32_flags(const void* rows, const void* ws, const void* big,
                       const void* small, void* c, void* status, int64_t G, int64_t TM,
                       int64_t W, int64_t n, int64_t rows16, int64_t epoch,
                       int64_t bound_ns, void* stream)
{
    if ((uintptr_t)rows % 16) return (int)cudaErrorMisalignedAddress;
    return crp::launch_wgmma<crp::WgMode::TF32X3, true, false, true>(
        ws, big, small, rows, nullptr, c, G, TM, W, n, stream, rows, nullptr, rows16 != 0,
        crp::halo_flags(status, epoch, bound_ns));
}

// Before this rank overwrites its B: one thread waits until each of the
// n_readers done words (done, a table of their addresses) has reached need
int crp_halo_wait(const void* done, void* status, int64_t n_readers, int64_t need,
                  int64_t bound_ns, void* stream)
{
    if (n_readers < 0 || need < 0 || bound_ns < 0) return (int)cudaErrorInvalidValue;
    crp::halo_wait_kernel<<<1, 1, 0, (cudaStream_t)stream>>>(
        static_cast<const unsigned long long* const*>(done), n_readers,
        (unsigned long long)need, (unsigned long long)bound_ns,
        static_cast<unsigned long long*>(status));
    return (int)cudaGetLastError();
}

// Once this rank's B is written: its arrive word := value (release, system
// scope), with HALO_FAILED once its status word is set
int crp_halo_signal(void* word, const void* status, int64_t value, void* stream)
{
    if (value < 0) return (int)cudaErrorInvalidValue;
    crp::halo_signal_kernel<<<1, 1, 0, (cudaStream_t)stream>>>(
        static_cast<unsigned long long*>(word), static_cast<const unsigned long long*>(status),
        (unsigned long long)value);
    return (int)cudaGetLastError();
}

// After a launch: its done word := value (release, system scope); where the
// status word is set, every byte of C (c_bytes, a multiple of 4) := 0xff,
// a NaN in fp32 and fp64, and the word carries HALO_FAILED
int crp_halo_done(void* word, const void* status, void* c, int64_t value, int64_t c_bytes,
                  void* stream)
{
    if (value < 0 || c_bytes < 0 || c_bytes % 4) return (int)cudaErrorInvalidValue;
    crp::halo_done_kernel<<<1, 1024, 0, (cudaStream_t)stream>>>(
        static_cast<unsigned long long*>(word), static_cast<const unsigned long long*>(status),
        static_cast<uint32_t*>(c), (unsigned long long)value, c_bytes / 4);
    return (int)cudaGetLastError();
}

const char* crp_error_string(int code)
{
    return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
