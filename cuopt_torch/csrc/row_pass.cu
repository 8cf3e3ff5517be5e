// Fused PDHG row pass over BlockBandOp row slabs, for Hopper (sm_90a).
//
// One pass over the dense 128-row slabs of A computes, for every tile t
// whose column window starts at s_t (a multiple of 128):
//
//   ax_new  = slab_t . x[s_t : s_t+W] + ax_spill          (Ax)
//   ax~     = 2 ax_new - ax_old
//   y_new   = y + sigma (lc - ax~)  if that is > 0,
//             y + sigma (uc - ax~)  else if that is < 0,
//             0                     otherwise              (dual prox)
//   part_t  = y_new^T . slab_t   over the tile's window    (A^T y)
//
// lc and uc arrive masked to -/+ sentinel where the bound is infinite.
//
// Replaces the two Pallas TPU kernels of cuopt_tpu/lp/pdhg_pallas.py:
//   row_pass_atomic    <- _kernel (launched by _row_pass): the TPU carries
//                         the A^T y sum in VMEM from one sequential grid
//                         step to the next; GPU blocks run in parallel and
//                         in no order, and neighbouring windows overlap on
//                         columns, so each tile adds its part into a zeroed
//                         aty with atomicAdd.
//   row_pass_partials  <- _kernel_stream (launched by _row_pass_stream) and
//                         the segment sum after it: each tile writes its
//                         part to a (T, W) buffer and counts itself into
//                         every 128-column block of its window; the tile
//                         that completes a column block's count sums that
//                         block's parts in a fixed (tile-ascending) order,
//                         so the result has the same bits on every run.
//
// Bound: the pass must read the slabs once, T*128*W*4 bytes (76.9 MB per
// call for the 50k staircase, 461 MB at 300k), plus O(rows + cols) bytes
// of vectors, against 4*T*128*W flops: about 0.5 flop per byte, so it is
// memory-bound (3.35 TB/s on an H100 SXM: about 23 us at 50k). Tensor
// cores are not used: this is a matrix-vector product at 0.5 flop per
// byte, wgmma needs N >= 8 (arithmetic multiplied for nothing on a
// byte-bound kernel), and TF32 would break the 1e-5 parity with the
// float32 plain version.
//
// Three bodies, chosen by W alone (never on a failure). The first two read
// each slab byte from HBM once: y_new[r] depends only on row r, so the
// transpose is summed row by row as soon as the row's dot product is
// known. A producer warp streams the slab through a ring of shared-memory
// stages (one contiguous block of rows each) with 1-D cp.async.bulk
// copies that complete on "full" mbarriers; the 8 consumer warps release
// a stage on its "empty" mbarrier once they are done with it.
//
// One-pass body (W <= W_ONE_PASS = 1024), one thread block per tile:
//   - stages of 8 rows, up to 64 KB of ring per block;
//   - each consumer warp takes one row per stage. Lane l holds the columns
//     4l + 128k (k < W/128) as float4: the x window (loaded once per tile,
//     zero past n_cols), the row's values and its accumulator. The warp
//     multiplies, reduces with __shfl_xor_sync (every lane ends with the
//     same ax), applies the prox on every lane and adds y_new * row into
//     its accumulator;
//   - at the end of the tile the 8 warps' accumulators are summed through
//     shared memory in warp order.
//   Each lane holds 3 * W/32 floats in registers, templated on W/128; at
//   W=384 a block holds 60 KB of ring and 64 registers a thread, so three
//   are resident per SM and the 50k staircase's 391 tiles run in one wave.
//
// Column-split body (W_ONE_PASS < W <= W_COLUMN_SPLIT = 8192): a row is
// too wide for one warp's registers (396 floats a lane at W=4224), so the
// window's columns, not its rows, are split across the 256 consumer
// threads: thread i owns the float4 columns i + 256k (k < NQ = W/1024
// rounded up), its x values and its A^T y accumulator in registers.
//   - stages of CS_ROWS = 2 rows (33.8 KB at W=4224), a ring of about
//     100 KB, so two blocks are resident per SM up to W = 6144 (above,
//     the accumulators need more registers than two blocks leave);
//   - per stage: every warp reduces its share of each row's dot product
//     with xor shuffles and writes it to shared memory; after a barrier
//     of the consumer warps, every thread sums a row's 8 warp shares in
//     warp order and applies the prox (all threads get the same bits), then
//     adds y_new * row from the stage still in shared memory. The shares
//     are double-buffered by stage, so one barrier per stage suffices;
//   - the threads' columns are disjoint: no reduction across warps at the
//     end of the tile.
//
// Two-read body (W > W_COLUMN_SPLIT, wider than any window the repo's
// generators build at the sizes the tests and chip_smoke.py use): phase 1
// streams each slab row against the x window staged in 2048-column
// chunks, phase 2 applies the prox, phase 3 re-reads the slab for the
// transpose, column-quad-major. That second read mostly comes from HBM.
//
// Partials mode, in every body: at the end of its tile a block writes its
// parts and adds one to the counter of each column block its window
// touches. The block that brings a column block's count to its number of
// contributors sums that block's parts in the plan's list order
// (cb_offsets / cb_rows, tile-ascending), writes aty and sets the counter
// back to 0, so the next launch needs no memset (and a CUDA graph can
// replay the launch). The counters are the plan's: two passes over one
// operator must not run at the same time. The tail's cost is latency:
// a block holds its slot through a few round trips to L2 (the count,
// then the parts of the column blocks it completes).
//
// Interface: plain C, loaded with ctypes. Every pointer is device memory
// on the current device, float32 or int32, contiguous; the kernels launch
// on `stream`, allocate nothing and do not synchronise. Each entry point
// returns the cudaError_t of its launch (0 on success).

#include <cuda_runtime.h>
#include <stddef.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int TILE = 128;                    // rows per slab (BlockBandOp.tile)
constexpr int CWARPS = 8;                    // consumer warps
constexpr int CTHREADS = CWARPS * 32;
constexpr int PIPE_THREADS = CTHREADS + 32;  // + the producer warp
constexpr int MAX_STAGES = 8;

// ---------------------------------------------------------- one-pass body
constexpr int W_ONE_PASS = 1024;
constexpr int STAGE_ROWS = CWARPS;           // slab rows per ring stage
constexpr int RING_BYTES = 64 * 1024;        // slab bytes in flight per block

__host__ __device__ constexpr int stage_bytes(int kq)
{
    return STAGE_ROWS * TILE * kq * 4;
}
__host__ __device__ constexpr int ring_stages(int kq)
{
    return RING_BYTES / stage_bytes(kq) < 2 ? 2
         : RING_BYTES / stage_bytes(kq) > MAX_STAGES ? MAX_STAGES
         : RING_BYTES / stage_bytes(kq);
}
__host__ __device__ constexpr int ring_bytes(int kq)
{
    return ring_stages(kq) * stage_bytes(kq);
}

// ------------------------------------------------------ column-split body
constexpr int W_COLUMN_SPLIT = 8192;
constexpr int CS_ROWS = 2;                   // slab rows per ring stage
constexpr int CS_RING_BYTES = 104 * 1024;    // two blocks per SM at W=4224
constexpr int CS_MAX_RING = 2 * CS_ROWS * W_COLUMN_SPLIT * 4;  // 128 KB

__host__ __device__ inline int cs_stages(int W)
{
    const int n = CS_RING_BYTES / (CS_ROWS * W * 4);
    return n < 2 ? 2 : (n > MAX_STAGES ? MAX_STAGES : n);
}
__host__ __device__ inline int cs_ring_bytes(int W)
{
    return cs_stages(W) * CS_ROWS * W * 4;
}

struct RowPassArgs {
    const float* slabs;
    const int* starts;
    int W, n_rows, n_cols;
    const float *x, *ax_old, *ax_spill, *y, *lc, *uc, *sigma;
    float *ax_out, *y_out;
    float* aty;                              // (n_cols,)
    // partials mode only
    float* parts;                            // (T, W)
    const int *cb_offsets, *cb_rows;
    int* counters;                           // (n_blocks,), zero between launches
    int n_blocks;
};

// Launches of each mode (0 atomic, 1 partials) that have run on this
// device: thread 0 of block 0 counts each launch as it runs, so a launch
// that a CUDA graph recorded counts at each replay that runs it and not
// at the capture. Read and zeroed by row_pass_launches.
__device__ unsigned long long g_launches[2];

template <bool PARTIALS>
__device__ __forceinline__ void count_launch()
{
    if (blockIdx.x == 0 && threadIdx.x == 0)
        atomicAdd(&g_launches[PARTIALS ? 1 : 0], 1ull);
}

__device__ __forceinline__ uint32_t smem_addr(const void* p)
{
    return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count)
{
    asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;"
                 :: "r"(smem_addr(bar)), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar)
{
    asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];"
                 :: "r"(smem_addr(bar)) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes)
{
    asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;"
                 :: "r"(smem_addr(bar)), "r"(bytes) : "memory");
}

// Returns once the phase of parity `parity` has completed.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity)
{
    uint32_t done;
    do {
        asm volatile(
            "{\n\t.reg .pred p;\n\t"
            "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n\t"
            "selp.u32 %0, 1, 0, p;\n\t}"
            : "=r"(done) : "r"(smem_addr(bar)), "r"(parity) : "memory");
    } while (!done);
}

// `bytes` contiguous bytes from global to shared memory, completing on bar.
__device__ __forceinline__ void bulk_load(void* dst, const void* src,
                                          uint32_t bytes, uint64_t* bar)
{
    asm volatile(
        "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
        "[%0], [%1], %2, [%3];"
        :: "r"(smem_addr(dst)), "l"(src), "r"(bytes), "r"(smem_addr(bar))
        : "memory");
}

// *p += v at GPU scope as a release (this thread's and, through a CTA
// barrier before it, its block's earlier writes are visible first) and an
// acquire (what the earlier releases on *p made visible is visible after).
__device__ __forceinline__ int atomic_add_acq_rel(int* p, int v)
{
    int old;
    asm volatile("atom.acq_rel.gpu.global.add.s32 %0, [%1], %2;"
                 : "=r"(old) : "l"(p), "r"(v) : "memory");
    return old;
}

// Barrier of the 256 consumer threads (the producer warp has left; the
// two-read body has exactly these 256 threads).
__device__ __forceinline__ void consumer_sync()
{
    asm volatile("bar.sync 1, %0;" :: "n"(CTHREADS) : "memory");
}

// Thread 0 initialises `n` full/empty mbarrier pairs; the whole block then
// syncs.
__device__ __forceinline__ void ring_init(uint64_t* full, uint64_t* empty,
                                          int n)
{
    if (threadIdx.x == 0) {
        for (int i = 0; i < n; ++i) {
            mbar_init(&full[i], 1);
            mbar_init(&empty[i], CWARPS);
        }
        asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
    }
    __syncthreads();
}

// The producer thread: the tile's `chunks` stages of `bytes` each, through
// a ring of `n_stages`.
__device__ __forceinline__ void ring_produce(float* ring, const float* slab,
                                             int chunks, int n_stages,
                                             uint32_t bytes, uint64_t* full,
                                             uint64_t* empty)
{
    const int floats = bytes / 4;
    int stage = 0;
    uint32_t phase = 0;
    for (int j = 0; j < chunks; ++j) {
        if (j >= n_stages) mbar_wait(&empty[stage], phase ^ 1);
        mbar_expect_tx(&full[stage], bytes);
        bulk_load(ring + stage * floats, slab + (size_t)j * floats, bytes,
                  &full[stage]);
        if (++stage == n_stages) {
            stage = 0;
            phase ^= 1;
        }
    }
}

// The tile's row vectors (zero past n_rows) into shared memory.
__device__ __forceinline__ void load_row_vectors(
    const RowPassArgs& p, long long row0, int tid, float* v_ax_old,
    float* v_y, float* v_lc, float* v_uc, float* v_spill)
{
    for (int i = tid; i < TILE; i += CTHREADS) {
        const long long row = row0 + i;
        const bool in = row < p.n_rows;
        v_ax_old[i] = in ? p.ax_old[row] : 0.f;
        v_y[i] = in ? p.y[row] : 0.f;
        v_lc[i] = in ? p.lc[row] : 0.f;
        v_uc[i] = in ? p.uc[row] : 0.f;
        v_spill[i] = in && p.ax_spill ? p.ax_spill[row] : 0.f;
    }
}

// x[c..c+3], zero past n_cols (windows may run past it).
__device__ __forceinline__ float4 x_quad(const RowPassArgs& p, int c)
{
    return make_float4(c < p.n_cols ? p.x[c] : 0.f,
                       c + 1 < p.n_cols ? p.x[c + 1] : 0.f,
                       c + 2 < p.n_cols ? p.x[c + 2] : 0.f,
                       c + 3 < p.n_cols ? p.x[c + 3] : 0.f);
}

// The tile's ax_new and y_new from shared memory, by the consumer threads
// above the first 128 (the others count the tile into its column blocks).
__device__ __forceinline__ void store_rows(const RowPassArgs& p,
                                           long long row0, int tid,
                                           const float* o_ax,
                                           const float* o_y)
{
    const int i = tid - (CTHREADS - TILE);
    if (i >= 0 && row0 + i < p.n_rows) {
        p.ax_out[row0 + i] = o_ax[i];
        p.y_out[row0 + i] = o_y[i];
    }
}

__device__ __forceinline__ float dual_prox(float ax_new, float ax_old,
                                           float y, float lc, float uc,
                                           float sg)
{
    const float ax_tilde = 2.f * ax_new - ax_old;
    const float y_low = y + sg * (lc - ax_tilde);
    const float y_high = y + sg * (uc - ax_tilde);
    return y_low > 0.f ? y_low : (y_high < 0.f ? y_high : 0.f);
}

__device__ __forceinline__ void atomic_add4(const RowPassArgs& p, int col,
                                            float4 v)
{
    if (col < p.n_cols) atomicAdd(p.aty + col, v.x);
    if (col + 1 < p.n_cols) atomicAdd(p.aty + col + 1, v.y);
    if (col + 2 < p.n_cols) atomicAdd(p.aty + col + 2, v.z);
    if (col + 3 < p.n_cols) atomicAdd(p.aty + col + 3, v.w);
}

// Partials mode. Thread i < FOLD_ROUND of a tile (window start s) counts
// the tile into column block s/128 + b0 + i; its FoldSlot holds that
// block's list bounds and first FOLD_ROWS listed rows, loaded for round 0
// at the start of the tile so that the tail waits on no list load.
constexpr int FOLD_ROUND = 64;               // column blocks counted per round
constexpr int FOLD_ROWS = 4;                 // listed rows held per slot

struct FoldSlot {
    int off, end;                            // off == end: nothing to count
    int rows[FOLD_ROWS];
};

__device__ __forceinline__ FoldSlot fold_slot(const RowPassArgs& p, int s,
                                              int b0, int tid)
{
    FoldSlot f{0, 0, {0, 0, 0, 0}};
    const int cb = s / TILE + b0 + tid;
    if (tid < FOLD_ROUND && b0 + tid < p.W / TILE && cb < p.n_blocks) {
        f.off = p.cb_offsets[cb];
        f.end = p.cb_offsets[cb + 1];
#pragma unroll
        for (int u = 0; u < FOLD_ROWS; ++u)
            f.rows[u] = f.off + u < f.end ? p.cb_rows[f.off + u] : 0;
    }
    return f;
}

// End of a tile, run by the 256 consumer threads once each has written
// its parts; `first` is the thread's slot of round 0. The count is a
// release of the block's parts (the barrier, then the acq_rel atomic, as
// CUTLASS's semaphore releases after __syncthreads) and, for the tile that
// completes a column block, an acquire of the others' parts. For each
// column block the tile completes, one warp sums that block's parts in
// list order (cb_offsets[cb] .. cb_offsets[cb+1], as the plain version
// does), lane l on columns 4l..4l+3, writes aty and resets the counter.
__device__ __forceinline__ void fold_column_blocks(const RowPassArgs& p,
                                                   int s, int tid,
                                                   const FoldSlot& first)
{
    __shared__ int n_last;
    __shared__ int last_cb[FOLD_ROUND], last_off[FOLD_ROUND],
        last_end[FOLD_ROUND], last_rows[FOLD_ROUND][FOLD_ROWS];
    const int WB = p.W / TILE;
    const int lane = tid & 31;
    const int warp = tid >> 5;
    for (int b0 = 0; b0 < WB; b0 += FOLD_ROUND) {
        const FoldSlot f = b0 == 0 ? first : fold_slot(p, s, b0, tid);
        if (tid == 0) n_last = 0;
        consumer_sync();                     // the parts, then the counts
        if (f.end > f.off) {
            const int cb = s / TILE + b0 + tid;
            if (atomic_add_acq_rel(p.counters + cb, 1) ==
                f.end - f.off - 1) {
                const int i = atomicAdd(&n_last, 1);
                last_cb[i] = cb;
                last_off[i] = f.off;
                last_end[i] = f.end;
#pragma unroll
                for (int u = 0; u < FOLD_ROWS; ++u)
                    last_rows[i][u] = f.rows[u];
            }
        }
        consumer_sync();
        for (int i = warp; i < n_last; i += CWARPS) {
            const int c = last_cb[i];
            const int off = last_off[i];
            const int end = last_end[i];
            float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
            for (int e = off; e < end; e += FOLD_ROWS) {
                float4 v[FOLD_ROWS];
#pragma unroll
                for (int u = 0; u < FOLD_ROWS; ++u) {
                    if (e + u < end) {
                        const int r = e == off ? last_rows[i][u]
                                               : p.cb_rows[e + u];
                        v[u] = __ldcg(reinterpret_cast<const float4*>(
                            p.parts + (size_t)r * TILE) + lane);
                    }
                }
#pragma unroll
                for (int u = 0; u < FOLD_ROWS; ++u) {
                    if (e + u < end) {
                        acc.x += v[u].x;
                        acc.y += v[u].y;
                        acc.z += v[u].z;
                        acc.w += v[u].w;
                    }
                }
            }
            const int col = c * TILE + 4 * lane;
            if (col + 3 < p.n_cols) {
                *reinterpret_cast<float4*>(p.aty + col) = acc;
            } else {
                if (col < p.n_cols) p.aty[col] = acc.x;
                if (col + 1 < p.n_cols) p.aty[col + 1] = acc.y;
                if (col + 2 < p.n_cols) p.aty[col + 2] = acc.z;
            }
            if (lane == 0) p.counters[c] = 0;
        }
        if (b0 + FOLD_ROUND < WB) consumer_sync();  // the lists, reused
    }
}

template <bool PARTIALS, int KQ>
__global__ void __launch_bounds__(PIPE_THREADS,
                                  (KQ <= 3 ? 3 : (KQ <= 5 ? 2 : 1)))
row_pass_one_pass(const RowPassArgs p)
{
    constexpr int W = TILE * KQ;
    constexpr int S = ring_stages(KQ);
    constexpr int STAGE_FLOATS = STAGE_ROWS * W;
    constexpr int CHUNKS = TILE / STAGE_ROWS;  // stages per tile
    extern __shared__ __align__(128) float ring[];  // S stages, then the sums
    __shared__ __align__(8) uint64_t full[S], empty[S];
    __shared__ float v_ax_old[TILE], v_y[TILE], v_lc[TILE], v_uc[TILE],
        v_spill[TILE], o_ax[TILE], o_y[TILE];

    const int t = blockIdx.x;
    const int tid = threadIdx.x;
    const int lane = tid & 31;
    const int warp = tid >> 5;
    count_launch<PARTIALS>();

    ring_init(full, empty, S);
    if (warp == CWARPS) {  // ---- producer: one elected thread
        if (lane == 0)
            ring_produce(ring, p.slabs + (size_t)t * TILE * W, CHUNKS, S,
                         stage_bytes(KQ), full, empty);
        return;
    }

    // ---- consumers: the tile's row vectors and the x window, while the
    // first stages are in flight
    const long long row0 = (long long)t * TILE;
    load_row_vectors(p, row0, tid, v_ax_old, v_y, v_lc, v_uc, v_spill);
    const int s = p.starts[t];
    FoldSlot fold{};
    if constexpr (PARTIALS) fold = fold_slot(p, s, 0, tid);
    float4 xv[KQ], acc[KQ];
#pragma unroll
    for (int k = 0; k < KQ; ++k) {
        xv[k] = x_quad(p, s + TILE * k + 4 * lane);
        acc[k] = make_float4(0.f, 0.f, 0.f, 0.f);
    }
    const float sg = *p.sigma;
    consumer_sync();

    int stage = 0;
    uint32_t phase = 0;
    for (int j = 0; j < CHUNKS; ++j) {
        mbar_wait(&full[stage], phase);
        const float4* src = reinterpret_cast<const float4*>(
            ring + stage * STAGE_FLOATS + warp * W) + lane;
        float4 a[KQ];
#pragma unroll
        for (int k = 0; k < KQ; ++k) a[k] = src[32 * k];
        __syncwarp();
        if (lane == 0) mbar_arrive(&empty[stage]);  // values are in registers
        if (++stage == S) {
            stage = 0;
            phase ^= 1;
        }

        float d = 0.f;
#pragma unroll
        for (int k = 0; k < KQ; ++k) {
            d = fmaf(a[k].x, xv[k].x, d);
            d = fmaf(a[k].y, xv[k].y, d);
            d = fmaf(a[k].z, xv[k].z, d);
            d = fmaf(a[k].w, xv[k].w, d);
        }
#pragma unroll
        for (int off = 16; off > 0; off >>= 1)
            d += __shfl_xor_sync(0xffffffffu, d, off);

        const int r = j * STAGE_ROWS + warp;
        float y_new = 0.f;  // rows past n_rows contribute nothing
        if (row0 + r < p.n_rows) {
            const float ax_new = d + v_spill[r];
            y_new = dual_prox(ax_new, v_ax_old[r], v_y[r], v_lc[r], v_uc[r],
                              sg);
            if (lane == 0) {
                o_ax[r] = ax_new;
                o_y[r] = y_new;
            }
        }
#pragma unroll
        for (int k = 0; k < KQ; ++k) {
            acc[k].x = fmaf(y_new, a[k].x, acc[k].x);
            acc[k].y = fmaf(y_new, a[k].y, acc[k].y);
            acc[k].z = fmaf(y_new, a[k].z, acc[k].z);
            acc[k].w = fmaf(y_new, a[k].w, acc[k].w);
        }
    }

    // ---- end of tile: every stage has landed and been read, so the ring
    // holds the warps' sums, added in warp order
    consumer_sync();
    store_rows(p, row0, tid, o_ax, o_y);
    float4* red = reinterpret_cast<float4*>(ring);
#pragma unroll
    for (int k = 0; k < KQ; ++k) red[warp * (W / 4) + 32 * k + lane] = acc[k];
    consumer_sync();
    if (tid < W / 4) {
        float4 v = red[tid];
#pragma unroll
        for (int w = 1; w < CWARPS; ++w) {
            const float4 o = red[w * (W / 4) + tid];
            v.x += o.x;
            v.y += o.y;
            v.z += o.z;
            v.w += o.w;
        }
        if (PARTIALS)
            reinterpret_cast<float4*>(p.parts + (size_t)t * W)[tid] = v;
        else
            atomic_add4(p, s + 4 * tid, v);
    }
    if constexpr (PARTIALS) fold_column_blocks(p, s, tid, fold);
}

template <bool PARTIALS, int NQ>
__global__ void __launch_bounds__(PIPE_THREADS, (NQ <= 6 ? 2 : 1))
row_pass_column_split(const RowPassArgs p)
{
    constexpr int CHUNKS = TILE / CS_ROWS;   // stages per tile
    extern __shared__ __align__(128) float ring[];
    __shared__ __align__(8) uint64_t full[MAX_STAGES], empty[MAX_STAGES];
    __shared__ float v_ax_old[TILE], v_y[TILE], v_lc[TILE], v_uc[TILE],
        v_spill[TILE], o_ax[TILE], o_y[TILE];
    __shared__ float shares[2][CS_ROWS][CWARPS];  // double-buffered by stage

    const int W = p.W;
    const int W4 = W / 4;
    const int S = cs_stages(W);
    const int stage_floats = CS_ROWS * W;
    const int t = blockIdx.x;
    const int tid = threadIdx.x;
    const int lane = tid & 31;
    const int warp = tid >> 5;
    count_launch<PARTIALS>();

    ring_init(full, empty, S);
    if (warp == CWARPS) {  // ---- producer: one elected thread
        if (lane == 0)
            ring_produce(ring, p.slabs + (size_t)t * TILE * W, CHUNKS, S,
                         CS_ROWS * W * 4, full, empty);
        return;
    }

    // ---- consumers: thread tid owns the float4 columns tid + 256k; the
    // last k holds a column only where tid + 256k < W/4
    const long long row0 = (long long)t * TILE;
    load_row_vectors(p, row0, tid, v_ax_old, v_y, v_lc, v_uc, v_spill);
    const int s = p.starts[t];
    FoldSlot fold{};
    if constexpr (PARTIALS) fold = fold_slot(p, s, 0, tid);
    const bool has_last = tid + CTHREADS * (NQ - 1) < W4;
    float4 xv[NQ], acc[NQ];
#pragma unroll
    for (int k = 0; k < NQ; ++k) {
        const bool own = k < NQ - 1 || has_last;
        xv[k] = own ? x_quad(p, s + 4 * (tid + CTHREADS * k))
                    : make_float4(0.f, 0.f, 0.f, 0.f);
        acc[k] = make_float4(0.f, 0.f, 0.f, 0.f);
    }
    const float sg = *p.sigma;
    consumer_sync();

    int stage = 0;
    uint32_t phase = 0;
    for (int j = 0; j < CHUNKS; ++j) {
        const int buf = j & 1;
        mbar_wait(&full[stage], phase);
        const float4* st = reinterpret_cast<const float4*>(
            ring + stage * stage_floats) + tid;
        // 1. this warp's share of each row's dot product
#pragma unroll
        for (int r = 0; r < CS_ROWS; ++r) {
            float d = 0.f;
#pragma unroll
            for (int k = 0; k < NQ; ++k) {
                if (k < NQ - 1 || has_last) {
                    const float4 a = st[r * W4 + CTHREADS * k];
                    d = fmaf(a.x, xv[k].x, d);
                    d = fmaf(a.y, xv[k].y, d);
                    d = fmaf(a.z, xv[k].z, d);
                    d = fmaf(a.w, xv[k].w, d);
                }
            }
#pragma unroll
            for (int off = 16; off > 0; off >>= 1)
                d += __shfl_xor_sync(0xffffffffu, d, off);
            if (lane == 0) shares[buf][r][warp] = d;
        }
        consumer_sync();
        // 2. every thread: the rows' ax in warp order, then the prox
        float y_new[CS_ROWS];
#pragma unroll
        for (int r = 0; r < CS_ROWS; ++r) {
            const int i = j * CS_ROWS + r;
            float d = shares[buf][r][0];
#pragma unroll
            for (int w = 1; w < CWARPS; ++w) d += shares[buf][r][w];
            y_new[r] = 0.f;  // rows past n_rows contribute nothing
            if (row0 + i < p.n_rows) {
                const float ax_new = d + v_spill[i];
                y_new[r] = dual_prox(ax_new, v_ax_old[i], v_y[i], v_lc[i],
                                     v_uc[i], sg);
                if (tid == 0) {
                    o_ax[i] = ax_new;
                    o_y[i] = y_new[r];
                }
            }
        }
        // 3. y_new * row into the accumulators, from the stage
#pragma unroll
        for (int r = 0; r < CS_ROWS; ++r) {
#pragma unroll
            for (int k = 0; k < NQ; ++k) {
                if (k < NQ - 1 || has_last) {
                    const float4 a = st[r * W4 + CTHREADS * k];
                    acc[k].x = fmaf(y_new[r], a.x, acc[k].x);
                    acc[k].y = fmaf(y_new[r], a.y, acc[k].y);
                    acc[k].z = fmaf(y_new[r], a.z, acc[k].z);
                    acc[k].w = fmaf(y_new[r], a.w, acc[k].w);
                }
            }
        }
        __syncwarp();
        if (lane == 0) mbar_arrive(&empty[stage]);  // 4. release the stage
        if (++stage == S) {
            stage = 0;
            phase ^= 1;
        }
    }

    // ---- end of tile: the threads' columns are disjoint
#pragma unroll
    for (int k = 0; k < NQ; ++k) {
        if (k < NQ - 1 || has_last) {
            const int q = tid + CTHREADS * k;
            if (PARTIALS)
                reinterpret_cast<float4*>(p.parts + (size_t)t * W)[q] = acc[k];
            else
                atomic_add4(p, s + 4 * q, acc[k]);
        }
    }
    consumer_sync();  // o_ax, o_y are complete
    store_rows(p, row0, tid, o_ax, o_y);
    if constexpr (PARTIALS) fold_column_blocks(p, s, tid, fold);
}

// ------------------------------------------ two-read body (W > W_COLUMN_SPLIT)
constexpr int ROWS_PER_WARP = TILE / CWARPS;  // 16
constexpr int XCHUNK = 2048;                  // x-window columns staged per pass

template <bool PARTIALS>
__global__ void __launch_bounds__(CTHREADS)
row_pass_two_read(const RowPassArgs p)
{
    __shared__ __align__(16) float xs[XCHUNK];
    __shared__ float ys[TILE];
    __shared__ float4 red[CTHREADS];

    const int t = blockIdx.x;
    const int tid = threadIdx.x;
    const int lane = tid & 31;
    const int warp = tid >> 5;
    const int W = p.W;
    const float* slab = p.slabs + (size_t)t * TILE * W;
    const int s = p.starts[t];
    const int W4 = W >> 2;
    // the count first in the partials mode and last in the atomic mode:
    // there ptxas gives each mode the registers it takes without the
    // count (80 and 64 a thread at W = 8320, with no spill)
    if constexpr (PARTIALS) count_launch<PARTIALS>();

    // ---- phase 1: ax for the tile's rows (warp w owns rows 16w..16w+15)
    float acc[ROWS_PER_WARP];
#pragma unroll
    for (int i = 0; i < ROWS_PER_WARP; ++i) acc[i] = 0.f;
    for (int c0 = 0; c0 < W; c0 += XCHUNK) {
        const int cw = min(XCHUNK, W - c0);
        __syncthreads();
        for (int i = tid; i < cw; i += CTHREADS) {
            const int col = s + c0 + i;
            xs[i] = col < p.n_cols ? p.x[col] : 0.f;
        }
        __syncthreads();
        const float4* x4 = reinterpret_cast<const float4*>(xs);
        const int nq = cw >> 2;
#pragma unroll
        for (int i = 0; i < ROWS_PER_WARP; ++i) {
            const int r = warp * ROWS_PER_WARP + i;
            const float4* a4 =
                reinterpret_cast<const float4*>(slab + (size_t)r * W + c0);
            float sum = 0.f;
            for (int q = lane; q < nq; q += 32) {
                const float4 a = __ldg(a4 + q);
                const float4 b = x4[q];
                sum += a.x * b.x + a.y * b.y + a.z * b.z + a.w * b.w;
            }
            acc[i] += sum;
        }
    }
#pragma unroll
    for (int i = 0; i < ROWS_PER_WARP; ++i) {
        float v = acc[i];
#pragma unroll
        for (int off = 16; off > 0; off >>= 1)
            v += __shfl_xor_sync(0xffffffffu, v, off);
        acc[i] = v;
    }

    // ---- phase 2: dual prox; lane i < 16 of warp w takes row 16w+i
    if (lane < ROWS_PER_WARP) {
        float ax_slab = 0.f;
#pragma unroll
        for (int i = 0; i < ROWS_PER_WARP; ++i)
            if (i == lane) ax_slab = acc[i];
        const int r = warp * ROWS_PER_WARP + lane;
        const long long row = (long long)t * TILE + r;
        float y_new = 0.f;  // rows past n_rows contribute nothing
        if (row < p.n_rows) {
            const float ax_new =
                ax_slab + (p.ax_spill ? p.ax_spill[row] : 0.f);
            y_new = dual_prox(ax_new, p.ax_old[row], p.y[row], p.lc[row],
                              p.uc[row], *p.sigma);
            p.ax_out[row] = ax_new;
            p.y_out[row] = y_new;
        }
        ys[r] = y_new;
    }
    __syncthreads();

    // ---- phase 3: part[c] = sum_r y_new[r] * slab[r][c], column quads.
    // qp quads per pass (32..256) and RG = CTHREADS/qp row groups; the row
    // groups' sums are added in a fixed order.
    int qp = 32;
    while (qp < W4 && qp < CTHREADS) qp <<= 1;
    const int RG = CTHREADS / qp;
    const int rows_per_group = TILE / RG;
    const int g = tid / qp;
    const int q_in = tid - g * qp;
    for (int q0 = 0; q0 < W4; q0 += qp) {
        const int q = q0 + q_in;
        float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
        if (q < W4) {
            const int rb = g * rows_per_group;
            const float4* a4 =
                reinterpret_cast<const float4*>(slab + (size_t)rb * W) + q;
#pragma unroll 8
            for (int i = 0; i < rows_per_group; ++i) {
                const float4 a = __ldg(a4 + (size_t)i * W4);
                const float yr = ys[rb + i];
                v.x += yr * a.x;
                v.y += yr * a.y;
                v.z += yr * a.z;
                v.w += yr * a.w;
            }
        }
        if (RG > 1) {
            red[tid] = v;
            __syncthreads();
            if (g == 0) {
                for (int k = 1; k < RG; ++k) {
                    const float4 o = red[k * qp + q_in];
                    v.x += o.x;
                    v.y += o.y;
                    v.z += o.z;
                    v.w += o.w;
                }
            }
            __syncthreads();
        }
        if (g == 0 && q < W4) {
            if (PARTIALS)
                reinterpret_cast<float4*>(p.parts + (size_t)t * W)[q] = v;
            else
                atomic_add4(p, s + 4 * q, v);
        }
    }
    if constexpr (PARTIALS) fold_column_blocks(p, s, tid,
                                               fold_slot(p, s, 0, tid));
    if constexpr (!PARTIALS) count_launch<PARTIALS>();
}

// ------------------------------------------------------------ host side
enum Body { TWO_READ = 0, ONE_PASS = 1, COLUMN_SPLIT = 2 };

Body body_of(int W)
{
    return W <= W_ONE_PASS ? ONE_PASS
         : W <= W_COLUMN_SPLIT ? COLUMN_SPLIT : TWO_READ;
}

// f(std::integral_constant<int, n>) for n in N..8: W/128 for the
// one-pass body (N = 1), ceil(W/1024) for the column-split one (N = 2).
template <int N, class F>
cudaError_t with_n(int n, F&& f)
{
    static_assert(W_ONE_PASS / TILE == 8 && W_COLUMN_SPLIT / 1024 == 8,
                  "one case per width below");
    if constexpr (N > 8)
        return cudaErrorInvalidValue;
    else
        return n == N ? f(std::integral_constant<int, N>())
                      : with_n<N + 1>(n, f);
}

template <bool PARTIALS, int BODY, int N>
struct KernelTag {};

// Raises a kernel's dynamic shared memory limit to `bytes`, once per
// device. Tag names the kernel: all bodies share one function type.
template <class Tag>
cudaError_t prepare(const void* kernel, int bytes)
{
    static unsigned long long done = 0;  // bit d: set on device d
    int dev = 0;
    cudaError_t err = cudaGetDevice(&dev);
    if (err == cudaSuccess && !(dev < 64 && (done >> dev & 1ull))) {
        err = cudaFuncSetAttribute(
            kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
        if (err == cudaSuccess && dev < 64) done |= 1ull << dev;
    }
    if (err != cudaSuccess) cudaGetLastError();  // not left for the next launch
    return err;
}

// f(kernel, threads, dynamic shared memory) for the body that width W
// takes, its dynamic shared memory limit raised.
template <bool PARTIALS, class F>
cudaError_t with_body(int W, F&& f)
{
    switch (body_of(W)) {
    case ONE_PASS:
        return with_n<1>(W / TILE, [&](auto n) {
            constexpr int KQ = decltype(n)::value;
            auto* k = row_pass_one_pass<PARTIALS, KQ>;
            cudaError_t err = prepare<KernelTag<PARTIALS, ONE_PASS, KQ>>(
                (const void*)k, ring_bytes(KQ));
            return err != cudaSuccess ? err
                 : f(k, PIPE_THREADS, ring_bytes(KQ));
        });
    case COLUMN_SPLIT:
        return with_n<2>((W + 1023) / 1024, [&](auto n) {
            constexpr int NQ = decltype(n)::value;
            auto* k = row_pass_column_split<PARTIALS, NQ>;
            cudaError_t err = prepare<KernelTag<PARTIALS, COLUMN_SPLIT, NQ>>(
                (const void*)k, CS_MAX_RING);
            return err != cudaSuccess ? err
                 : f(k, PIPE_THREADS, cs_ring_bytes(W));
        });
    default:
        return f(row_pass_two_read<PARTIALS>, CTHREADS, 0);
    }
}

template <bool PARTIALS>
cudaError_t launch_row_pass(const RowPassArgs& a, int T, cudaStream_t st)
{
    if (T <= 0) return cudaSuccess;
    if (a.W <= 0 || a.W % TILE) return cudaErrorInvalidValue;
    return with_body<PARTIALS>(a.W, [&](auto* k, int threads, int smem) {
        void* args[] = {const_cast<RowPassArgs*>(&a)};
        cudaError_t err = cudaLaunchKernel((const void*)k, dim3(T),
                                           dim3(threads), args, smem, st);
        if (err != cudaSuccess) cudaGetLastError();  // not left behind
        return err;
    });
}

// info[0..5] of the body `launch_row_pass` picks for width W.
template <bool PARTIALS>
cudaError_t row_pass_info(int W, int* info)
{
    if (W <= 0 || W % TILE) return cudaErrorInvalidValue;
    return with_body<PARTIALS>(W, [&](auto* k, int threads, int smem) {
        cudaFuncAttributes attr{};
        cudaError_t err = cudaFuncGetAttributes(&attr, (const void*)k);
        int blocks = 0;
        if (err == cudaSuccess)
            err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
                &blocks, k, threads, smem);
        info[0] = body_of(W);
        info[1] = threads;
        info[2] = attr.numRegs;
        info[3] = (int)attr.sharedSizeBytes + smem;
        info[4] = (int)attr.localSizeBytes;
        info[5] = blocks;
        return err;
    });
}

}  // namespace

extern "C" {

// Atomic mode: aty (n_cols,) must be zeroed by the caller.
int row_pass_atomic(const float* slabs, const int* starts, int T, int W,
                    int n_rows, int n_cols, const float* x,
                    const float* ax_old, const float* ax_spill, const float* y,
                    const float* lc, const float* uc, const float* sigma,
                    float* ax_out, float* y_out, float* aty, void* stream)
{
    RowPassArgs a{slabs, starts, W, n_rows, n_cols, x, ax_old, ax_spill, y,
                  lc, uc, sigma, ax_out, y_out, aty};
    return (int)launch_row_pass<false>(a, T, (cudaStream_t)stream);
}

// Partials mode: writes each tile's part to parts (T, W) and sums them
// into aty (n_cols,). cb_offsets (n_blocks + 1,) and cb_rows list, per
// 128-column block, the rows of the (T * W/128, 128) parts view that land
// on it, tile-ascending; counters (n_blocks,) must be zero, and are zero
// again when the launch has run. aty must be 16-byte aligned; column
// blocks with no listed row are not written.
int row_pass_partials(const float* slabs, const int* starts, int T, int W,
                      int n_rows, int n_cols, const float* x,
                      const float* ax_old, const float* ax_spill,
                      const float* y, const float* lc, const float* uc,
                      const float* sigma, float* ax_out, float* y_out,
                      float* parts, const int* cb_offsets, const int* cb_rows,
                      int* counters, int n_blocks, float* aty, void* stream)
{
    RowPassArgs a{slabs, starts, W, n_rows, n_cols, x, ax_old, ax_spill, y,
                  lc, uc, sigma, ax_out, y_out, aty, parts, cb_offsets,
                  cb_rows, counters, n_blocks};
    return (int)launch_row_pass<true>(a, T, (cudaStream_t)stream);
}

// What the row pass of mode `partials` (0 or 1) runs at window width W,
// on the current device: info[0] the body (0 two-read, 1 one-pass, 2
// column-split); info[1] threads per block; info[2] registers per thread;
// info[3] shared memory per block in bytes (static + dynamic); info[4]
// local memory per thread in bytes; info[5] resident blocks per SM.
int row_pass_config(int W, int partials, int* info)
{
    return (int)(partials ? row_pass_info<true>(W, info)
                          : row_pass_info<false>(W, info));
}

// Launches of mode `partials` (0 or 1) that have run on the current
// device since its last reset, into *out, once the device's work so far
// has finished. With reset nonzero the count is then set back to zero.
int row_pass_launches(int partials, int reset, unsigned long long* out)
{
    if (partials < 0 || partials > 1) return (int)cudaErrorInvalidValue;
    const size_t at = partials * sizeof(unsigned long long);
    cudaError_t err = cudaDeviceSynchronize();
    if (err == cudaSuccess)
        err = cudaMemcpyFromSymbol(out, g_launches, sizeof *out, at);
    if (err == cudaSuccess && reset) {
        const unsigned long long zero = 0;
        err = cudaMemcpyToSymbol(g_launches, &zero, sizeof zero, at);
    }
    return (int)err;
}

const char* cuda_error_string(int err)
{
    return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
