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
//   row_pass_partials  <- _kernel_stream (launched by _row_pass_stream):
//   + reduce_partials     each tile writes its part to a (T, W) buffer and
//                         a second kernel sums the parts of each 128-column
//                         block in a fixed (tile-ascending) order, so the
//                         result has the same bits on every run.
//
// Bound: the pass must read the slabs once, T*128*W*4 bytes (76.9 MB per
// call for the 50k staircase, 461 MB at 300k), plus O(rows + cols) bytes
// of vectors, against 4*T*128*W flops: about 0.5 flop per byte, so it is
// memory-bound (3.35 TB/s on an H100 SXM: about 23 us at 50k).
//
// One-pass body (W <= W_ONE_PASS), one thread block per tile. y_new[r]
// depends only on row r, so the transpose is summed row by row as soon as
// the row's dot product is known, and each slab byte crosses HBM once:
//   - a producer warp streams the slab through a ring of shared-memory
//     stages of 8 rows (one contiguous 8*W*4-byte block) with 1-D
//     cp.async.bulk copies that complete on "full" mbarriers; consumers
//     release a stage on its "empty" mbarrier as soon as they hold its
//     values in registers. The ring keeps up to 64 KB of slab in flight
//     per block;
//   - each of 8 consumer warps takes one row per stage. Lane l holds the
//     columns 4l + 128k (k < W/128) as float4: the x window (loaded once
//     per tile, zero past n_cols), the row's values and its accumulator.
//     The warp multiplies, reduces with __shfl_xor_sync (every lane ends
//     with the same ax), applies the prox on every lane and adds
//     y_new * row into its accumulator;
//   - at the end of the tile the 8 warps' accumulators are summed through
//     shared memory in warp order, so the partials mode gives the same
//     bits on every run. Tensor cores are not used: this is a
//     matrix-vector product at 0.5 flop per byte, wgmma needs N >= 8
//     (arithmetic multiplied for nothing on a byte-bound kernel), and TF32
//     would break the 1e-5 parity with the float32 plain version.
// A block at W=384 holds 60 KB of ring and 64 registers a thread, so three
// are resident per SM and the 50k staircase's 391 tiles run in one wave
// on 132 SMs.
//
// W_ONE_PASS = 1024: each lane holds 3 * W/32 floats in registers (x
// window, row values, accumulator), templated on W/128 so that they stay
// in registers. ptxas shows no spill at any width up to 1024 (122
// registers there, one block per SM). Wider windows (degen-transport,
// W=4224) take the two-read body: phase 1 streams each slab row against
// the x window staged in 2048-column chunks, phase 2 applies the prox,
// phase 3 re-reads the slab for the transpose, column-quad-major. That
// second read mostly comes from HBM.
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

// ---------------------------------------------------------- one-pass body
constexpr int W_ONE_PASS = 1024;
constexpr int CWARPS = 8;                    // consumer warps, a row each
constexpr int ONE_PASS_THREADS = (CWARPS + 1) * 32;  // + the producer warp
constexpr int STAGE_ROWS = CWARPS;           // slab rows per ring stage
constexpr int RING_BYTES = 64 * 1024;        // slab bytes in flight per block
constexpr int MAX_STAGES = 8;

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

struct RowPassArgs {
    const float* slabs;
    const int* starts;
    int W, n_rows, n_cols;
    const float *x, *ax_old, *ax_spill, *y, *lc, *uc, *sigma;
    float *ax_out, *y_out, *out;
};

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

// Barrier of the consumer warps only (the producer warp has left).
__device__ __forceinline__ void consumer_sync()
{
    asm volatile("bar.sync 1, %0;" :: "n"(CWARPS * 32) : "memory");
}

template <bool PARTIALS, int KQ>
__global__ void __launch_bounds__(ONE_PASS_THREADS,
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

    if (tid == 0) {
        for (int i = 0; i < S; ++i) {
            mbar_init(&full[i], 1);
            mbar_init(&empty[i], CWARPS);
        }
        asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
    }
    __syncthreads();

    if (warp == CWARPS) {  // ---- producer: one elected thread
        if (lane == 0) {
            const float* slab = p.slabs + (size_t)t * TILE * W;
            int stage = 0;
            uint32_t phase = 0;
            for (int j = 0; j < CHUNKS; ++j) {
                if (j >= S) mbar_wait(&empty[stage], phase ^ 1);
                mbar_expect_tx(&full[stage], stage_bytes(KQ));
                bulk_load(ring + stage * STAGE_FLOATS,
                          slab + (size_t)j * STAGE_FLOATS, stage_bytes(KQ),
                          &full[stage]);
                if (++stage == S) {
                    stage = 0;
                    phase ^= 1;
                }
            }
        }
        return;
    }

    // ---- consumers: the tile's row vectors and the x window, while the
    // first stages are in flight
    const long long row0 = (long long)t * TILE;
    for (int i = tid; i < TILE; i += CWARPS * 32) {
        const long long row = row0 + i;
        const bool in = row < p.n_rows;
        v_ax_old[i] = in ? p.ax_old[row] : 0.f;
        v_y[i] = in ? p.y[row] : 0.f;
        v_lc[i] = in ? p.lc[row] : 0.f;
        v_uc[i] = in ? p.uc[row] : 0.f;
        v_spill[i] = in && p.ax_spill ? p.ax_spill[row] : 0.f;
    }
    const int s = p.starts[t];
    float4 xv[KQ], acc[KQ];
#pragma unroll
    for (int k = 0; k < KQ; ++k) {
        const int c = s + TILE * k + 4 * lane;  // windows may run past n_cols
        xv[k] = make_float4(c < p.n_cols ? p.x[c] : 0.f,
                            c + 1 < p.n_cols ? p.x[c + 1] : 0.f,
                            c + 2 < p.n_cols ? p.x[c + 2] : 0.f,
                            c + 3 < p.n_cols ? p.x[c + 3] : 0.f);
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
            const float ax_tilde = 2.f * ax_new - v_ax_old[r];
            const float y_low = v_y[r] + sg * (v_lc[r] - ax_tilde);
            const float y_high = v_y[r] + sg * (v_uc[r] - ax_tilde);
            y_new = y_low > 0.f ? y_low : (y_high < 0.f ? y_high : 0.f);
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
        if (PARTIALS) {
            reinterpret_cast<float4*>(p.out + (size_t)t * W)[tid] = v;
        } else {
            const int col = s + 4 * tid;
            if (col < p.n_cols) atomicAdd(p.out + col, v.x);
            if (col + 1 < p.n_cols) atomicAdd(p.out + col + 1, v.y);
            if (col + 2 < p.n_cols) atomicAdd(p.out + col + 2, v.z);
            if (col + 3 < p.n_cols) atomicAdd(p.out + col + 3, v.w);
        }
    }
    for (int i = tid; i < TILE; i += CWARPS * 32) {
        if (row0 + i < p.n_rows) {
            p.ax_out[row0 + i] = o_ax[i];
            p.y_out[row0 + i] = o_y[i];
        }
    }
}

// ------------------------------------------- two-read body (W > W_ONE_PASS)
constexpr int THREADS = 256;                 // 8 warps per tile
constexpr int WARPS = THREADS / 32;
constexpr int ROWS_PER_WARP = TILE / WARPS;  // 16
constexpr int XCHUNK = 2048;                 // x-window columns staged per pass

template <bool PARTIALS>
__global__ void __launch_bounds__(THREADS)
row_pass_two_read(const float* __restrict__ slabs, const int* __restrict__ starts,
                  int W, int n_rows, int n_cols,
                  const float* __restrict__ x, const float* __restrict__ ax_old,
                  const float* __restrict__ ax_spill, const float* __restrict__ y,
                  const float* __restrict__ lc, const float* __restrict__ uc,
                  const float* __restrict__ sigma_ptr,
                  float* __restrict__ ax_out, float* __restrict__ y_out,
                  float* __restrict__ out)
{
    __shared__ __align__(16) float xs[XCHUNK];
    __shared__ float ys[TILE];
    __shared__ float4 red[THREADS];

    const int t = blockIdx.x;
    const int tid = threadIdx.x;
    const int lane = tid & 31;
    const int warp = tid >> 5;
    const float* slab = slabs + (size_t)t * TILE * W;
    const int s = starts[t];
    const int W4 = W >> 2;

    // ---- phase 1: ax for the tile's rows (warp w owns rows 16w..16w+15)
    float acc[ROWS_PER_WARP];
#pragma unroll
    for (int i = 0; i < ROWS_PER_WARP; ++i) acc[i] = 0.f;
    for (int c0 = 0; c0 < W; c0 += XCHUNK) {
        const int cw = min(XCHUNK, W - c0);
        __syncthreads();
        for (int i = tid; i < cw; i += THREADS) {
            const int col = s + c0 + i;
            xs[i] = col < n_cols ? x[col] : 0.f;  // windows may run past n_cols
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
        if (row < n_rows) {
            const float sg = *sigma_ptr;
            const float ax_new = ax_slab + (ax_spill ? ax_spill[row] : 0.f);
            const float ax_tilde = 2.f * ax_new - ax_old[row];
            const float yv = y[row];
            const float y_low = yv + sg * (lc[row] - ax_tilde);
            const float y_high = yv + sg * (uc[row] - ax_tilde);
            y_new = y_low > 0.f ? y_low : (y_high < 0.f ? y_high : 0.f);
            ax_out[row] = ax_new;
            y_out[row] = y_new;
        }
        ys[r] = y_new;
    }
    __syncthreads();

    // ---- phase 3: part[c] = sum_r y_new[r] * slab[r][c], column quads.
    // qp quads per pass (32..256) and RG = THREADS/qp row groups, so that
    // narrow windows still keep most threads loading; the row groups'
    // sums are added in a fixed order.
    int qp = 32;
    while (qp < W4 && qp < THREADS) qp <<= 1;
    const int RG = THREADS / qp;
    const int rows_per_group = TILE / RG;
    const int g = tid / qp;
    const int q_in = tid - g * qp;
    for (int q0 = 0; q0 < W4; q0 += qp) {
        const int q = q0 + q_in;
        float4 p = make_float4(0.f, 0.f, 0.f, 0.f);
        if (q < W4) {
            const int rb = g * rows_per_group;
            const float4* a4 =
                reinterpret_cast<const float4*>(slab + (size_t)rb * W) + q;
#pragma unroll 8
            for (int i = 0; i < rows_per_group; ++i) {
                const float4 a = __ldg(a4 + (size_t)i * W4);
                const float yr = ys[rb + i];
                p.x += yr * a.x;
                p.y += yr * a.y;
                p.z += yr * a.z;
                p.w += yr * a.w;
            }
        }
        if (RG > 1) {
            red[tid] = p;
            __syncthreads();
            if (g == 0) {
                for (int k = 1; k < RG; ++k) {
                    const float4 o = red[k * qp + q_in];
                    p.x += o.x;
                    p.y += o.y;
                    p.z += o.z;
                    p.w += o.w;
                }
            }
            __syncthreads();
        }
        if (g == 0 && q < W4) {
            if (PARTIALS) {
                reinterpret_cast<float4*>(out + (size_t)t * W)[q] = p;
            } else {
                const int col = s + 4 * q;
                if (col < n_cols) atomicAdd(out + col, p.x);
                if (col + 1 < n_cols) atomicAdd(out + col + 1, p.y);
                if (col + 2 < n_cols) atomicAdd(out + col + 2, p.z);
                if (col + 3 < n_cols) atomicAdd(out + col + 3, p.w);
            }
        }
    }
}

// aty[128 cb + l] = sum over the (tile, window block) rows e listed for
// column block cb, in list order, of partials[e][l].
__global__ void __launch_bounds__(TILE)
reduce_partials_kernel(const float* __restrict__ partials,
                       const int* __restrict__ cb_offsets,
                       const int* __restrict__ cb_rows, int n_cols,
                       float* __restrict__ aty)
{
    const int cb = blockIdx.x;
    const int l = threadIdx.x;
    float acc = 0.f;
    const int end = cb_offsets[cb + 1];
    for (int e = cb_offsets[cb]; e < end; ++e)
        acc += partials[(size_t)cb_rows[e] * TILE + l];
    const int col = cb * TILE + l;
    if (col < n_cols) aty[col] = acc;
}

// ------------------------------------------------------------ host side
// f(std::integral_constant<int, kq>) for kq = W/128 in 1..W_ONE_PASS/128.
template <class F>
cudaError_t with_kq(int kq, F&& f)
{
    static_assert(W_ONE_PASS / TILE == 8, "one case per width below");
    switch (kq) {
    case 1: return f(std::integral_constant<int, 1>());
    case 2: return f(std::integral_constant<int, 2>());
    case 3: return f(std::integral_constant<int, 3>());
    case 4: return f(std::integral_constant<int, 4>());
    case 5: return f(std::integral_constant<int, 5>());
    case 6: return f(std::integral_constant<int, 6>());
    case 7: return f(std::integral_constant<int, 7>());
    case 8: return f(std::integral_constant<int, 8>());
    }
    return cudaErrorInvalidValue;
}

// Raises the kernel's dynamic shared memory limit to its ring, once per
// device.
template <bool PARTIALS, int KQ>
cudaError_t one_pass_prepare()
{
    static unsigned long long done = 0;  // bit d: set on device d
    int dev = 0;
    cudaError_t err = cudaGetDevice(&dev);
    if (err == cudaSuccess && !(dev < 64 && (done >> dev & 1ull))) {
        err = cudaFuncSetAttribute(row_pass_one_pass<PARTIALS, KQ>,
                                   cudaFuncAttributeMaxDynamicSharedMemorySize,
                                   ring_bytes(KQ));
        if (err == cudaSuccess && dev < 64) done |= 1ull << dev;
    }
    if (err != cudaSuccess) cudaGetLastError();  // not left for the next launch
    return err;
}

template <bool PARTIALS>
cudaError_t launch_row_pass(const RowPassArgs& a, int T, cudaStream_t st)
{
    if (T <= 0) return cudaSuccess;
    if (a.W <= 0 || a.W % TILE) return cudaErrorInvalidValue;
    if (a.W <= W_ONE_PASS) {
        return with_kq(a.W / TILE, [&](auto kq) {
            constexpr int KQ = decltype(kq)::value;
            cudaError_t err = one_pass_prepare<PARTIALS, KQ>();
            if (err != cudaSuccess) return err;
            row_pass_one_pass<PARTIALS, KQ>
                <<<T, ONE_PASS_THREADS, ring_bytes(KQ), st>>>(a);
            return cudaGetLastError();
        });
    }
    row_pass_two_read<PARTIALS><<<T, THREADS, 0, st>>>(
        a.slabs, a.starts, a.W, a.n_rows, a.n_cols, a.x, a.ax_old,
        a.ax_spill, a.y, a.lc, a.uc, a.sigma, a.ax_out, a.y_out, a.out);
    return cudaGetLastError();
}

// info[0..5] of the kernel `launch_row_pass` picks for width W.
template <bool PARTIALS>
cudaError_t row_pass_info(int W, int* info)
{
    if (W <= 0 || W % TILE) return cudaErrorInvalidValue;
    auto fill = [&](const void* fn, int one_pass, int threads,
                    int dyn_smem) {
        cudaFuncAttributes attr{};
        cudaError_t err = cudaFuncGetAttributes(&attr, fn);
        int blocks = 0;
        if (err == cudaSuccess)
            err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
                &blocks, fn, threads, dyn_smem);
        info[0] = one_pass;
        info[1] = threads;
        info[2] = attr.numRegs;
        info[3] = (int)attr.sharedSizeBytes + dyn_smem;
        info[4] = (int)attr.localSizeBytes;
        info[5] = blocks;
        return err;
    };
    if (W <= W_ONE_PASS) {
        return with_kq(W / TILE, [&](auto kq) {
            constexpr int KQ = decltype(kq)::value;
            cudaError_t err = one_pass_prepare<PARTIALS, KQ>();
            if (err != cudaSuccess) return err;
            return fill((const void*)row_pass_one_pass<PARTIALS, KQ>, 1,
                        ONE_PASS_THREADS, ring_bytes(KQ));
        });
    }
    return fill((const void*)row_pass_two_read<PARTIALS>, 0, THREADS, 0);
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
    const RowPassArgs a{slabs, starts, W, n_rows, n_cols, x, ax_old,
                        ax_spill, y, lc, uc, sigma, ax_out, y_out, aty};
    return (int)launch_row_pass<false>(a, T, (cudaStream_t)stream);
}

// Partials mode: writes partials (T, W); reduce_partials then sums them.
int row_pass_partials(const float* slabs, const int* starts, int T, int W,
                      int n_rows, int n_cols, const float* x,
                      const float* ax_old, const float* ax_spill,
                      const float* y, const float* lc, const float* uc,
                      const float* sigma, float* ax_out, float* y_out,
                      float* partials, void* stream)
{
    const RowPassArgs a{slabs, starts, W, n_rows, n_cols, x, ax_old,
                        ax_spill, y, lc, uc, sigma, ax_out, y_out, partials};
    return (int)launch_row_pass<true>(a, T, (cudaStream_t)stream);
}

// One block per 128-column block; cb_offsets (n_blocks + 1,) and cb_rows
// list, per column block, the rows of the (T * W/128, 128) partials view
// that land on it, tile-ascending.
int reduce_partials(const float* partials, const int* cb_offsets,
                    const int* cb_rows, int n_blocks, int n_cols, float* aty,
                    void* stream)
{
    if (n_blocks <= 0) return 0;
    reduce_partials_kernel<<<n_blocks, TILE, 0, (cudaStream_t)stream>>>(
        partials, cb_offsets, cb_rows, n_cols, aty);
    return (int)cudaGetLastError();
}

// What the row pass of mode `partials` (0 or 1) runs at window width W,
// on the current device: info[0] 1 for the one-pass body, 0 for the
// two-read one; info[1] threads per block; info[2] registers per thread;
// info[3] shared memory per block in bytes (static + dynamic); info[4]
// local memory per thread in bytes; info[5] resident blocks per SM.
int row_pass_config(int W, int partials, int* info)
{
    return (int)(partials ? row_pass_info<true>(W, info)
                          : row_pass_info<false>(W, info));
}

const char* cuda_error_string(int err)
{
    return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
