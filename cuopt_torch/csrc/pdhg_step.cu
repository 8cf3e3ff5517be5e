// The PDHG slot's vector and scalar work on the card, around its products.
//
// A slot is one predicated attempt of an adaptive PDHG step
// (cuopt_torch/lp/pdlp.py `_slot`: `_attempt`, then `_accept` and the
// commit into the other buffer). Beside its products (the fused row pass
// of csrc/row_pass.cu, or the operator's matvec and rmatvec) the slot's
// elementwise and scalar work was some 106 PyTorch ops, 60 of them on 0-d
// tensors, each its own kernel node in the slot's CUDA graph. Here it is
// four kernels (three on the unfused path, where pdhg_dual takes the row
// sums over):
//
//   pdhg_primal    over columns: tau = eta / omega and sigma = eta * omega
//                  from the step size and primal weight on the device;
//                  x_new = clamp(x - tau (c - aty), lv, uv); per-block
//                  partial sums of dx.dx and x_new.x_new; sigma for the
//                  products. On the fused path, blocks past the columns
//                  write lc0m and uc0m, the constraint bounds with the
//                  infinite ones masked to -/+ a sentinel.
//   pdhg_dual      over rows, between the unfused matvec and rmatvec:
//                  ax~ = 2 ax_new - ax, the two-sided dual prox to y_new,
//                  and the partial sums of dy.(ax_new - ax), dy.dy and
//                  y_new.y_new.
//   pdhg_row_sums  over rows, after the fused row pass: the same three
//                  partial sums from the pass's y_new.
//   pdhg_commit    over columns and rows: every block sums all the
//                  partials in one fixed order and computes the step's
//                  scalars (movement, interaction, eta_limit, valid, k1,
//                  eta_next, commit, sum_w, frac), then writes its slice of
//                  x, y, ax, aty and the four averages into the output
//                  buffer, selecting bits: a rejected attempt writes the
//                  input's. Block 0 writes the scalar fields and the next
//                  attempt index.
//
// They replace no TPU kernel: cuopt_tpu/lp/pdlp.py's `_attempt` and
// `_accept` are jnp code, which XLA fuses into a few fusions on the TPU.
//
// Order of summation: each partial-sum block owns a fixed contiguous chunk
// of its vector (the caller's `chunk` and `blocks`); its threads stride
// through the chunk and meet in a fixed tree (xor shuffles, then the warps
// in order). The commit sums the partials strided over its threads and
// through the same tree. So every launch gives the same bits, and a CUDA
// graph's replay those of an eager launch. The elementwise arithmetic
// rounds after every operation, as the PyTorch ops it replaces do (the
// _rn intrinsics keep nvcc from contracting into FMAs): x_new, y_new and
// the commit's vectors have the bits of the plain version on the same
// inputs; only the sums differ from it in their order.
//
// Bound: bytes, and below a few hundred KB a vector, launch latency. Per
// slot the four read and write 16 vectors of the column count and 18 of
// the row count (fused; 16 and 16 unfused), 6.8 MB at the 50k staircase in
// float32: 2.0 us at 3.35 TB/s. A block moves 1,024 elements of each of
// its vectors (THREADS threads, four each), so the 50k staircase fills 49
// partial-sum blocks a side and 98 commit blocks; at 300k the partial sums
// are capped at MAX_PARTS = 256 blocks a vector (lp/pdhg_step.py), so the
// commit's blocks each re-sum 1,280 partials from L2.
//
// Interface: plain C, loaded with ctypes. Every pointer is device memory
// on the current device, contiguous: the floating vectors and scalars of
// the state's dtype (float when `dbl` is 0, double when 1), the masks and
// numerical_error as bytes (torch.bool), the counters as int64. The
// kernels launch on `stream`, allocate nothing and do not synchronise.
// Each entry point returns the cudaError_t of its launch (0 on success).

#include <cuda_runtime.h>
#include <float.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int CHUNK = 1024;  // sentinel rows and commit elements per block

// Launches of each kernel that have run on this device: thread 0 of block
// 0 counts each launch as it runs, so a launch that a CUDA graph recorded
// counts at each replay that runs it and not at the capture. Read and
// zeroed by pdhg_step_launches.
enum Which { PRIMAL = 0, DUAL = 1, ROW_SUMS = 2, COMMIT = 3, N_KERNELS = 4 };
__device__ unsigned long long g_step_launches[N_KERNELS];

__device__ __forceinline__ void count_launch(Which k)
{
    if (blockIdx.x == 0 && threadIdx.x == 0)
        atomicAdd(&g_step_launches[k], 1ull);
}

// One rounding per operation, as in the PyTorch ops these stand for.
__device__ __forceinline__ float add(float a, float b) { return __fadd_rn(a, b); }
__device__ __forceinline__ double add(double a, double b) { return __dadd_rn(a, b); }
__device__ __forceinline__ float sub(float a, float b) { return __fsub_rn(a, b); }
__device__ __forceinline__ double sub(double a, double b) { return __dsub_rn(a, b); }
__device__ __forceinline__ float mul(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ double mul(double a, double b) { return __dmul_rn(a, b); }
__device__ __forceinline__ float quo(float a, float b) { return __fdiv_rn(a, b); }
__device__ __forceinline__ double quo(double a, double b) { return __ddiv_rn(a, b); }
__device__ __forceinline__ float power(float a, float b) { return powf(a, b); }
__device__ __forceinline__ double power(double a, double b) { return pow(a, b); }

template <typename T> struct Lim;
template <> struct Lim<float> { static constexpr float big = FLT_MAX; };
template <> struct Lim<double> { static constexpr double big = DBL_MAX; };

// torch.clamp(v, lo, hi) = min(max(v, lo), hi), a NaN v kept.
template <typename T>
__device__ __forceinline__ T clamp(T v, T lo, T hi)
{
    if (v != v) return v;
    const T r = v < lo ? lo : v;
    return r > hi ? hi : r;
}

// torch.minimum: a NaN on either side is the result.
template <typename T>
__device__ __forceinline__ T minimum(T a, T b)
{
    return a != a ? a : (b != b ? b : (b < a ? b : a));
}

// Each v[k] summed over the block, in a fixed tree: xor shuffles within
// each warp, then the warps' sums in warp order. Every thread returns
// with the same bits.
template <typename T, int K>
__device__ __forceinline__ void block_sum(T (&v)[K])
{
    __shared__ T warp_sums[K][WARPS];
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
    for (int k = 0; k < K; ++k) {
        T s = v[k];
#pragma unroll
        for (int off = 16; off > 0; off >>= 1)
            s += __shfl_xor_sync(0xffffffffu, s, off);
        if (lane == 0) warp_sums[k][warp] = s;
    }
    __syncthreads();
#pragma unroll
    for (int k = 0; k < K; ++k) {
        T s = warp_sums[k][0];
#pragma unroll
        for (int w = 1; w < WARPS; ++w) s += warp_sums[k][w];
        v[k] = s;
    }
    __syncthreads();
}

// ------------------------------------------------------------- pdhg_primal
template <typename T>
struct PrimalArgs {
    int m, n_sent, chunk, blocks;
    const T *x, *aty, *c, *lv, *uv, *step_size, *primal_weight;
    T *x_new, *sigma;
    T* parts;  // (2, blocks): dx.dx, x_new.x_new
    const uint8_t *lc_fin, *uc_fin;
    const T *lc0, *uc0;
    T *lc0m, *uc0m;
};

template <typename T>
__global__ void __launch_bounds__(THREADS) pdhg_primal_kernel(PrimalArgs<T> a)
{
    count_launch(PRIMAL);
    const T eta = *a.step_size, omega = *a.primal_weight;
    const T sigma = mul(eta, omega);
    const int b = blockIdx.x;
    if (b == 0 && threadIdx.x == 0) *a.sigma = sigma;
    if (b < a.blocks) {
        const T tau = quo(eta, omega);
        T v[2] = {T(0), T(0)};
        const int end = min(b * a.chunk + a.chunk, a.m);
        for (int i = b * a.chunk + threadIdx.x; i < end; i += THREADS) {
            const T x = a.x[i];
            const T xn = clamp(sub(x, mul(tau, sub(a.c[i], a.aty[i]))),
                               a.lv[i], a.uv[i]);
            a.x_new[i] = xn;
            const T dx = sub(xn, x);
            v[0] += dx * dx;
            v[1] += xn * xn;
        }
        block_sum(v);
        if (threadIdx.x == 0) {
            a.parts[b] = v[0];
            a.parts[a.blocks + b] = v[1];
        }
        return;
    }
    // the infinite-row sentinel, scaled so that sigma * sentinel cannot
    // overflow: big / 8 / max(sigma, 1), which PyTorch computes as the
    // clamped sigma's reciprocal times big / 8
    const T sent = mul(quo(T(1), sigma < T(1) ? T(1) : sigma),
                       Lim<T>::big / T(8));
    const int r0 = (b - a.blocks) * CHUNK;
    const int end = min(r0 + CHUNK, a.n_sent);
    for (int i = r0 + threadIdx.x; i < end; i += THREADS) {
        a.lc0m[i] = a.lc_fin[i] ? a.lc0[i] : -sent;
        a.uc0m[i] = a.uc_fin[i] ? a.uc0[i] : sent;
    }
}

// ------------------------------------------- pdhg_dual and pdhg_row_sums
template <typename T>
struct RowArgs {
    int n, chunk, blocks;
    const T *ax_new, *ax, *y;
    T* y_new;  // written by pdhg_dual, read by pdhg_row_sums
    T* parts;  // (3, blocks): dy.(ax_new - ax), dy.dy, y_new.y_new
    // pdhg_dual only
    const T *lc0, *uc0, *sigma;
    const uint8_t *lc_fin, *uc_fin;
};

template <typename T, bool PROX>
__global__ void __launch_bounds__(THREADS) pdhg_rows_kernel(RowArgs<T> a)
{
    count_launch(PROX ? DUAL : ROW_SUMS);
    const int b = blockIdx.x;
    if (b >= a.blocks) return;  // a launch over no rows has one block
    const T sigma = PROX ? *a.sigma : T(0);
    T v[3] = {T(0), T(0), T(0)};
    const int end = min(b * a.chunk + a.chunk, a.n);
    for (int i = b * a.chunk + threadIdx.x; i < end; i += THREADS) {
        const T axn = a.ax_new[i], ax0 = a.ax[i], y0 = a.y[i];
        T yn;
        if (PROX) {
            const T axt = sub(mul(T(2), axn), ax0);
            const T lo = a.lc_fin[i] ? add(y0, mul(sigma, sub(a.lc0[i], axt)))
                                     : -Lim<T>::big;
            const T hi = a.uc_fin[i] ? add(y0, mul(sigma, sub(a.uc0[i], axt)))
                                     : Lim<T>::big;
            yn = lo > T(0) ? lo : (hi < T(0) ? hi : T(0));
            a.y_new[i] = yn;
        } else {
            yn = a.y_new[i];
        }
        const T dy = sub(yn, y0);
        v[0] += dy * sub(axn, ax0);
        v[1] += dy * dy;
        v[2] += yn * yn;
    }
    block_sum(v);
    if (threadIdx.x == 0) {
        a.parts[b] = v[0];
        a.parts[a.blocks + b] = v[1];
        a.parts[2 * a.blocks + b] = v[2];
    }
}

// ------------------------------------------------------------ pdhg_commit
template <typename T>
struct CommitArgs {
    int m, n, bx, by, max_attempts;
    T reduction_power, growth_power;  // -reduction_exponent, -growth_exponent
    const T* parts;  // pdhg_primal's (2, bx), then the rows' (3, by)
    const T *x_new, *y_new, *ax_new, *aty_new;
    const T *x, *y, *ax, *aty, *avg_x, *avg_y, *avg_ax, *avg_aty;
    const T *step_size, *primal_weight, *sum_weights;
    const long long *iters, *steps, *attempts, *pending;
    const uint8_t* numerical_error;
    T *out_x, *out_y, *out_ax, *out_aty;
    T *out_avg_x, *out_avg_y, *out_avg_ax, *out_avg_aty;
    T *out_step_size, *out_sum_weights;
    long long *out_iters, *out_steps, *out_attempts, *out_pending;
    uint8_t* out_numerical_error;
};

// out = commit ? new : old, and the running average the same way.
template <typename T>
__device__ __forceinline__ void commit_pair(bool commit, T frac, int i,
                                            const T* nw, const T* old,
                                            const T* avg, T* out, T* out_avg)
{
    const T v = nw[i], a = avg[i];
    out[i] = commit ? v : old[i];
    out_avg[i] = commit ? add(a, mul(frac, sub(v, a))) : a;
}

template <typename T>
__global__ void __launch_bounds__(THREADS) pdhg_commit_kernel(CommitArgs<T> a)
{
    count_launch(COMMIT);
    T v[5] = {T(0), T(0), T(0), T(0), T(0)};
    for (int i = threadIdx.x; i < a.bx; i += THREADS) {
        v[0] += a.parts[i];
        v[1] += a.parts[a.bx + i];
    }
    const T* py = a.parts + 2 * a.bx;
    for (int i = threadIdx.x; i < a.by; i += THREADS) {
        v[2] += py[i];
        v[3] += py[a.by + i];
        v[4] += py[2 * a.by + i];
    }
    block_sum(v);
    const T dxdx = v[0], xx = v[1], dydy = v[3], yy = v[4];
    const T interaction = fabs(v[2]);

    // _attempt's step-size arithmetic, in PyTorch's order of operations
    const T eta = *a.step_size, omega = *a.primal_weight;
    const T movement = add(mul(mul(omega, T(0.5)), dxdx),
                           mul(mul(quo(T(1), omega), T(0.5)), dydy));
    const T eta_limit = interaction > T(0) ? quo(movement, interaction)
                                           : Lim<T>::big;
    const bool valid = eta <= eta_limit;
    const long long pending = *a.pending, attempts = pending + 1;
    const T k1 = (T)(*a.attempts + (pending + 2));
    const T eta_next = minimum(
        mul(sub(T(1), power(k1, a.reduction_power)), eta_limit),
        mul(add(power(k1, a.growth_power), T(1)), eta));
    const bool commit = valid || attempts >= a.max_attempts;
    // _accept's weight of the average
    const T sum_w = add(*a.sum_weights, eta);
    const T frac = quo(eta, sum_w);

    const int col_blocks = (a.m + CHUNK - 1) / CHUNK;
    if ((int)blockIdx.x < col_blocks) {
        const int i0 = blockIdx.x * CHUNK, end = min(i0 + CHUNK, a.m);
        for (int i = i0 + threadIdx.x; i < end; i += THREADS) {
            commit_pair(commit, frac, i, a.x_new, a.x, a.avg_x, a.out_x,
                        a.out_avg_x);
            commit_pair(commit, frac, i, a.aty_new, a.aty, a.avg_aty,
                        a.out_aty, a.out_avg_aty);
        }
    } else {
        const int i0 = (blockIdx.x - col_blocks) * CHUNK;
        const int end = min(i0 + CHUNK, a.n);
        for (int i = i0 + threadIdx.x; i < end; i += THREADS) {
            commit_pair(commit, frac, i, a.y_new, a.y, a.avg_y, a.out_y,
                        a.out_avg_y);
            commit_pair(commit, frac, i, a.ax_new, a.ax, a.avg_ax,
                        a.out_ax, a.out_avg_ax);
        }
    }
    if (blockIdx.x == 0 && threadIdx.x == 0) {
        // accepted or not, eta_next is the next attempt's step size
        *a.out_step_size = eta_next;
        *a.out_sum_weights = commit ? sum_w : *a.sum_weights;
        *a.out_iters = *a.iters + (commit ? 1 : 0);
        *a.out_steps = *a.steps + (commit ? 1 : 0);
        *a.out_attempts = *a.attempts + (commit ? attempts : 0);
        const bool bad = !isfinite(xx) || !isfinite(yy);
        *a.out_numerical_error =
            (uint8_t)(*a.numerical_error != 0 || (commit && bad));
        *a.out_pending = commit ? 0 : attempts;
    }
}

template <typename K, typename A>
cudaError_t launch(K kernel, int grid, const A& args, void* stream)
{
    kernel<<<grid < 1 ? 1 : grid, THREADS, 0, (cudaStream_t)stream>>>(args);
    return cudaGetLastError();
}

int blocks_of(int n) { return (n + CHUNK - 1) / CHUNK; }

template <typename T>
cudaError_t primal(int m, int n_sent, int chunk, int blocks, const void* x,
                   const void* aty, const void* c, const void* lv,
                   const void* uv, const void* step_size,
                   const void* primal_weight, void* x_new, void* sigma,
                   void* parts, const void* lc_fin, const void* uc_fin,
                   const void* lc0, const void* uc0, void* lc0m, void* uc0m,
                   void* stream)
{
    PrimalArgs<T> a{m, n_sent, chunk, blocks,
                    (const T*)x, (const T*)aty, (const T*)c, (const T*)lv,
                    (const T*)uv, (const T*)step_size,
                    (const T*)primal_weight, (T*)x_new, (T*)sigma,
                    (T*)parts, (const uint8_t*)lc_fin,
                    (const uint8_t*)uc_fin, (const T*)lc0, (const T*)uc0,
                    (T*)lc0m, (T*)uc0m};
    return launch(pdhg_primal_kernel<T>, blocks + blocks_of(n_sent), a,
                  stream);
}

template <typename T, bool PROX>
cudaError_t rows(int n, int chunk, int blocks, const void* ax_new,
                 const void* ax, const void* y, void* y_new, void* parts,
                 const void* lc0, const void* uc0, const void* sigma,
                 const void* lc_fin, const void* uc_fin, void* stream)
{
    RowArgs<T> a{n, chunk, blocks, (const T*)ax_new, (const T*)ax,
                 (const T*)y, (T*)y_new, (T*)parts, (const T*)lc0,
                 (const T*)uc0, (const T*)sigma, (const uint8_t*)lc_fin,
                 (const uint8_t*)uc_fin};
    return launch(pdhg_rows_kernel<T, PROX>, blocks, a, stream);
}

}  // namespace

extern "C" {

// x_new = clamp(x - tau (c - aty), lv, uv) over the m columns and sigma
// (0-d); parts (2 * blocks,) gets each block's sums of dx.dx, then of
// x_new.x_new, block b over columns [b * chunk, (b + 1) * chunk). With
// n_sent > 0, lc0m and uc0m (n_sent,) get lc0 and uc0 where lc_fin and
// uc_fin are set and -/+ the sentinel elsewhere (otherwise those five
// pointers are not read and may be null).
int pdhg_primal(int dbl, int m, int n_sent, int chunk, int blocks,
                const void* x, const void* aty, const void* c, const void* lv,
                const void* uv, const void* step_size,
                const void* primal_weight, void* x_new, void* sigma,
                void* parts, const void* lc_fin, const void* uc_fin,
                const void* lc0, const void* uc0, void* lc0m, void* uc0m,
                void* stream)
{
    return (int)(dbl ? primal<double>(m, n_sent, chunk, blocks, x, aty, c,
                                      lv, uv, step_size, primal_weight,
                                      x_new, sigma, parts, lc_fin, uc_fin,
                                      lc0, uc0, lc0m, uc0m, stream)
                     : primal<float>(m, n_sent, chunk, blocks, x, aty, c,
                                     lv, uv, step_size, primal_weight,
                                     x_new, sigma, parts, lc_fin, uc_fin,
                                     lc0, uc0, lc0m, uc0m, stream));
}

// y_new (n,) from the dual prox at ax~ = 2 ax_new - ax, and parts (3 *
// blocks,): each block's sums of dy.(ax_new - ax), dy.dy and y_new.y_new.
int pdhg_dual(int dbl, int n, int chunk, int blocks, const void* ax_new,
              const void* ax, const void* y, const void* lc_fin,
              const void* uc_fin, const void* lc0, const void* uc0,
              const void* sigma, void* y_new, void* parts, void* stream)
{
    return (int)(dbl ? rows<double, true>(n, chunk, blocks, ax_new, ax, y,
                                          y_new, parts, lc0, uc0, sigma,
                                          lc_fin, uc_fin, stream)
                     : rows<float, true>(n, chunk, blocks, ax_new, ax, y,
                                         y_new, parts, lc0, uc0, sigma,
                                         lc_fin, uc_fin, stream));
}

// parts (3 * blocks,) as pdhg_dual writes them, from a y_new computed
// elsewhere (the fused row pass).
int pdhg_row_sums(int dbl, int n, int chunk, int blocks, const void* ax_new,
                  const void* ax, const void* y, const void* y_new,
                  void* parts, void* stream)
{
    void* yn = const_cast<void*>(y_new);  // read only
    return (int)(dbl ? rows<double, false>(n, chunk, blocks, ax_new, ax, y,
                                           yn, parts, nullptr, nullptr,
                                           nullptr, nullptr, nullptr, stream)
                     : rows<float, false>(n, chunk, blocks, ax_new, ax, y,
                                          yn, parts, nullptr, nullptr,
                                          nullptr, nullptr, nullptr, stream));
}

// The attempt's step-size decision and the commit: parts (2 bx + 3 by,)
// as pdhg_primal and pdhg_dual or pdhg_row_sums wrote them; the
// candidate's x_new, y_new, ax_new and aty_new; the input state's fields
// and attempt index; the output state's fields and next attempt index,
// none of which may alias an input.
int pdhg_commit(int dbl, int m, int n, int bx, int by, int max_attempts,
                double reduction_power, double growth_power,
                const void* parts, const void* x_new, const void* y_new,
                const void* ax_new, const void* aty_new, const void* x,
                const void* y, const void* ax, const void* aty,
                const void* avg_x, const void* avg_y, const void* avg_ax,
                const void* avg_aty, const void* step_size,
                const void* primal_weight, const void* sum_weights,
                const long long* iters, const long long* steps,
                const long long* attempts, const void* numerical_error,
                const long long* pending, void* out_x, void* out_y,
                void* out_ax, void* out_aty, void* out_avg_x,
                void* out_avg_y, void* out_avg_ax, void* out_avg_aty,
                void* out_step_size, void* out_sum_weights,
                long long* out_iters, long long* out_steps,
                long long* out_attempts, void* out_numerical_error,
                long long* out_pending, void* stream)
{
    const int grid = blocks_of(m) + blocks_of(n);
#define PDHG_COMMIT_ARGS(T)                                                  \
    CommitArgs<T>{m, n, bx, by, max_attempts, (T)reduction_power,           \
                  (T)growth_power, (const T*)parts, (const T*)x_new,        \
                  (const T*)y_new, (const T*)ax_new, (const T*)aty_new,     \
                  (const T*)x, (const T*)y, (const T*)ax, (const T*)aty,    \
                  (const T*)avg_x, (const T*)avg_y, (const T*)avg_ax,       \
                  (const T*)avg_aty, (const T*)step_size,                   \
                  (const T*)primal_weight, (const T*)sum_weights, iters,    \
                  steps, attempts, pending,                                 \
                  (const uint8_t*)numerical_error, (T*)out_x, (T*)out_y,    \
                  (T*)out_ax, (T*)out_aty, (T*)out_avg_x, (T*)out_avg_y,    \
                  (T*)out_avg_ax, (T*)out_avg_aty, (T*)out_step_size,       \
                  (T*)out_sum_weights, out_iters, out_steps, out_attempts,  \
                  out_pending, (uint8_t*)out_numerical_error}
    cudaError_t err =
        dbl ? launch(pdhg_commit_kernel<double>, grid,
                     PDHG_COMMIT_ARGS(double), stream)
            : launch(pdhg_commit_kernel<float>, grid,
                     PDHG_COMMIT_ARGS(float), stream);
#undef PDHG_COMMIT_ARGS
    return (int)err;
}

// Launches of kernel `which` (0 pdhg_primal, 1 pdhg_dual, 2 pdhg_row_sums,
// 3 pdhg_commit) that have run on the current device since its last
// reset, into *out, once the device's work so far has finished. With
// reset nonzero the count is then set back to zero.
int pdhg_step_launches(int which, int reset, unsigned long long* out)
{
    if (which < 0 || which >= N_KERNELS) return (int)cudaErrorInvalidValue;
    const size_t at = which * sizeof(unsigned long long);
    cudaError_t err = cudaDeviceSynchronize();
    if (err == cudaSuccess)
        err = cudaMemcpyFromSymbol(out, g_step_launches, sizeof *out, at);
    if (err == cudaSuccess && reset) {
        const unsigned long long zero = 0;
        err = cudaMemcpyToSymbol(g_step_launches, &zero, sizeof zero, at);
    }
    return (int)err;
}

const char* cuda_error_string(int err)
{
    return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
