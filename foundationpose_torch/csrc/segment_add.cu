// Dense segment-adds of the hash-grid backward for Hopper (sm_90a):
// K3 and K4.
//
// Replace the Pallas TPU kernels of foundationpose_tpu/ops/pallas_scatter.py:
//   K3  _seg_add_kernel (launched by _run_block_kernel, reached from
//       sorted_segment_add_planes): out[idx[i], c] += upd[c, i];
//   K4  _seg_add_factored_kernel (launched by _segment_add_factored, reached
//       from factored_segment_add): out[idx[l, n], q*C + c] +=
//       bf16_rne(w[q, l, n]) * g[c, l, n].
// The TPU kernels sort the update stream, split each update into hi and lo
// bf16 halves and reduce each 1024-row table block with a one-hot matrix
// product, because a scatter-add serializes on the TPU. None of that is
// needed here: the card adds f32 atomically in its L2.
//
// K3 merges runs of one row before they reach L2. Its one caller, the
// "cuda"-layout hash-grid backward, sends the (point, level, corner) rows of
// the samples ray by ray, 16 levels x 8 corners = 128 updates a point:
// consecutive points of a ray share cell corners, so the same row recurs
// every 128 updates, at the coarse levels for dozens of points. Each warp
// walks a span of S consecutive updates 128 at a time (lane l takes entries
// 4l .. 4l + 3 of each step with 16-byte streaming loads: the warp reads 512
// contiguous bytes a plane) and keeps, per entry, the current run of one row
// in registers: an update whose row equals the run's is added there, any
// other row first sends the run to the table with one fire-and-forget
// reduction, red.global.add.v2.f32 for C = 2 (v4 where 4 divides C, scalar
// otherwise). Indices outside [0, T) are dropped. On a real step's stream
// ~28% of the in-range updates end a run at S = 4096 (~35% at S = 1024);
// the stream is never reordered, and any order gives the same sums.
//
// What bounds it: device memory. The 805 MB stream is read once; the
// reductions land on a few million distinct rows of a 289 MB table that
// the wrapper has just zeroed and that is six times the 50 MB L2, so each
// touched 32-byte sector is read back and written again. The number of
// reductions barely matters: a shorter span, with more of them, ran faster
// (fewer rays' rows are live at once). Shared-memory hash tables that
// merge a whole chunk (probes by atomicCAS, values by shared f32 atomicAdd,
// a compare-and-swap loop on sm_90, or by a counting sort by slot) spent
// more time in the shared-memory atomics of the coarse levels' hot rows
// than the old one-atomic-per-update kernel spent in all.
//
// K4 runs one thread per (level, point): it loads the index, the nw weights
// (rounded to bf16 as the JAX package rounds them) and the C cotangents and
// forms the nw*C products in f32; the products never reach device memory.
// Each warp then issues its atomics cooperatively (warp_add_rows). What
// bounds it: the atomics. At the NeRF shapes the updates fall on random rows
// of a table of 36M rows (2.3 GB for its 16 columns), far beyond the 50 MB
// L2, so each touched row costs memory transactions. A first version in
// which each thread added its own row's columns made every atomic
// instruction of a warp touch 32 rows, and K4 ran at twice the time of the
// plain index_add_ (which adds a row's columns from neighbouring threads).
// Staging the values in shared memory lets a warp add 32 / width rows per
// instruction, each row's columns from neighbouring lanes.
//
// In both the order of the additions changes from run to run, so the sums
// agree with a sequential sum only to rounding (a bound per row of 1e-5 of
// the row's sum of |update| holds them). Both launch on the caller's stream;
// the caller zeroes the output.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

#define NT 256
#define MAX_NW 8
#define MAX_C 8
#define MAX_WIDTH 32  // columns of the output table a launch may have

// ------------------------------------------------------------------- K3

#define K3_NT 256
#define K3_ROW 128  // updates a warp loads in one step: 32 lanes x 4

__device__ __forceinline__ void red_v2(float* p, float a, float b) {
    asm volatile("red.global.add.v2.f32 [%0], {%1, %2};" ::"l"(p), "f"(a), "f"(b) : "memory");
}

__device__ __forceinline__ void red_v4(float* p, float a, float b, float c, float d) {
    asm volatile("red.global.add.v4.f32 [%0], {%1, %2, %3, %4};" ::"l"(p), "f"(a), "f"(b), "f"(c),
                 "f"(d)
                 : "memory");
}

// W consecutive channels of one row into the table with one reduction (the
// launch makes W = 2 or 4 only where the address is 8- or 16-byte aligned).
template <int W>
__device__ __forceinline__ void red_w(float* p, const float (&v)[W]) {
    if constexpr (W == 4) {
        red_v4(p, v[0], v[1], v[2], v[3]);
    } else if constexpr (W == 2) {
        red_v2(p, v[0], v[1]);
    } else {
        atomicAdd(p, v[0]);  // result unused: a reduction
    }
}

// Four consecutive entries of a stream from `p`: one 16-byte streaming load
// when `full`, else scalar loads of the first `left` and `fill` after them.
template <typename V, typename T4>
__device__ __forceinline__ void load4(V (&x)[4], const V* __restrict__ p, bool full, long long left,
                                      V fill) {
    if (full) {
        const T4 q = __ldcs(reinterpret_cast<const T4*>(p));
        x[0] = q.x, x[1] = q.y, x[2] = q.z, x[3] = q.w;
    } else {
#pragma unroll
        for (int j = 0; j < 4; ++j) x[j] = j < left ? __ldcs(p + j) : fill;
    }
}

// One step of a lane: the rows and the W channels' values of its four
// entries of one 128-update step of the stream.
template <int W>
struct K3Step {
    int r[4];
    float v[W][4];
};

template <int W>
__device__ __forceinline__ void k3_load(K3Step<W>& x, const int* __restrict__ idx,
                                        const float* __restrict__ upd, long long M, int c0,
                                        long long p, long long end, bool vec) {
    const bool full = vec && p + 4 <= end;
    load4<int, int4>(x.r, idx + p, full, end - p, -1);
#pragma unroll
    for (int w = 0; w < W; ++w) load4<float, float4>(x.v[w], upd + (long long)(c0 + w) * M + p, full, end - p, 0.f);
}

// Channels [c0, c0 + W) of the stream. Each warp takes a span of S
// consecutive updates (S a multiple of 128) and walks it 128 updates a step,
// lane l loading entries 4l .. 4l + 3 of each step with 16-byte streaming
// loads (the warp reads 512 contiguous bytes a plane). Each lane keeps one
// run per entry (its row and the sum of its values): an entry whose row
// equals its run's row is added in registers, any other row first sends the
// run to the table with one reduction. Rows outside [0, T) are dropped.
// vec: idx and upd are 16-byte aligned and 4 divides M, so every load of
// four is.
template <int W>
__global__ void __launch_bounds__(K3_NT)
seg_add_planes_kernel(const int* __restrict__ idx, const float* __restrict__ upd,
                      float* __restrict__ out, long long M, int C, int c0, int T, long long S,
                      int vec) {
    const long long warp = (long long)blockIdx.x * (K3_NT / 32) + (threadIdx.x >> 5);
    const long long first = warp * S;
    if (first >= M) return;
    const long long end = min(first + S, M);
    int run_row[4] = {-1, -1, -1, -1};
    float run[4][W] = {};
    K3Step<W> x;
    long long p = first + 4 * (threadIdx.x & 31);
    k3_load<W>(x, idx, upd, M, c0, p, end, vec);
    for (; p < end; p += K3_ROW) {
        const K3Step<W> cur = x;
        if (p + K3_ROW < end) k3_load<W>(x, idx, upd, M, c0, p + K3_ROW, end, vec);  // the next step's, in flight
#pragma unroll
        for (int j = 0; j < 4; ++j) {
            const int row = (cur.r[j] >= 0 && cur.r[j] < T) ? cur.r[j] : -1;
            if (row == run_row[j]) {
#pragma unroll
                for (int w = 0; w < W; ++w) run[j][w] += cur.v[w][j];
            } else {
                if (run_row[j] >= 0) red_w<W>(out + (long long)run_row[j] * C + c0, run[j]);
                run_row[j] = row;
#pragma unroll
                for (int w = 0; w < W; ++w) run[j][w] = cur.v[w][j];
            }
        }
    }
#pragma unroll
    for (int j = 0; j < 4; ++j)
        if (run_row[j] >= 0) red_w<W>(out + (long long)run_row[j] * C + c0, run[j]);
}

// ------------------------------------------------------------------- K4

// Each thread stages its row index and its `width` values in shared memory;
// then its warp issues the atomics cooperatively, lane k of a pass adding
// element k of the warp's (32, width) block, so that neighbouring lanes add
// into neighbouring columns of one row. One thread adding all the columns
// of its own row would make every atomic instruction of a warp touch 32
// rows (32 memory transactions); here it touches 32 / width rows. Rows of
// the staging block are padded to width + 1 words against bank conflicts.
// rows[r] < 0 marks a dropped entry.
__device__ __forceinline__ void warp_add_rows(const float* vals, const int* rows, int width,
                                             float* __restrict__ out) {
    __syncwarp();
    const int lane = threadIdx.x & 31;
    for (int k = lane; k < 32 * width; k += 32) {
        const int r = k / width, col = k - r * width;
        const int row = rows[r];
        if (row >= 0) atomicAdd(out + (long long)row * width + col, vals[r * (width + 1) + col]);
    }
}

// Staging of one warp: 32 rows of (width + 1) floats, then 32 row indices.
__device__ __forceinline__ float* warp_stage(int width) {
    extern __shared__ float smem[];
    return smem + (threadIdx.x >> 5) * (32 * (width + 1) + 32);
}

__global__ void factored_seg_add_kernel(const int* __restrict__ idx, const float* __restrict__ w,
                                        const float* __restrict__ g, float* __restrict__ out,
                                        long long LN, int nw, int C, int T) {
    const int width = nw * C;
    float* vals = warp_stage(width);
    int* rows = reinterpret_cast<int*>(vals + 32 * (width + 1));
    const int lane = threadIdx.x & 31;
    const long long e = (long long)blockIdx.x * NT + threadIdx.x;
    int j = -1;
    if (e < LN) {
        j = idx[e];
        if (j < 0 || j >= T) j = -1;
    }
    rows[lane] = j;
    if (j >= 0) {
        float gc[MAX_C];
#pragma unroll
        for (int c = 0; c < MAX_C; ++c) gc[c] = c < C ? g[(long long)c * LN + e] : 0.f;
        float* mine = vals + lane * (width + 1);
#pragma unroll
        for (int q = 0; q < MAX_NW; ++q) {
            if (q >= nw) break;
            const float wq = __bfloat162float(__float2bfloat16_rn(w[(long long)q * LN + e]));
#pragma unroll
            for (int c = 0; c < MAX_C; ++c)
                if (c < C) mine[q * C + c] = __fmul_rn(wq, gc[c]);
        }
    }
    warp_add_rows(vals, rows, width, out);
}

static unsigned int n_blocks(long long n) { return (unsigned int)((n + NT - 1) / NT); }
static size_t stage_bytes(int width) { return (size_t)(NT / 32) * (32 * (width + 1) + 32) * 4; }

template <int W>
static cudaError_t k3_launch(const void* idx, const void* upd, void* out, long long M, int C, int T,
                             long long S, int vec, cudaStream_t stream) {
    const long long warps = (M + S - 1) / S, blocks = (warps + K3_NT / 32 - 1) / (K3_NT / 32);
    if (blocks > 0x7fffffffLL) return cudaErrorInvalidValue;
    for (int c0 = 0; c0 < C; c0 += W) {
        seg_add_planes_kernel<W><<<(unsigned int)blocks, K3_NT, 0, stream>>>(
            (const int*)idx, (const float*)upd, (float*)out, M, C, c0, T, S, vec);
        const cudaError_t err = cudaGetLastError();
        if (err != cudaSuccess) return err;
    }
    return cudaSuccess;
}

// idx (M,) int32, upd (C, M) f32, out (T, C) f32 zeroed by the caller; spans
// of S updates a warp, W channels a pass (the wrapper's _k3_geometry: W = 4
// where 4 divides C, else 2 where 2 does, else 1, so that each reduction is
// aligned).
extern "C" int fp_segment_add_planes_launch(const void* idx, const void* upd, void* out,
                                            long long M, int C, int T, long long S, int W,
                                            void* stream) {
    if (M <= 0) return 0;
    if (C < 1 || C > MAX_WIDTH || S < K3_ROW || S % K3_ROW != 0 || (W != 1 && W != 2 && W != 4) ||
        C % W != 0 || (W == 4 && C % 4 != 0) || (W == 2 && C % 2 != 0))
        return (int)cudaErrorInvalidValue;
    const int vec = ((reinterpret_cast<uintptr_t>(idx) | reinterpret_cast<uintptr_t>(upd)) % 16 == 0) &&
                    M % 4 == 0;
    cudaStream_t st = (cudaStream_t)stream;
    const cudaError_t err = W == 4   ? k3_launch<4>(idx, upd, out, M, C, T, S, vec, st)
                            : W == 2 ? k3_launch<2>(idx, upd, out, M, C, T, S, vec, st)
                                     : k3_launch<1>(idx, upd, out, M, C, T, S, vec, st);
    return (int)err;
}

// idx (L*N,) int32, w (nw, L*N) f32, g (C, L*N) f32, out (T, nw*C) f32
// zeroed by the caller.
extern "C" int fp_factored_segment_add_launch(const void* idx, const void* w, const void* g,
                                              void* out, long long LN, int nw, int C, int T,
                                              void* stream) {
    if (LN <= 0) return 0;
    if (nw < 1 || nw > MAX_NW || C < 1 || C > MAX_C || nw * C > MAX_WIDTH ||
        (LN + NT - 1) / NT > 0x7fffffffLL)
        return (int)cudaErrorInvalidValue;
    factored_seg_add_kernel<<<n_blocks(LN), NT, stage_bytes(nw * C), (cudaStream_t)stream>>>(
        (const int*)idx, (const float*)w, (const float*)g, (float*)out, LN, nw, C, T);
    return (int)cudaGetLastError();
}
