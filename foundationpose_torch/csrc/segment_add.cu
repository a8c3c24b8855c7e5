// Dense segment-adds of the hash-grid backward for Hopper (sm_90a):
// K3 and K4.
//
// Replace the Pallas TPU kernels of foundationpose_tpu/ops/pallas_scatter.py:
//   K3  _seg_add_kernel (launched by _run_block_kernel, reached from
//       sorted_segment_add_planes): out[idx[i], c] += upd[c, i];
//   K4  _seg_add_factored_kernel (launched by _segment_add_factored, reached
//       from factored_segment_add): there out[idx[l, n], q*C + c] +=
//       bf16_rne(w[q, l, n]) * g[c, l, n], a (T, nw*C) block that the JAX
//       package then rolls back per level by the corner shifts; here the
//       same products go straight into the rows the rolls move them to,
//       out[(idx - off[l] + shift[l, q]) mod size[l] + off[l], c], a (T, C)
//       table.
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
// K4 adds the outer products bf16(w[q]) * g[c] of each (point, level) entry
// into the eight corner rows of the "oct" hash grid: corner q of an entry
// whose base row is b lies at (b - off + shift[q]) mod size + off, with the
// level's first row off, its size and its corner shifts passed by value.
// Each thread walks P consecutive points of one level (threads of one warp
// take neighbouring levels, so the warp's loads of the point-major (N, L)
// inputs are contiguous) and keeps the current run of one base row in
// registers: the samples of a ray are consecutive points, and at the coarse
// levels neighbouring samples share a cell. A new base row first sends the
// run's nw corners to the table, red.global.add.v2.f32 a corner for C = 2
// (one v4 for corners q, q + 1 that land in one aligned 16-byte pair of
// rows). Entries whose base row lies outside their level are dropped.
// What bounds it: the reductions. The rows of the fine levels are random in
// a 289 MB table, six times the 50 MB L2, so each reduction's sector is read
// and written back; the inputs (44 bytes an entry) are read once.
//
// In both the order of the additions changes from run to run, so the sums
// agree with a sequential sum only to rounding (a bound per row of 1e-5 of
// the row's sum of |update| holds them). Both launch on the caller's stream;
// the caller zeroes the output.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

#define MAX_WIDTH 32  // K3: columns of the output table a launch may have

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

#define K4_NT 256
#define K4_MAX_L 32  // levels
#define MAX_NW 8     // weights (corners) an entry
#define MAX_C 8      // channels a row

// A launch's arguments, passed by value in the kernel's parameter space.
struct K4Args {
    const int* idx;           // (N, L) base rows
    const float* w[MAX_NW];   // nw weight planes, each (N, L)
    const float* g;           // (N, L, C) cotangents
    float* out;               // (T, C), zeroed by the caller
    long long N;
    int L, nw, P;             // P: consecutive points a thread walks
    int off[K4_MAX_L], size[K4_MAX_L];
    int shift[K4_MAX_L][MAX_NW];  // each in [0, size)
};

// C channels of one row with one reduction per 4 (or 2) aligned channels.
template <int C>
__device__ __forceinline__ void red_row(float* p, const float (&v)[C]) {
    if constexpr (C % 4 == 0) {
#pragma unroll
        for (int c = 0; c < C; c += 4) red_v4(p + c, v[c], v[c + 1], v[c + 2], v[c + 3]);
    } else if constexpr (C % 2 == 0) {
#pragma unroll
        for (int c = 0; c < C; c += 2) red_v2(p + c, v[c], v[c + 1]);
    } else {
#pragma unroll
        for (int c = 0; c < C; ++c) atomicAdd(p + c, v[c]);  // result unused: a reduction
    }
}

// Two neighbouring rows of C = 2 channels, 16-byte aligned, in one reduction.
template <int C>
__device__ __forceinline__ void red_pair(float* p, const float (&u)[C], const float (&v)[C]) {
    if constexpr (C == 2) red_v4(p, u[0], u[1], v[0], v[1]);
}

// One entry: its base row, its nw weights and its C cotangents.
template <int C>
struct K4Entry {
    int b;
    float w[MAX_NW];
    float g[C];
};

template <int C>
__device__ __forceinline__ void k4_load(K4Entry<C>& x, const K4Args& a, long long e) {
    x.b = __ldcs(a.idx + e);
#pragma unroll
    for (int q = 0; q < MAX_NW; ++q) x.w[q] = q < a.nw ? __ldcs(a.w[q] + e) : 0.f;
#pragma unroll
    for (int c = 0; c < C; ++c) x.g[c] = __ldcs(a.g + e * C + c);
}

// The run's corners into the table: corner q of base row `run` (inside the
// level [off, off + size)) at (run - off + sh[q]) mod size + off.
template <int C>
__device__ __forceinline__ void k4_flush(float* __restrict__ out, int run, int off, int size,
                                         const int (&sh)[MAX_NW], int nw,
                                         const float (&acc)[MAX_NW][C]) {
    int rows[MAX_NW];
#pragma unroll
    for (int q = 0; q < MAX_NW; ++q) {
        int r = run - off + sh[q];  // < 2 size: the launch takes sizes up to 2^30
        if (r >= size) r -= size;
        rows[q] = r + off;
    }
#pragma unroll
    for (int q = 0; q < MAX_NW; q += 2) {
        if (q >= nw) break;
        if (q + 1 >= nw) {
            red_row<C>(out + (long long)rows[q] * C, acc[q]);
        } else if (C == 2 && rows[q + 1] == rows[q] + 1 && (rows[q] & 1) == 0) {
            red_pair<C>(out + (long long)rows[q] * C, acc[q], acc[q + 1]);
        } else {
            red_row<C>(out + (long long)rows[q] * C, acc[q]);
            red_row<C>(out + (long long)rows[q + 1] * C, acc[q + 1]);
        }
    }
}

// Thread t takes level t mod L and points [P (t / L), P (t / L) + P): entry
// e = n L + level of the point-major inputs. Each entry's products are
// __fmul_rn(bf16_rne(w[q]), g[c]) in f32, as the plain version forms them;
// a run sums them in f32 registers before its reductions.
template <int C>
__global__ void __launch_bounds__(K4_NT) factored_seg_add_kernel(const __grid_constant__ K4Args a) {
    const long long t = (long long)blockIdx.x * K4_NT + threadIdx.x;
    const long long chunk = t / a.L;
    const int lv = (int)(t - chunk * a.L);
    const long long n0 = chunk * a.P;
    if (n0 >= a.N) return;
    const long long n1 = min(n0 + a.P, a.N);
    const int off = a.off[lv], size = a.size[lv];
    int sh[MAX_NW];
#pragma unroll
    for (int q = 0; q < MAX_NW; ++q) sh[q] = q < a.nw ? a.shift[lv][q] : 0;
    int run = -1;
    float acc[MAX_NW][C] = {};
    K4Entry<C> cur, nxt;
    k4_load<C>(cur, a, n0 * a.L + lv);
    for (long long n = n0; n < n1; ++n) {
        if (n + 1 < n1) k4_load<C>(nxt, a, (n + 1) * a.L + lv);  // the next point's, in flight
        const int b = cur.b;
        if (b >= off && b - off < size) {
            const bool same = b == run;
            if (!same) {
                if (run >= 0) k4_flush<C>(a.out, run, off, size, sh, a.nw, acc);
                run = b;
            }
#pragma unroll
            for (int q = 0; q < MAX_NW; ++q) {
                const float wq = __bfloat162float(__float2bfloat16_rn(cur.w[q]));
#pragma unroll
                for (int c = 0; c < C; ++c) {
                    const float p = __fmul_rn(wq, cur.g[c]);
                    acc[q][c] = same ? acc[q][c] + p : p;
                }
            }
        }
        cur = nxt;
    }
    if (run >= 0) k4_flush<C>(a.out, run, off, size, sh, a.nw, acc);
}

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

// idx (N, L) int32 base rows, w nw pointers to (N, L) f32 planes, g (N, L, C)
// f32, out (T, C) f32 zeroed by the caller; levels (L, 2 + nw) int32 rows of
// (first row, size, nw corner shifts in [0, size)); P consecutive points a
// thread.
extern "C" int fp_factored_segment_add_launch(const void* idx, const void* const* w, const void* g,
                                              void* out, long long N, int L, int nw, int C,
                                              const int* levels, int P, void* stream) {
    if (N <= 0) return 0;
    if (L < 1 || L > K4_MAX_L || nw < 1 || nw > MAX_NW || C < 1 || C > MAX_C || P < 1)
        return (int)cudaErrorInvalidValue;
    const long long threads = (N + P - 1) / P * L, blocks = (threads + K4_NT - 1) / K4_NT;
    if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
    K4Args a = {};
    a.idx = (const int*)idx;
    for (int q = 0; q < nw; ++q) a.w[q] = (const float*)w[q];
    a.g = (const float*)g;
    a.out = (float*)out;
    a.N = N, a.L = L, a.nw = nw, a.P = P;
    for (int l = 0; l < L; ++l) {
        const int* row = levels + l * (2 + nw);
        a.off[l] = row[0], a.size[l] = row[1];
        if (row[0] < 0 || row[1] < 1 || row[1] > (1 << 30) || (long long)row[0] + row[1] > 0x7fffffffLL)
            return (int)cudaErrorInvalidValue;
        for (int q = 0; q < nw; ++q) {
            if (row[2 + q] < 0 || row[2 + q] >= row[1]) return (int)cudaErrorInvalidValue;
            a.shift[l][q] = row[2 + q];
        }
    }
    cudaStream_t st = (cudaStream_t)stream;
    const unsigned int nb = (unsigned int)blocks;
    switch (C) {
        case 1: factored_seg_add_kernel<1><<<nb, K4_NT, 0, st>>>(a); break;
        case 2: factored_seg_add_kernel<2><<<nb, K4_NT, 0, st>>>(a); break;
        case 3: factored_seg_add_kernel<3><<<nb, K4_NT, 0, st>>>(a); break;
        case 4: factored_seg_add_kernel<4><<<nb, K4_NT, 0, st>>>(a); break;
        case 5: factored_seg_add_kernel<5><<<nb, K4_NT, 0, st>>>(a); break;
        case 6: factored_seg_add_kernel<6><<<nb, K4_NT, 0, st>>>(a); break;
        case 7: factored_seg_add_kernel<7><<<nb, K4_NT, 0, st>>>(a); break;
        default: factored_seg_add_kernel<8><<<nb, K4_NT, 0, st>>>(a); break;
    }
    return (int)cudaGetLastError();
}
