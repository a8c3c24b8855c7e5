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
// needed here: the card adds f32 atomically in its L2. K3 runs one thread
// per update: it drops indices outside [0, T) and stages its C channels.
// K4 runs one thread per (level, point): it loads the index, the nw weights
// (rounded to bf16 as the JAX package rounds them) and the C cotangents and
// forms the nw*C products in f32; the products never reach device memory.
// In both, each warp then issues its atomics cooperatively (warp_add_rows).
//
// What bounds them: the atomics. At the NeRF shapes the updates fall on
// random rows of a table of 36M rows (0.3 GB for K3's C = 2, 2.3 GB for K4's
// 16 columns), far beyond the 50 MB L2, so each touched row costs memory
// transactions. A first version in which each thread added its own row's
// columns made every atomic instruction of a warp touch 32 rows, and K4 ran
// at twice the time of the plain index_add_ (which adds a row's columns
// from neighbouring threads). Staging the values in shared memory lets a
// warp add 32 / width rows per instruction, each row's columns from
// neighbouring lanes. The order of the additions changes from run to run,
// so the sums agree with a sequential sum only to rounding (a bound per row
// of 1e-5 of the row's sum of |update| holds them).
//
// The result of atomicAdd is unused, so the compiler emits fire-and-forget
// reductions (RED). Both launch on the caller's stream; the caller zeroes
// the output.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#define NT 256
#define MAX_NW 8
#define MAX_C 8
#define MAX_WIDTH 32  // columns of the output table a launch may have

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

__global__ void seg_add_planes_kernel(const int* __restrict__ idx, const float* __restrict__ upd,
                                      float* __restrict__ out, long long M, int C, int T) {
    float* vals = warp_stage(C);
    int* rows = reinterpret_cast<int*>(vals + 32 * (C + 1));
    const int lane = threadIdx.x & 31;
    const long long i = (long long)blockIdx.x * NT + threadIdx.x;
    int j = -1;
    if (i < M) {
        j = idx[i];
        if (j < 0 || j >= T) j = -1;
    }
    rows[lane] = j;
    if (j >= 0)
        for (int c = 0; c < C; ++c) vals[lane * (C + 1) + c] = upd[(long long)c * M + i];
    warp_add_rows(vals, rows, C, out);
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

// idx (M,) int32, upd (C, M) f32, out (T, C) f32 zeroed by the caller.
extern "C" int fp_segment_add_planes_launch(const void* idx, const void* upd, void* out,
                                            long long M, int C, int T, void* stream) {
    if (M <= 0) return 0;
    if (C < 1 || C > MAX_WIDTH || (M + NT - 1) / NT > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
    seg_add_planes_kernel<<<n_blocks(M), NT, stage_bytes(C), (cudaStream_t)stream>>>(
        (const int*)idx, (const float*)upd, (float*)out, M, C, T);
    return (int)cudaGetLastError();
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
