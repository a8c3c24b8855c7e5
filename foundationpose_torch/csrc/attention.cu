// Fused multi-head self-attention core for Hopper (sm_90a), forward only.
//
// Replaces the Pallas TPU kernel foundationpose_tpu/ops/attention.py
// (_mha_kernel, launched by _attention_core_pallas). At the RefineNet /
// ScoreNet head shape (B=252, L=400, D=512, 4 heads of 128) the plain
// form writes a (B, H, L, L) f32 logits tensor of 645 MB per layer and
// reads it back through a softmax; that traffic is what bounds it. This
// kernel never writes the logits: flash form, one block per (64-query
// tile, head, batch), q/k/v read straight from the packed (B, L, 3D)
// input at the head's column offset, keys in 64-row tiles staged in
// shared memory, the softmax statistics in registers, and the head's lanes
// of the (B, L, D) output written once. Keys at or past L are masked.
//
// Types: bf16 input (the network's compute type): QK^T and the softmax
// in f32, the normalized weights rounded to bf16 before the product with
// V as the TPU kernel rounds its weights, sums in f32, bf16 output. f32
// input: everything in f32, so an f32 pipeline on the card never meets a
// hidden downcast. Head width 1..128.
//
// This first version computes on the CUDA cores (FMA, register-blocked
// 4x4 logits and 4x8 outputs per thread) and computes QK^T twice (see
// mha_kernel); the tensor-core (wgmma/mma) version is later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

#define BQ 64
#define BK 64
#define DMAX 128
#define NT 256  // 16 x 16 threads

template <typename T> struct Pad;
template <> struct Pad<float> { static constexpr int v = 1; };          // 129 words
template <> struct Pad<__nv_bfloat16> { static constexpr int v = 2; };  // 65 words

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ void from_f(float* p, float x) { *p = x; }
__device__ __forceinline__ void from_f(__nv_bfloat16* p, float x) { *p = __float2bfloat16(x); }
__device__ __forceinline__ float round_p(float p, float) { return p; }
__device__ __forceinline__ float round_p(float p, __nv_bfloat16) {
    return __bfloat162float(__float2bfloat16(p));
}

// Logits of the staged key tile for rows ty + 16i, keys tx + 16j, divided
// by sqrt(dh) as the plain path divides them; keys at or past L -> -inf.
template <typename T, int DP>
__device__ __forceinline__ void tile_logits(const T* Qs, const T* Ks, int dh, int ty, int tx,
                                            int k0, int L, float sqrt_dh, float (&s)[4][4]) {
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
    for (int d = 0; d < dh; ++d) {
        float qv[4], kv[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) qv[i] = to_f(Qs[(ty + 16 * i) * DP + d]);
#pragma unroll
        for (int j = 0; j < 4; ++j) kv[j] = to_f(Ks[(tx + 16 * j) * DP + d]);
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
            for (int j = 0; j < 4; ++j) s[i][j] = fmaf(qv[i], kv[j], s[i][j]);
    }
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j)
            s[i][j] = (k0 + tx + 16 * j < L) ? s[i][j] / sqrt_dh : -INFINITY;
}

// Two passes over the keys. Pass 1 keeps the running row max m and the
// rescaled row sum l of exp(s - m). Pass 2 recomputes the logits, forms the
// normalized weights exp(s - m) / l exactly as the plain softmax does,
// rounds them to the input type and accumulates P V in f32. Normalizing
// before rounding keeps the kernel within a few f32 ulps of the plain path
// before the output is rounded (a single-pass online softmax rounds
// unnormalized weights, and its bf16 outputs then differ by whole ulps).
template <typename T>
__global__ void __launch_bounds__(NT) mha_kernel(
    const T* __restrict__ qkv,  // (B, L, 3D)
    T* __restrict__ out,        // (B, L, D)
    int L, int D, int dh, float sqrt_dh) {
    constexpr int DP = DMAX + Pad<T>::v;
    extern __shared__ __align__(16) unsigned char smem[];
    T* Qs = reinterpret_cast<T*>(smem);
    T* Ks = Qs + BQ * DP;
    T* Vs = Ks + BK * DP;
    float* Ps = reinterpret_cast<float*>(Vs + BK * DP);  // (BQ, BK + 1)

    const int q0 = blockIdx.x * BQ;
    const int h = blockIdx.y;
    const int b = blockIdx.z;
    const int tid = threadIdx.x;
    const int tx = tid % 16;
    const int ty = tid / 16;
    const size_t row_stride = (size_t)3 * D;
    const T* base = qkv + (size_t)b * L * row_stride + (size_t)h * dh;

    for (int i = tid; i < BQ * dh; i += NT) {
        const int r = i / dh, d = i % dh;
        const int q = q0 + r;
        Qs[r * DP + d] = q < L ? base[(size_t)q * row_stride + d] : T(0.f);
    }

    float m_row[4], l_row[4], acc[4][8], s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
        m_row[i] = -INFINITY;
        l_row[i] = 0.f;
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;
    }

    // Pass 1: row max and sum. The 16 threads of a row sit in one half-warp.
    for (int k0 = 0; k0 < L; k0 += BK) {
        __syncthreads();  // Q is loaded / the previous tile's readers are done
        for (int i = tid; i < BK * dh; i += NT) {
            const int r = i / dh, d = i % dh;
            const int k = k0 + r;
            Ks[r * DP + d] = k < L ? base[(size_t)k * row_stride + D + d] : T(0.f);
        }
        __syncthreads();
        tile_logits<T, DP>(Qs, Ks, dh, ty, tx, k0, L, sqrt_dh, s);
#pragma unroll
        for (int i = 0; i < 4; ++i) {
            float mt = -INFINITY;
#pragma unroll
            for (int j = 0; j < 4; ++j) mt = fmaxf(mt, s[i][j]);
#pragma unroll
            for (int off = 8; off > 0; off >>= 1)
                mt = fmaxf(mt, __shfl_xor_sync(0xffffffffu, mt, off));
            const float m_new = fmaxf(m_row[i], mt);
            float rs = 0.f;
#pragma unroll
            for (int j = 0; j < 4; ++j) rs += expf(s[i][j] - m_new);
#pragma unroll
            for (int off = 8; off > 0; off >>= 1) rs += __shfl_xor_sync(0xffffffffu, rs, off);
            l_row[i] = l_row[i] * expf(m_row[i] - m_new) + rs;
            m_row[i] = m_new;
        }
    }

    // Pass 2: normalized weights, rounded, times V.
    for (int k0 = 0; k0 < L; k0 += BK) {
        __syncthreads();
        for (int i = tid; i < BK * dh; i += NT) {
            const int r = i / dh, d = i % dh;
            const int k = k0 + r;
            const T* src = base + (size_t)k * row_stride + d;
            Ks[r * DP + d] = k < L ? src[D] : T(0.f);
            Vs[r * DP + d] = k < L ? src[2 * D] : T(0.f);
        }
        __syncthreads();
        tile_logits<T, DP>(Qs, Ks, dh, ty, tx, k0, L, sqrt_dh, s);
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
            for (int j = 0; j < 4; ++j)
                Ps[(ty + 16 * i) * (BK + 1) + tx + 16 * j] =
                    round_p(expf(s[i][j] - m_row[i]) / l_row[i], T(0.f));
        __syncthreads();
        const int kmax = min(BK, L - k0);
        for (int c = 0; c < kmax; ++c) {
            float pv[4], vv[8];
#pragma unroll
            for (int i = 0; i < 4; ++i) pv[i] = Ps[(ty + 16 * i) * (BK + 1) + c];
#pragma unroll
            for (int j = 0; j < 8; ++j) {
                const int d = tx + 16 * j;
                vv[j] = d < dh ? to_f(Vs[c * DP + d]) : 0.f;
            }
#pragma unroll
            for (int i = 0; i < 4; ++i)
#pragma unroll
                for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(pv[i], vv[j], acc[i][j]);
        }
    }

#pragma unroll
    for (int i = 0; i < 4; ++i) {
        const int q = q0 + ty + 16 * i;
        if (q >= L) continue;
        T* dst = out + ((size_t)b * L + q) * D + (size_t)h * dh;
#pragma unroll
        for (int j = 0; j < 8; ++j) {
            const int d = tx + 16 * j;
            if (d < dh) from_f(dst + d, acc[i][j]);
        }
    }
}

template <typename T>
static int launch(const void* qkv, void* out, int B, int L, int D, int H, float sqrt_dh,
                  cudaStream_t stream) {
    const int dh = D / H;
    constexpr int DP = DMAX + Pad<T>::v;
    const size_t smem = (size_t)(BQ + 2 * BK) * DP * sizeof(T) + (size_t)BQ * (BK + 1) * sizeof(float);
    cudaError_t err = cudaFuncSetAttribute(
        mha_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
    dim3 grid((L + BQ - 1) / BQ, H, B);
    mha_kernel<T><<<grid, NT, smem, stream>>>(
        static_cast<const T*>(qkv), static_cast<T*>(out), L, D, dh, sqrt_dh);
    return (int)cudaGetLastError();
}

// dtype: 0 = float32, 1 = bfloat16; sqrt_dh = sqrt(D / H) rounded to float,
// as the plain path's divisor. Returns a cudaError_t (0 = success).
extern "C" int fp_attention_launch(const void* qkv, void* out, int B, int L, int D, int H,
                                   int dtype, float sqrt_dh, void* stream) {
    if (D % H != 0 || D / H > DMAX || D / H < 1) return (int)cudaErrorInvalidValue;
    cudaStream_t st = (cudaStream_t)stream;
    if (dtype == 0) return launch<float>(qkv, out, B, L, D, H, sqrt_dh, st);
    if (dtype == 1) return launch<__nv_bfloat16>(qkv, out, B, L, D, H, sqrt_dh, st);
    return (int)cudaErrorInvalidValue;
}
