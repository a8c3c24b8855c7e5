// Fused layer epilogue for Hopper (sm_90a): the bias add, inference batch
// norm, residual add and ReLU after a convolution's or linear layer's
// product, in one pass over its output.
//
// Replaces no TPU kernel: XLA fused these elementwise chains into the
// convolutions of the JAX package. PyTorch runs them as separate passes
// (up-cast, add, down-cast, subtract, two multiplies, add, casts, residual
// add, clamp), about ten trips through device memory per output element;
// this kernel reads the product (and the residual) once and writes the
// result once, in place over the product.
//
// Semantics, bit-equal to the chain of PyTorch ops in models/layers.py on
// the card: each step rounds where PyTorch rounds and contracts nothing
// (every add and multiply is an explicit __f*_rn, so nvcc forms no FMA):
//   t = round(f32(y) + bias)                        (bias, optional)
//   t = round(((f32(t) - mean) * inv) * w + b)      (BN, optional; inv is
//       the wrapper's torch.rsqrt(running_var + eps), not computed here)
//   t = round(f32(t) + f32(residual))               (optional)
//   t = isnan(t) ? t : max(t, 0)                    (ReLU, optional; NaN
//       kept bit for bit as clamp_min keeps it)
// where round is the f32 -> bf16 round to nearest even of __float2bfloat16
// (c10::BFloat16's conversion on the card), or nothing for f32 outputs.
//
// Layout: rows of C contiguous channels, the memory order of a
// channels-last conv output and of a linear output. A thread owns VEC
// consecutive channels (16 bytes: 8 bf16 or 4 f32), keeps their per-channel
// parameters in registers and strides over rows; a block's threads cover
// whole consecutive rows, so a warp's loads are contiguous. A C that is not
// a multiple of VEC, or a pointer not 16-byte aligned, runs the same code
// one element a thread (VEC = 1).
//
// Bound on the H100 (3.35 TB/s): bytes. At the register's largest shape,
// 504 x 80 x 80 x 64 bf16 with BN and ReLU, 206.4 M elements read and
// written once are 825.8 MB, 0.246 ms; the per-channel parameters stay in
// registers and L1.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#define THREADS 256

enum { HAS_BIAS = 1, HAS_BN = 2, HAS_RES = 4, HAS_RELU = 8 };

struct Args {
    void* y;               // (rows, C), read and overwritten
    const void* res;       // (rows, C) or null
    const float* bias;     // (C,) or null
    const float* mean;     // BN (C,) each, or all null
    const float* inv;
    const float* weight;
    const float* shift;
    long long rows;
    int C;
};

// bf16 is carried as its bits (uint16_t), f32 as itself.
__device__ __forceinline__ float to_f(uint16_t h) { return __uint_as_float((uint32_t)h << 16); }
__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ void from_f(float x, uint16_t& h) { h = __bfloat16_as_ushort(__float2bfloat16_rn(x)); }
__device__ __forceinline__ void from_f(float x, float& o) { o = x; }

template <typename T, int FLAGS>
__device__ __forceinline__ T apply(T t, T r, float bias, float mean, float inv, float w, float b) {
    if (FLAGS & HAS_BIAS) from_f(__fadd_rn(to_f(t), bias), t);
    if (FLAGS & HAS_BN) from_f(__fadd_rn(__fmul_rn(__fmul_rn(__fsub_rn(to_f(t), mean), inv), w), b), t);
    if (FLAGS & HAS_RES) from_f(__fadd_rn(to_f(t), to_f(r)), t);
    if (FLAGS & HAS_RELU) {
        const float v = to_f(t);
        if (!isnan(v)) from_f(fmaxf(v, 0.0f), t);
    }
    return t;
}

template <typename T, int VEC>
struct alignas(sizeof(T) * VEC) Pack {
    T v[VEC];
};

template <typename T, int VEC, int FLAGS>
__global__ void __launch_bounds__(THREADS) fp_epilogue(Args a) {
    const int cols = a.C / VEC;
    const int col = blockIdx.y * blockDim.x + threadIdx.x;
    if (col >= cols) return;
    const int c0 = col * VEC;
    float bias[VEC], mean[VEC], inv[VEC], w[VEC], b[VEC];
#pragma unroll
    for (int i = 0; i < VEC; ++i) {
        bias[i] = (FLAGS & HAS_BIAS) ? a.bias[c0 + i] : 0.0f;
        mean[i] = (FLAGS & HAS_BN) ? a.mean[c0 + i] : 0.0f;
        inv[i] = (FLAGS & HAS_BN) ? a.inv[c0 + i] : 0.0f;
        w[i] = (FLAGS & HAS_BN) ? a.weight[c0 + i] : 0.0f;
        b[i] = (FLAGS & HAS_BN) ? a.shift[c0 + i] : 0.0f;
    }
    Pack<T, VEC>* y = reinterpret_cast<Pack<T, VEC>*>(a.y);
    const Pack<T, VEC>* res = reinterpret_cast<const Pack<T, VEC>*>(a.res);
    const long long step = (long long)gridDim.x * blockDim.y;
    for (long long r = (long long)blockIdx.x * blockDim.y + threadIdx.y; r < a.rows; r += step) {
        const long long at = r * cols + col;
        Pack<T, VEC> v = y[at];
        Pack<T, VEC> x;
        if (FLAGS & HAS_RES) x = res[at];
#pragma unroll
        for (int i = 0; i < VEC; ++i)
            v.v[i] = apply<T, FLAGS>(v.v[i], (FLAGS & HAS_RES) ? x.v[i] : T(0), bias[i], mean[i], inv[i],
                                     w[i], b[i]);
        y[at] = v;
    }
}

static int sm_count() {
    int dev = 0, n = 0;
    if (cudaGetDevice(&dev) != cudaSuccess || cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev)
        != cudaSuccess) return 132;
    return n;
}

template <typename T, int VEC, int FLAGS>
static int launch(const Args& a, cudaStream_t st) {
    const int cols = a.C / VEC;
    const int bx = cols < THREADS ? cols : THREADS;
    const int by = THREADS / bx;
    const int gy = (cols + bx - 1) / bx;
    // enough blocks to fill every SM (2048 threads each), each thread then strides over rows
    long long gx = (a.rows + by - 1) / by;
    const long long fill = (long long)sm_count() * (2048 / (bx * by)) / gy;
    if (gx > fill) gx = fill > 0 ? fill : 1;
    fp_epilogue<T, VEC, FLAGS><<<dim3((unsigned)gx, gy), dim3(bx, by), 0, st>>>(a);
    return (int)cudaGetLastError();
}

template <typename T, int VEC, int FLAGS = 0, int BIT = 1>
static int dispatch(const Args& a, int flags, cudaStream_t st) {
    if constexpr (BIT > HAS_RELU) {
        return launch<T, VEC, FLAGS>(a, st);
    } else {
        return (flags & BIT) ? dispatch<T, VEC, FLAGS | BIT, BIT * 2>(a, flags, st)
                             : dispatch<T, VEC, FLAGS, BIT * 2>(a, flags, st);
    }
}

// dtype 0: f32, 1: bf16. vec: 1, or 16 bytes a thread (C a multiple of 8 for
// bf16, 4 for f32, and y and res 16-byte aligned).
extern "C" int fp_epilogue_launch(void* y, const void* res, const void* bias, const void* mean,
                                  const void* inv, const void* weight, const void* shift, long long rows,
                                  int C, int flags, int dtype, int vec, void* stream) {
    Args a{y, res, (const float*)bias, (const float*)mean, (const float*)inv, (const float*)weight,
           (const float*)shift, rows, C};
    if (rows <= 0 || C <= 0) return 0;
    cudaStream_t st = (cudaStream_t)stream;
    if (dtype == 1 && vec == 8 && C % 8 == 0) return dispatch<uint16_t, 8>(a, flags, st);
    if (dtype == 1 && vec == 1) return dispatch<uint16_t, 1>(a, flags, st);
    if (dtype == 0 && vec == 4 && C % 4 == 0) return dispatch<float, 4>(a, flags, st);
    if (dtype == 0 && vec == 1) return dispatch<float, 1>(a, flags, st);
    return (int)cudaErrorInvalidValue;
}
