// Fused multi-head self-attention core for Hopper (sm_90a), forward only.
//
// Replaces the Pallas TPU kernel foundationpose_tpu/ops/attention.py
// (_mha_kernel, launched by _attention_core_pallas). q/k/v are read
// straight from the packed (B, L, 3D) input at the head's column offset and
// the head's lanes of the (B, L, D) output are written once; the (B, H, L, L)
// logits never reach device memory. Keys at or past L are masked.
//
// Bound on the H100 (3.35 TB/s, 989 TFLOP/s bf16) at the RefineNet /
// ScoreNet head shape (B=252, L=400, D=512, 4 heads of 128), bf16: 309.7 MB
// read + 103.2 MB written = 0.123 ms of bytes; QK^T and PV are 82.6 GFLOP =
// 0.084 ms on the tensor cores. The function is bound by its bytes.
//
// bf16 input (the network's compute type), on the tensor cores:
// - one block per (64-query tile, head, batch), four warps, each owning 16
//   query rows; QK^T and PV are warp-level mma.sync m16n8k16 (bf16 in, f32
//   sums), operands loaded with ldmatrix from shared memory whose rows are
//   padded by 16 bytes (no bank conflicts); a head narrower than 128 is
//   zero-padded to 128 columns in shared memory, and the zeros add nothing;
// - Q is loaded once (through V's second stage) and kept in registers as A
//   fragments; K and V come in 64-key tiles through a two-stage cp.async
//   ring (16 bytes a thread), so the copy of the next tile overlaps the
//   products on the current one. 70 KB of shared memory and 168 registers
//   a thread let three blocks share an SM;
// - two passes over the keys, as the plain softmax rounds: pass 1 keeps the
//   row max m and the rescaled row sum l (quad shuffles); pass 2 recomputes
//   the logits, forms the normalized weights expf(s - m) / l, rounds them to
//   bf16 in registers (the S accumulator layout is the A layout of the PV
//   product, so P never goes through shared memory) and sums P V in f32.
//   Normalizing before rounding keeps each output within a few f32 ulps of
//   the plain path before the output is rounded; a one-pass online softmax
//   rounds unnormalized weights and moves half the bf16 outputs by an ulp.
//   The second QK^T costs FLOPs and L2 reads, not device-memory bytes.
// Logits are divided by sqrt(dh) and weights by l as IEEE divisions round
// them, each from one reciprocal and an FMA correction (div_rn).
// What keeps it above its bound: each of a head's query tiles reads the
// head's K twice and V once from L2, and the softmax's expf and divisions
// compete with the products for instruction slots at 12 warps an SM.
//
// f32 input: everything in f32 on the CUDA cores (FMA, register-blocked 4x4
// logits and 4x8 outputs per thread, same two passes), so an f32 pipeline on
// the card never meets a hidden downcast or TF32. Head width 1..128.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#define BQ 64
#define BK 64
#define DMAX 128

typedef __nv_bfloat16 bf16;

// ------------------------------------------------------ bf16, tensor cores

#define TC_THREADS 128  // four warps, 16 query rows each: a block owns BQ queries
// A shared tile row holds a 128-column head (narrower heads are zero-padded)
// and 16 bytes of padding, so the 8 rows an ldmatrix reads sit in distinct banks.
static constexpr int LD = DMAX + 8;
static constexpr int TILE = BK * LD;   // bf16 elements of a 64-row tile
static constexpr int KC = DMAX / 16;   // k-steps of QK^T; pairs of 8-column tiles of PV

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
    return (uint32_t)__cvta_generic_to_shared(p);
}

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const bf16* p) {
    asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
                 : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
                 : "r"(smem_addr(p)));
}

__device__ __forceinline__ void ldsm_x4_trans(uint32_t (&r)[4], const bf16* p) {
    asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
                 : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
                 : "r"(smem_addr(p)));
}

// c += a (16x16, row) * b (16x8, col); bf16 operands, f32 accumulators. A
// function of its registers only, so the compiler may schedule it freely.
__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
    asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
        "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
        : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// 16 bytes global -> shared; src_bytes = 0 fills the 16 bytes with zeros.
__device__ __forceinline__ void cp_async16(bf16* dst, const bf16* src, int src_bytes) {
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
                 :: "r"(smem_addr(dst)), "l"(src), "r"(src_bytes));
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n"); }

template <int N>
__device__ __forceinline__ void cp_async_wait() {
    asm volatile("cp.async.wait_group %0;\n" :: "n"(N) : "memory");
}

// (lo, hi) -> one register of two bf16, lo in the low half (round to nearest even).
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
    __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
    return *reinterpret_cast<uint32_t*>(&v);
}

// a / b rounded to nearest, given rb = 1 / b rounded to nearest: one FMA
// correction of a * rb (Markstein's theorem), the IEEE quotient that `a / b`
// gives, in three instructions instead of a division's sequence. Exact for
// finite quotients above the subnormal range; the weights it rounds there
// (< 1.2e-38) add nothing visible to an f32 sum.
__device__ __forceinline__ float div_rn(float a, float b, float rb) {
    const float q = __fmul_rn(a, rb);
    return __fmaf_rn(__fmaf_rn(-q, b, a), rb, q);
}

// Rows r0 .. r0+63 of one head's q, k or v into a (64, LD) shared tile,
// columns 0..dh-1; rows at or past L become zeros. vec: 16-byte cp.async
// (dh and D multiples of 8, 16-byte aligned base), else element loads.
__device__ __forceinline__ void load_tile(bf16* dst, const bf16* src, int r0, int L,
                                          size_t row_stride, int dh, bool vec, int tid) {
    if (vec) {
        // Chunk i = tid + 128 k is (row i / cpr, chunk i % cpr); step both
        // without a division per chunk.
        const int cpr = dh >> 3;  // 16-byte chunks per row
        const int dr = TC_THREADS / cpr, dc = TC_THREADS - dr * cpr;
        int r = tid / cpr, c = tid - r * cpr;
        while (r < BK) {
            const bool ok = r0 + r < L;
            cp_async16(dst + r * LD + c * 8,
                       ok ? src + (size_t)(r0 + r) * row_stride + c * 8 : src, ok ? 16 : 0);
            r += dr;
            c += dc;
            if (c >= cpr) {
                c -= cpr;
                ++r;
            }
        }
    } else {
        for (int i = tid; i < BK * dh; i += TC_THREADS) {
            const int r = i / dh, c = i - r * dh;
            dst[r * LD + c] =
                r0 + r < L ? src[(size_t)(r0 + r) * row_stride + c] : __float2bfloat16(0.f);
        }
    }
}

// The warp's 16 x 64 logits of the key tile at k0, divided by sqrt(dh);
// keys at or past L -> -inf. Accumulator layout of m16n8: s[j] holds keys
// k0 + 8j + 2(lane%4) + {0, 1} of rows lane/4 (s[j][0..1]) and lane/4 + 8
// (s[j][2..3]). Key blocks of 16 wholly past L skip their products.
__device__ __forceinline__ void tile_scores(float (&s)[8][4], const uint32_t (&qf)[KC][4],
                                            const bf16* Kt, int lane, int k0, int L,
                                            float sqrt_dh, float rsqrt_dh) {
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[j][e] = 0.f;
    const bf16* kp = Kt + ((lane & 7) + ((lane >> 4) << 3)) * LD + ((lane >> 3) & 1) * 8;
#pragma unroll
    for (int jp = 0; jp < 4; ++jp) {
        if (k0 + jp * 16 >= L) continue;
#pragma unroll
        for (int kc = 0; kc < KC; ++kc) {
            uint32_t b[4];
            ldsm_x4(b, kp + jp * 16 * LD + kc * 16);
            mma_bf16(s[2 * jp], qf[kc], b[0], b[1]);
            mma_bf16(s[2 * jp + 1], qf[kc], b[2], b[3]);
        }
    }
    const int kv = L - k0 - 2 * (lane & 3);  // this lane's key j, e is valid if 8j + (e & 1) < kv
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e)
            s[j][e] = 8 * j + (e & 1) < kv ? div_rn(s[j][e], sqrt_dh, rsqrt_dh) : -INFINITY;
}

__global__ void __launch_bounds__(TC_THREADS) mha_bf16_tc_kernel(
    const bf16* __restrict__ qkv,  // (B, L, 3D)
    bf16* __restrict__ out,        // (B, L, D)
    int L, int D, int dh, float sqrt_dh, int vec_flag) {
    extern __shared__ __align__(128) unsigned char smem_raw[];
    bf16* Ks = reinterpret_cast<bf16*>(smem_raw);  // two stages
    bf16* Vs = Ks + 2 * TILE;                       // two stages
    bf16* Qs = Vs + TILE;                           // Q passes through V's stage 1

    const int q0 = blockIdx.x * BQ;
    const int h = blockIdx.y;
    const int b = blockIdx.z;
    const int tid = threadIdx.x;
    const int warp = tid >> 5, lane = tid & 31;
    const bool vec = vec_flag != 0;
    const size_t row_stride = (size_t)3 * D;
    const bf16* base = qkv + (size_t)b * L * row_stride + (size_t)h * dh;
    const int nt = (L + BK - 1) / BK;
    const float rsqrt_dh = 1.f / sqrt_dh;

    if (dh < DMAX) {  // zero the padded columns of the four tiles once; loads never write them
        const int pad = DMAX - dh;
        for (int i = tid; i < 4 * BK * pad; i += TC_THREADS)
            Ks[(i / pad) * LD + dh + i % pad] = __float2bfloat16(0.f);
    }
    // Q and the first K tile; Q then stays in registers as the A fragments
    // of QK^T.
    load_tile(Qs, base, q0, L, row_stride, dh, vec, tid);
    load_tile(Ks, base + D, 0, L, row_stride, dh, vec, tid);
    cp_async_commit();
    cp_async_wait<0>();
    __syncthreads();
    uint32_t qf[KC][4];
#pragma unroll
    for (int kc = 0; kc < KC; ++kc)
        ldsm_x4(qf[kc], Qs + (warp * 16 + (lane & 15)) * LD + kc * 16 + (lane >> 4) * 8);
    __syncthreads();  // every warp holds its Q before V's stage 1 is refilled

    float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f}, rl[2];
    float o[2 * KC][4];
#pragma unroll
    for (int j = 0; j < 2 * KC; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) o[j][e] = 0.f;

    // Steps 0 .. nt-1: pass 1 over the K tiles; steps nt .. 2nt-1: pass 2
    // over the (K, V) tiles. Step s+1's tiles load while step s computes.
    for (int s = 0; s < 2 * nt; ++s) {
        if (s + 1 < 2 * nt) {
            const int n = s + 1, t = n < nt ? n : n - nt;
            load_tile(Ks + (n & 1) * TILE, base + D, t * BK, L, row_stride, dh, vec, tid);
            if (n >= nt)
                load_tile(Vs + (n & 1) * TILE, base + 2 * D, t * BK, L, row_stride, dh, vec, tid);
        }
        cp_async_commit();   // possibly empty: keeps one group per step
        cp_async_wait<1>();  // step s's tiles have landed
        __syncthreads();
        const int k0 = (s < nt ? s : s - nt) * BK;
        float sc[8][4];
        tile_scores(sc, qf, Ks + (s & 1) * TILE, lane, k0, L, sqrt_dh, rsqrt_dh);
        if (s < nt) {
            // Pass 1: rows lane/4 (r = 0) and lane/4 + 8 (r = 1); the 64 keys
            // of a row sit in the four lanes of a quad.
#pragma unroll
            for (int r = 0; r < 2; ++r) {
                float mt = -INFINITY;
#pragma unroll
                for (int j = 0; j < 8; ++j) mt = fmaxf(mt, fmaxf(sc[j][2 * r], sc[j][2 * r + 1]));
                mt = fmaxf(mt, __shfl_xor_sync(0xffffffffu, mt, 1));
                mt = fmaxf(mt, __shfl_xor_sync(0xffffffffu, mt, 2));
                const float m_new = fmaxf(m[r], mt);
                float rs = 0.f;
#pragma unroll
                for (int j = 0; j < 8; ++j)
                    rs += expf(sc[j][2 * r] - m_new) + expf(sc[j][2 * r + 1] - m_new);
                rs += __shfl_xor_sync(0xffffffffu, rs, 1);
                rs += __shfl_xor_sync(0xffffffffu, rs, 2);
                l[r] = l[r] * expf(m[r] - m_new) + rs;
                m[r] = m_new;
            }
            if (s == nt - 1) {
                rl[0] = 1.f / l[0];
                rl[1] = 1.f / l[1];
            }
        } else {
            // Pass 2: P = bf16(expf(s - m) / l) as A fragments, P V in f32.
            const bf16* vp = Vs + (s & 1) * TILE + (lane & 15) * LD + (lane >> 4) * 8;
#pragma unroll
            for (int kk = 0; kk < 4; ++kk) {
                if (k0 + kk * 16 >= L) continue;
                uint32_t pa[4];
#pragma unroll
                for (int hf = 0; hf < 2; ++hf) {
                    const int j = 2 * kk + hf;
                    pa[2 * hf] = pack_bf16(div_rn(expf(sc[j][0] - m[0]), l[0], rl[0]),
                                           div_rn(expf(sc[j][1] - m[0]), l[0], rl[0]));
                    pa[2 * hf + 1] = pack_bf16(div_rn(expf(sc[j][2] - m[1]), l[1], rl[1]),
                                               div_rn(expf(sc[j][3] - m[1]), l[1], rl[1]));
                }
#pragma unroll
                for (int dp = 0; dp < KC; ++dp) {
                    uint32_t bv[4];
                    ldsm_x4_trans(bv, vp + kk * 16 * LD + dp * 16);
                    mma_bf16(o[2 * dp], pa, bv[0], bv[1]);
                    mma_bf16(o[2 * dp + 1], pa, bv[2], bv[3]);
                }
            }
        }
        __syncthreads();  // every warp is done with stage s & 1 before it is refilled
    }

    // The warp's 16 output rows, rounded to bf16, through its rows of K's
    // stage 0, then to the head's lanes.
    bf16* Os = Ks + warp * 16 * LD;
    const int g = lane >> 2, c2 = 2 * (lane & 3);
#pragma unroll
    for (int j = 0; j < 2 * KC; ++j) {
        *reinterpret_cast<__nv_bfloat162*>(Os + g * LD + 8 * j + c2) =
            __floats2bfloat162_rn(o[j][0], o[j][1]);
        *reinterpret_cast<__nv_bfloat162*>(Os + (g + 8) * LD + 8 * j + c2) =
            __floats2bfloat162_rn(o[j][2], o[j][3]);
    }
    __syncwarp();
    const int qw = q0 + warp * 16;
    bf16* dst = out + ((size_t)b * L + qw) * D + (size_t)h * dh;
    if (vec) {
        const int cpr = dh >> 3;
        for (int i = lane; i < 16 * cpr; i += 32) {
            const int r = i / cpr, c = (i - r * cpr) * 8;
            if (qw + r < L)
                *reinterpret_cast<uint4*>(dst + (size_t)r * D + c) =
                    *reinterpret_cast<const uint4*>(Os + r * LD + c);
        }
    } else {
        for (int i = lane; i < 16 * dh; i += 32) {
            const int r = i / dh, c = i - r * dh;
            if (qw + r < L) dst[(size_t)r * D + c] = Os[r * LD + c];
        }
    }
}

static int launch_bf16(const void* qkv, void* out, int B, int L, int D, int H, float sqrt_dh,
                       cudaStream_t stream) {
    const int dh = D / H;
    const size_t smem = (size_t)4 * TILE * sizeof(bf16);
    cudaError_t err = cudaFuncSetAttribute(
        mha_bf16_tc_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
    const int vec = dh % 8 == 0 && D % 8 == 0 && (uintptr_t)qkv % 16 == 0 &&
                    (uintptr_t)out % 16 == 0;
    dim3 grid((L + BQ - 1) / BQ, H, B);
    mha_bf16_tc_kernel<<<grid, TC_THREADS, smem, stream>>>(
        static_cast<const bf16*>(qkv), static_cast<bf16*>(out), L, D, dh, sqrt_dh, vec);
    return (int)cudaGetLastError();
}

// ------------------------------------------------------ f32, CUDA cores

#define F32_THREADS 256  // 16 x 16 threads
#define F32_DP (DMAX + 1)  // 129 words a row

// Logits of the staged key tile for rows ty + 16i, keys tx + 16j, divided
// by sqrt(dh) as the plain path divides them; keys at or past L -> -inf.
__device__ __forceinline__ void tile_logits_f32(const float* Qs, const float* Ks, int dh, int ty,
                                                int tx, int k0, int L, float sqrt_dh,
                                                float (&s)[4][4]) {
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
    for (int d = 0; d < dh; ++d) {
        float qv[4], kv[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) qv[i] = Qs[(ty + 16 * i) * F32_DP + d];
#pragma unroll
        for (int j = 0; j < 4; ++j) kv[j] = Ks[(tx + 16 * j) * F32_DP + d];
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

// Two passes over the keys: pass 1 keeps the running row max m and the
// rescaled row sum l of exp(s - m); pass 2 recomputes the logits, forms
// exp(s - m) / l and accumulates P V.
__global__ void __launch_bounds__(F32_THREADS) mha_f32_kernel(
    const float* __restrict__ qkv,  // (B, L, 3D)
    float* __restrict__ out,        // (B, L, D)
    int L, int D, int dh, float sqrt_dh) {
    extern __shared__ __align__(16) unsigned char smem[];
    float* Qs = reinterpret_cast<float*>(smem);
    float* Ks = Qs + BQ * F32_DP;
    float* Vs = Ks + BK * F32_DP;
    float* Ps = Vs + BK * F32_DP;  // (BQ, BK + 1)

    const int q0 = blockIdx.x * BQ;
    const int h = blockIdx.y;
    const int b = blockIdx.z;
    const int tid = threadIdx.x;
    const int tx = tid % 16;
    const int ty = tid / 16;
    const size_t row_stride = (size_t)3 * D;
    const float* base = qkv + (size_t)b * L * row_stride + (size_t)h * dh;

    for (int i = tid; i < BQ * dh; i += F32_THREADS) {
        const int r = i / dh, d = i % dh;
        const int q = q0 + r;
        Qs[r * F32_DP + d] = q < L ? base[(size_t)q * row_stride + d] : 0.f;
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
        for (int i = tid; i < BK * dh; i += F32_THREADS) {
            const int r = i / dh, d = i % dh;
            const int k = k0 + r;
            Ks[r * F32_DP + d] = k < L ? base[(size_t)k * row_stride + D + d] : 0.f;
        }
        __syncthreads();
        tile_logits_f32(Qs, Ks, dh, ty, tx, k0, L, sqrt_dh, s);
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

    // Pass 2: normalized weights times V.
    for (int k0 = 0; k0 < L; k0 += BK) {
        __syncthreads();
        for (int i = tid; i < BK * dh; i += F32_THREADS) {
            const int r = i / dh, d = i % dh;
            const int k = k0 + r;
            const float* src = base + (size_t)k * row_stride + d;
            Ks[r * F32_DP + d] = k < L ? src[D] : 0.f;
            Vs[r * F32_DP + d] = k < L ? src[2 * D] : 0.f;
        }
        __syncthreads();
        tile_logits_f32(Qs, Ks, dh, ty, tx, k0, L, sqrt_dh, s);
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
            for (int j = 0; j < 4; ++j)
                Ps[(ty + 16 * i) * (BK + 1) + tx + 16 * j] = expf(s[i][j] - m_row[i]) / l_row[i];
        __syncthreads();
        const int kmax = min(BK, L - k0);
        for (int c = 0; c < kmax; ++c) {
            float pv[4], vv[8];
#pragma unroll
            for (int i = 0; i < 4; ++i) pv[i] = Ps[(ty + 16 * i) * (BK + 1) + c];
#pragma unroll
            for (int j = 0; j < 8; ++j) {
                const int d = tx + 16 * j;
                vv[j] = d < dh ? Vs[c * F32_DP + d] : 0.f;
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
        float* dst = out + ((size_t)b * L + q) * D + (size_t)h * dh;
#pragma unroll
        for (int j = 0; j < 8; ++j) {
            const int d = tx + 16 * j;
            if (d < dh) dst[d] = acc[i][j];
        }
    }
}

static int launch_f32(const void* qkv, void* out, int B, int L, int D, int H, float sqrt_dh,
                      cudaStream_t stream) {
    const size_t smem = (size_t)(BQ + 2 * BK) * F32_DP * sizeof(float) +
                        (size_t)BQ * (BK + 1) * sizeof(float);
    cudaError_t err = cudaFuncSetAttribute(
        mha_f32_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
    dim3 grid((L + BQ - 1) / BQ, H, B);
    mha_f32_kernel<<<grid, F32_THREADS, smem, stream>>>(
        static_cast<const float*>(qkv), static_cast<float*>(out), L, D, D / H, sqrt_dh);
    return (int)cudaGetLastError();
}

// dtype: 0 = float32, 1 = bfloat16; sqrt_dh = sqrt(D / H) rounded to float,
// as the plain path's divisor. Returns a cudaError_t (0 = success).
extern "C" int fp_attention_launch(const void* qkv, void* out, int B, int L, int D, int H,
                                   int dtype, float sqrt_dh, void* stream) {
    if (D % H != 0 || D / H > DMAX || D / H < 1) return (int)cudaErrorInvalidValue;
    cudaStream_t st = (cudaStream_t)stream;
    if (dtype == 0) return launch_f32(qkv, out, B, L, D, H, sqrt_dh, st);
    if (dtype == 1) return launch_bf16(qkv, out, B, L, D, H, sqrt_dh, st);
    return (int)cudaErrorInvalidValue;
}
