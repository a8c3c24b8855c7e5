// Tile rasterizer for Hopper (sm_90a): nearest-face raster, perspective-
// correct interpolation and shading of N pose hypotheses in one launch.
//
// Replaces the Pallas TPU kernel foundationpose_tpu/ops/pallas_raster2.py
// (_raster_kernel, launched by raster_pose_pallas). The TPU kernel bins
// faces into per-tile slots with rank matmuls, a 3-limb bf16 one-hot
// routing and capacity rounds, because the TPU has no per-lane gather.
// Here a block compacts its tile's faces with ballots and prefix sums.
//
// What bounds it on the card: the per-pixel edge tests (three f32 edge
// functions per face and pixel, without contraction). A pixel must test
// every face that can cover it and should test no other, so faces are
// binned twice by their padded screen boxes:
//   * face_box_kernel writes each face's box (its bbox moved out by a
//     proven bound on the pixels its rounded edge test can accept, or the
//     whole plane where no finite bound exists: ops/raster_cuda.py gives
//     the argument and the plain version) and each 128-face chunk's box;
//   * raster_kernel runs one block per (pose, 16x16 tile). Phase A: the
//     block skips chunks whose box misses the tile, tests each face of
//     the others against the tile (one thread per face) and compacts the
//     hits, in ascending face order, into a shared-memory list with their
//     records. Phase B: each warp owns an 8x4 pixel patch, tests 32 list
//     entries' boxes at a time against it (one lane each, __ballot_sync)
//     and walks the set bits from the lowest: all 32 lanes edge-test that
//     face, its record read from shared memory as a broadcast. A tile
//     with more faces than the list holds runs phases A and B in rounds,
//     carrying each pixel's nearest face, so nothing is dropped.
//     Phase C: interpolation, shading and the writes.
//     A 16x16 tile keeps blocks small (256 threads, 48 registers, 18 KB of
//     shared memory), so several share an SM and one block's barriers and
//     dependent loads overlap another's work; 32x32 blocks (one an SM) were
//     slower in a comparison on the card.
// Exactness: faces are scanned in ascending index and a face replaces the
// winner only when strictly nearer, which is the brute path's tie rule
// (the lowest index wins); the edge tests and the interpolation repeat
// the plain torch path's operations in the same order, and the file is
// built with --fmad=false so no multiply-add is contracted: masks and
// attributes come out bit-equal to it. The edge functions are evaluated
// as px*a + py*b + c at every pixel, never stepped incrementally (w += a
// rounds otherwise).
// Inputs come from ops/rasterizer.py::_prepare: per-face edge
// coefficients (N, F, 10), inverse depths (N, F, 3), faces (F, 3) int64
// and the packed per-vertex attributes (N, V, D).

#include <cuda_runtime.h>
#include <stdint.h>

#define TILE 16
#define PW 8  // a warp's patch: PW x PH pixels
#define PH 4
#define NTHREADS (TILE * TILE)
#define NWARPS (NTHREADS / 32)
#define CHUNK 128
#define CAP 256  // tile-list entries held at once
#define BIG 1e30f
#define FULL 0xffffffffu
static_assert(NTHREADS % CHUNK == 0, "a step of phase A covers whole chunks");
static_assert(CAP >= NTHREADS, "one step's faces fit an empty list");
static_assert(TILE % PW == 0 && TILE % PH == 0, "warp patches tile the tile");

// Constants of ops/raster_cuda.py::face_boxes (same doubles).
#define G3 ((3.0 * 0x1p-24) / (1.0 - 3.0 * 0x1p-24))
#define EDGE_EPS 1.00001e-5
#define TINY 1e-40
#define REL 0x1p-40

// ------------------------------------------------------------ face boxes

// The bound of one side (ops/raster_cuda.py::face_boxes.need), operation
// for operation.
__device__ __forceinline__ double need_side(const double* a, const double* b, const double* c,
                                            const double* dl, const double* co, double ref,
                                            bool is_x, double X, double Y) {
    double d[3], ad[3], bd[3], cd[3];
    for (int k = 0; k < 3; ++k) {
        d[k] = co[k] - ref;
        ad[k] = a[k] * d[k];
        bd[k] = b[k] * d[k];
        cd[k] = c[k] * d[k];
    }
    const double spread = (dl[0] * fabs(d[0]) + dl[1] * fabs(d[1])) + dl[2] * fabs(d[2]);
    double qa = (ad[0] + ad[1]) + ad[2];
    double qb = (bd[0] + bd[1]) + bd[2];
    const double qc = ((cd[0] + cd[1]) + cd[2]) + ref;
    if (is_x) qa = qa - 1.0;
    else qb = qb - 1.0;
    const double ta = qa * X, tb = qb * Y;
    const double q_hi = (qc + (ta > 0.0 ? ta : 0.0)) + (tb > 0.0 ? tb : 0.0);
    const double q_lo = (qc + (ta < 0.0 ? ta : 0.0)) + (tb < 0.0 ? tb : 0.0);
    const double mag = (((((fabs(ad[0]) + fabs(ad[1])) + fabs(ad[2])) * X +
                          ((fabs(bd[0]) + fabs(bd[1])) + fabs(bd[2])) * Y) +
                         ((fabs(cd[0]) + fabs(cd[1])) + fabs(cd[2]))) +
                        fabs(ref) + X) + Y;
    return (spread + fmax(fabs(q_hi), fabs(q_lo))) * (1.0 + REL) + mag * REL;
}

__global__ void __launch_bounds__(CHUNK) face_box_kernel(
    const float* __restrict__ coeffs,    // (N, F, 10)
    const long long* __restrict__ faces, // (F, 3)
    const float* __restrict__ vdata,     // (N, V, D), screen u, v in columns 0, 1
    float4* __restrict__ fbox,           // (N, C * CHUNK) [x0, x1, y0, y1]
    float4* __restrict__ cbox,           // (N, C)
    int F, int V, int D, int H, int W, int C) {
    __shared__ float4 s_part[CHUNK / 32];
    const int n = blockIdx.y;
    const int f = blockIdx.x * CHUNK + threadIdx.x;
    float4 box = make_float4(BIG, -BIG, BIG, -BIG);  // empty: never overlaps
    if (f < F) {
        const float* cf = coeffs + ((size_t)n * F + f) * 10;
        if (cf[9] > 0.f) {
            const double X = (double)max(W - 1, 0), Y = (double)max(H - 1, 0);
            double a[3], b[3], c[3], dl[3], xs[3], ys[3];
            for (int k = 0; k < 3; ++k) {
                a[k] = cf[3 * k];
                b[k] = cf[3 * k + 1];
                c[k] = cf[3 * k + 2];
                dl[k] = (EDGE_EPS + G3 * ((fabs(a[k]) * X + fabs(b[k]) * Y) + fabs(c[k]))) + TINY;
                const float* v = vdata + ((size_t)n * V + faces[(size_t)f * 3 + k]) * D;
                xs[k] = v[0];
                ys[k] = v[1];
            }
            const double lx = fmin(fmin(xs[0], xs[1]), xs[2]), hx = fmax(fmax(xs[0], xs[1]), xs[2]);
            const double ly = fmin(fmin(ys[0], ys[1]), ys[2]), hy = fmax(fmax(ys[0], ys[1]), ys[2]);
            const double n0 = need_side(a, b, c, dl, xs, lx, true, X, Y);
            const double n1 = need_side(a, b, c, dl, xs, hx, true, X, Y);
            const double n2 = need_side(a, b, c, dl, ys, ly, false, X, Y);
            const double n3 = need_side(a, b, c, dl, ys, hy, false, X, Y);
            if (isfinite(n0) && isfinite(n1) && isfinite(n2) && isfinite(n3)) {
                box = make_float4(__double2float_rd(lx - n0), __double2float_ru(hx + n1),
                                  __double2float_rd(ly - n2), __double2float_ru(hy + n3));
            } else {
                box = make_float4(-BIG, BIG, -BIG, BIG);  // unbounded: every pixel
            }
        }
    }
    fbox[(size_t)n * C * CHUNK + f] = box;

    // The chunk's box: the union of its faces' boxes.
    for (int o = 16; o > 0; o >>= 1) {
        box.x = fminf(box.x, __shfl_xor_sync(FULL, box.x, o));
        box.y = fmaxf(box.y, __shfl_xor_sync(FULL, box.y, o));
        box.z = fminf(box.z, __shfl_xor_sync(FULL, box.z, o));
        box.w = fmaxf(box.w, __shfl_xor_sync(FULL, box.w, o));
    }
    if ((threadIdx.x & 31) == 0) s_part[threadIdx.x >> 5] = box;
    __syncthreads();
    if (threadIdx.x == 0) {
        float4 u = s_part[0];
        for (int w = 1; w < CHUNK / 32; ++w) {
            u.x = fminf(u.x, s_part[w].x);
            u.y = fmaxf(u.y, s_part[w].y);
            u.z = fminf(u.z, s_part[w].z);
            u.w = fmaxf(u.w, s_part[w].w);
        }
        cbox[(size_t)n * C + blockIdx.x] = u;
    }
}

// ------------------------------------------------------------ raster

__device__ __forceinline__ bool overlaps(float4 b, float x0, float x1, float y0, float y1) {
    return !(b.x > x1 || b.y < x0 || b.z > y1 || b.w < y0);
}

// Ordered block-wide compaction: this thread's rank among the threads
// that pass, and their count in *total. The caller separates two calls
// with a __syncthreads (s_wsum is reused).
__device__ __forceinline__ int block_rank(bool pass, int* s_wsum, int* total) {
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    const unsigned m = __ballot_sync(FULL, pass);
    if (lane == 0) s_wsum[warp] = __popc(m);
    __syncthreads();
    int v = lane < NWARPS ? s_wsum[lane] : 0;
    for (int o = 1; o < 32; o <<= 1) {
        const int t = __shfl_up_sync(FULL, v, o);
        if (lane >= o) v += t;
    }
    *total = __shfl_sync(FULL, v, 31);
    const int before = __shfl_sync(FULL, v, warp) - __popc(m);
    return before + __popc(m & ((1u << lane) - 1u));
}

// Phase B: the warp's patch against list entries [0, count), in order.
__device__ __forceinline__ void scan_patch(const float4* s_box, const float4* s_rec, const int* s_face,
                                           int count, float bx0, float bx1, float by0, float by1,
                                           float px, float py, float& best_z, int& best_f,
                                           unsigned long long& tests) {
    const int lane = threadIdx.x & 31;
    for (int g = 0; g < count; g += 32) {
        const int i = g + lane;
        const bool hit = i < count && overlaps(s_box[i], bx0, bx1, by0, by1);
        unsigned m = __ballot_sync(FULL, hit);
        tests += __popc(m);
        while (m) {
            const int e = g + __ffs(m) - 1;
            m &= m - 1u;
            // [a0 b0 c0 a1 | b1 c1 a2 b2 | c2 z0 z1 z2], one broadcast each
            const float4 r0 = s_rec[3 * e], r1 = s_rec[3 * e + 1], r2 = s_rec[3 * e + 2];
            const float w0 = px * r0.x + py * r0.y + r0.z;
            const float w1 = px * r0.w + py * r1.x + r1.y;
            const float w2 = px * r1.z + py * r1.w + r2.x;
            const float eps = -1e-5f;
            if (w0 >= eps && w1 >= eps && w2 >= eps) {
                const float zs = w0 * r2.y + w1 * r2.z + w2 * r2.w;
                if (zs > 1e-12f) {
                    const float z = 1.0f / zs;
                    if (z < best_z) {
                        best_z = z;
                        best_f = s_face[e];
                    }
                }
            }
        }
    }
}

__device__ __forceinline__ float tex_tap(const float* tex, int Ht, int Wt, int y, int x, int c) {
    y = min(max(y, 0), Ht - 1);
    x = min(max(x, 0), Wt - 1);
    return tex[((size_t)y * Wt + x) * 3 + c];
}

#define SMEM_BYTES (CAP * (int)(4 * sizeof(float4) + sizeof(int)) + NTHREADS * (int)sizeof(int))

__global__ void __launch_bounds__(NTHREADS) raster_kernel(
    const float* __restrict__ coeffs,    // (N, F, 10)
    const float* __restrict__ zinv,      // (N, F, 3)
    const float4* __restrict__ fbox,     // (N, C * CHUNK)
    const float4* __restrict__ cbox,     // (N, C)
    const long long* __restrict__ faces, // (F, 3)
    const float* __restrict__ vdata,     // (N, V, D)
    const float* __restrict__ tex,       // (Ht, Wt, 3) or null
    float* __restrict__ color,           // (N, H, W, 3)
    float* __restrict__ xyz,             // (N, H, W, 3)
    float* __restrict__ normal,          // (N, H, W, 3) or null
    uint8_t* __restrict__ mask,          // (N, H, W)
    unsigned long long* __restrict__ stats,  // [tile entries, patch entries, rounds] or null
    int F, int C, int V, int D, int H, int W,
    int c_col, int color_mode, int d_col, int n_col, int Ht, int Wt,
    float w_ambient, float w_diffuse) {
    extern __shared__ float4 smem[];
    float4* s_box = smem;                        // CAP boxes
    float4* s_rec = smem + CAP;                  // CAP records of 3 float4
    int* s_face = (int*)(smem + 4 * CAP);        // CAP face indices
    int* s_chunk = s_face + CAP;                 // NTHREADS chunk indices
    __shared__ int s_wsum[NWARPS];

    const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
    const int n = blockIdx.y;
    const int ntx = (W + TILE - 1) / TILE;
    const int tx0 = (blockIdx.x % ntx) * TILE;
    const int ty0 = (blockIdx.x / ntx) * TILE;
    const int px0 = tx0 + (warp % (TILE / PW)) * PW;
    const int py0 = ty0 + (warp / (TILE / PW)) * PH;
    const int x = px0 + lane % PW;
    const int y = py0 + lane / PW;
    const float px = (float)x, py = (float)y;
    const float tbx0 = (float)tx0, tbx1 = (float)(tx0 + TILE - 1);
    const float tby0 = (float)ty0, tby1 = (float)(ty0 + TILE - 1);
    const float pbx0 = (float)px0, pbx1 = (float)(px0 + PW - 1);
    const float pby0 = (float)py0, pby1 = (float)(py0 + PH - 1);

    const float4* fbox_n = fbox + (size_t)n * C * CHUNK;
    const float4* cbox_n = cbox + (size_t)n * C;
    const float* co_n = coeffs + (size_t)n * F * 10;
    const float* zi_n = zinv + (size_t)n * F * 3;

    float best_z = BIG;
    int best_f = 0;
    int count = 0;  // list entries, the same in every thread
    unsigned long long n_tile = 0, n_patch = 0, n_round = 0;

    for (int c0 = 0; c0 < C; c0 += NTHREADS) {
        // Phase A1: the chunks whose box reaches the tile, in order.
        const int c = c0 + tid;
        const bool live = c < C && overlaps(cbox_n[c], tbx0, tbx1, tby0, tby1);
        int n_live;
        const int at_c = block_rank(live, s_wsum, &n_live);
        if (live) s_chunk[at_c] = c;
        __syncthreads();
        // Phase A2: their faces against the tile, NTHREADS / CHUNK chunks a step.
        for (int j0 = 0; j0 < n_live; j0 += NTHREADS / CHUNK) {
            const int j = j0 + tid / CHUNK;
            int f = 0;
            bool in = false;
            float4 fb;
            if (j < n_live) {
                f = s_chunk[j] * CHUNK + tid % CHUNK;
                fb = fbox_n[f];
                in = overlaps(fb, tbx0, tbx1, tby0, tby1);  // padding faces: empty boxes
            }
            int added;
            const int at = block_rank(in, s_wsum, &added);
            if (count + added > CAP) {  // uniform: a round of phase B, then an empty list
                scan_patch(s_box, s_rec, s_face, count, pbx0, pbx1, pby0, pby1, px, py,
                           best_z, best_f, n_patch);
                ++n_round;
                __syncthreads();
                count = 0;
            }
            if (in) {
                const int e = count + at;
                const float* r = co_n + (size_t)f * 10;
                const float* z = zi_n + (size_t)f * 3;
                s_face[e] = f;
                s_box[e] = fb;
                s_rec[3 * e] = make_float4(r[0], r[1], r[2], r[3]);
                s_rec[3 * e + 1] = make_float4(r[4], r[5], r[6], r[7]);
                s_rec[3 * e + 2] = make_float4(r[8], z[0], z[1], z[2]);
            }
            count += added;
            n_tile += added;
            __syncthreads();
        }
    }
    scan_patch(s_box, s_rec, s_face, count, pbx0, pbx1, pby0, pby1, px, py, best_z, best_f, n_patch);
    if (stats) {
        if (tid == 0) {
            atomicAdd(&stats[0], n_tile);
            atomicAdd(&stats[2], n_round + 1);
        }
        if (lane == 0) atomicAdd(&stats[1], n_patch);
    }
    if (x >= W || y >= H) return;  // after the last barrier

    // Phase C.
    const size_t pix = ((size_t)n * H + y) * W + x;
    float* col = color + pix * 3;
    float* pos = xyz + pix * 3;
    float* nor = normal ? normal + pix * 3 : nullptr;
    if (!(best_z < BIG)) {
        for (int k = 0; k < 3; ++k) {
            col[k] = 0.f;
            pos[k] = 0.f;
            if (nor) nor[k] = 0.f;
        }
        mask[pix] = 0;
        return;
    }

    // Perspective-correct barycentrics rebuilt from the winner's vertices
    // (ops/rasterizer.py::_interpolate, operation for operation).
    const float* vb_n = vdata + (size_t)n * V * D;
    const float* va = vb_n + (size_t)faces[(size_t)best_f * 3 + 0] * D;
    const float* vb = vb_n + (size_t)faces[(size_t)best_f * 3 + 1] * D;
    const float* vc = vb_n + (size_t)faces[(size_t)best_f * 3 + 2] * D;
    const float area2 = (vb[0] - va[0]) * (vc[1] - va[1]) - (vc[0] - va[0]) * (vb[1] - va[1]);
    const float inv_a = fabsf(area2) < 1e-12f ? 0.f : 1.0f / area2;
    const float w0 = ((vb[0] - px) * (vc[1] - py) - (vc[0] - px) * (vb[1] - py)) * inv_a;
    const float w1 = ((vc[0] - px) * (va[1] - py) - (va[0] - px) * (vc[1] - py)) * inv_a;
    const float w2 = 1.0f - w0 - w1;
    const float zi0 = va[4] > 1e-8f ? 1.0f / va[4] : 0.f;
    const float zi1 = vb[4] > 1e-8f ? 1.0f / vb[4] : 0.f;
    const float zi2 = vc[4] > 1e-8f ? 1.0f / vc[4] : 0.f;
    const float zsum = fmaxf(w0 * zi0 + w1 * zi1 + w2 * zi2, 1e-12f);
    const float c0 = w0 * zi0 / zsum;
    const float c1 = w1 * zi1 / zsum;
    const float c2 = 1.0f - c0 - c1;
#define INTERP(j) (va[j] * c0 + vb[j] * c1 + vc[j] * c2)

    for (int k = 0; k < 3; ++k) pos[k] = INTERP(2 + k);

    float rgb[3];
    if (color_mode == 2) {  // bilinear texture at the interpolated uv
        const float tu = INTERP(c_col) * (float)Wt - 0.5f;
        const float tv = INTERP(c_col + 1) * (float)Ht - 0.5f;
        const float fx0 = floorf(tu), fy0 = floorf(tv);
        const float fx = tu - fx0, fy = tv - fy0;
        const int ix = (int)fx0, iy = (int)fy0;
        for (int k = 0; k < 3; ++k) {
            const float top = tex_tap(tex, Ht, Wt, iy, ix, k) * (1.0f - fx) +
                              tex_tap(tex, Ht, Wt, iy, ix + 1, k) * fx;
            const float bot = tex_tap(tex, Ht, Wt, iy + 1, ix, k) * (1.0f - fx) +
                              tex_tap(tex, Ht, Wt, iy + 1, ix + 1, k) * fx;
            rgb[k] = top * (1.0f - fy) + bot * fy;
        }
    } else if (color_mode == 1) {
        for (int k = 0; k < 3; ++k) rgb[k] = INTERP(c_col + k);
    } else {
        for (int k = 0; k < 3; ++k) rgb[k] = 0.5f;
    }
    if (d_col >= 0) {
        const float diff = INTERP(d_col);
        for (int k = 0; k < 3; ++k) rgb[k] = rgb[k] * w_ambient + diff * rgb[k] * w_diffuse;
    }
    for (int k = 0; k < 3; ++k) col[k] = fminf(fmaxf(rgb[k], 0.f), 1.f);
    if (nor) {
        const float n0 = INTERP(n_col), n1 = INTERP(n_col + 1), n2 = INTERP(n_col + 2);
        const float len = fmaxf(sqrtf(n0 * n0 + n1 * n1 + n2 * n2), 1e-12f);
        nor[0] = n0 / len;
        nor[1] = n1 / len;
        nor[2] = n2 / len;
    }
#undef INTERP
    mask[pix] = 1;
}

extern "C" int fp_raster_boxes(
    const float* coeffs, const long long* faces, const float* vdata, float* fbox, float* cbox,
    int N, int F, int V, int D, int H, int W, int C, void* stream) {
    dim3 grid(C, N);
    face_box_kernel<<<grid, CHUNK, 0, (cudaStream_t)stream>>>(
        coeffs, faces, vdata, (float4*)fbox, (float4*)cbox, F, V, D, H, W, C);
    return (int)cudaGetLastError();
}

extern "C" int fp_raster_launch(
    const float* coeffs, const float* zinv, const float* fbox, const float* cbox,
    const long long* faces, const float* vdata, const float* tex,
    float* color, float* xyz, float* normal, uint8_t* mask, unsigned long long* stats,
    int N, int F, int C, int V, int D, int H, int W,
    int c_col, int color_mode, int d_col, int n_col, int Ht, int Wt,
    float w_ambient, float w_diffuse, void* stream) {
    static bool smem_set = false;
    if (!smem_set) {
        const cudaError_t e = cudaFuncSetAttribute(
            raster_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_BYTES);
        if (e != cudaSuccess) return (int)e;
        smem_set = true;
    }
    const int ntx = (W + TILE - 1) / TILE;
    const int nty = (H + TILE - 1) / TILE;
    dim3 grid(ntx * nty, N);
    raster_kernel<<<grid, NTHREADS, SMEM_BYTES, (cudaStream_t)stream>>>(
        coeffs, zinv, (const float4*)fbox, (const float4*)cbox, faces, vdata, tex,
        color, xyz, normal, mask, stats, F, C, V, D, H, W,
        c_col, color_mode, d_col, n_col, Ht, Wt, w_ambient, w_diffuse);
    return (int)cudaGetLastError();
}
