// Tile rasterizer for Hopper (sm_90a): nearest-face raster, perspective-
// correct interpolation and shading of N pose hypotheses in one launch.
//
// Replaces the Pallas TPU kernel foundationpose_tpu/ops/pallas_raster2.py
// (_raster_kernel, launched by raster_pose_pallas). The TPU kernel bins
// faces into per-tile slots with rank matmuls, a 3-limb bf16 one-hot
// routing and capacity rounds, because the TPU has no per-lane gather;
// none of that is needed here. What bounds this kernel on the card is the
// edge-test arithmetic: every pixel tests every face of every chunk whose
// bounding box reaches its tile. The design keeps that work small and the
// result exact:
//   * one block per (pose, 32x32 tile), one thread per pixel;
//   * faces arrive Morton-sorted, so a 128-face chunk covers a compact
//     screen patch; the block skips every chunk whose (padded) bbox misses
//     the tile and stages the others' records in shared memory, where all
//     threads read them as broadcasts;
//   * faces are scanned in ascending index and a face replaces the winner
//     only when strictly nearer, which is the brute path's tie rule (the
//     lowest index wins), so nothing is dropped and there is no overflow;
//   * the edge tests and the interpolation repeat the plain torch path's
//     operations in the same order, built with --fmad=false so no
//     multiply-add is contracted: masks come out bit-equal to it.
// Inputs are prepared in torch (ops/raster_cuda.py): per-face records
// [10 edge coefficients | 3 inverse depths], per-chunk bboxes, faces and
// the packed per-vertex attributes of ops/rasterizer.py::_prepare.

#include <cuda_runtime.h>
#include <stdint.h>

#define TILE 32
#define CHUNK 128
#define REC 13
#define BIG 1e30f

__device__ __forceinline__ float tex_tap(const float* tex, int Ht, int Wt, int y, int x, int c) {
    y = min(max(y, 0), Ht - 1);
    x = min(max(x, 0), Wt - 1);
    return tex[((size_t)y * Wt + x) * 3 + c];
}

__global__ void __launch_bounds__(TILE * TILE) raster_kernel(
    const float* __restrict__ rec,    // (N, Fp, REC)
    const float* __restrict__ cbox,   // (N, C, 4) [x0, x1, y0, y1]
    const int* __restrict__ faces,    // (Fp, 3)
    const float* __restrict__ vdata,  // (N, V, D)
    const float* __restrict__ tex,    // (Ht, Wt, 3) or null
    float* __restrict__ color,        // (N, H, W, 3)
    float* __restrict__ xyz,          // (N, H, W, 3)
    float* __restrict__ normal,       // (N, H, W, 3) or null
    uint8_t* __restrict__ mask,       // (N, H, W)
    int Fp, int V, int D, int H, int W,
    int c_col, int color_mode, int d_col, int n_col, int Ht, int Wt,
    float w_ambient, float w_diffuse) {
    __shared__ float s_rec[CHUNK * REC];

    const int n = blockIdx.y;
    const int ntx = (W + TILE - 1) / TILE;
    const int tx0 = (blockIdx.x % ntx) * TILE;
    const int ty0 = (blockIdx.x / ntx) * TILE;
    const int x = tx0 + (threadIdx.x % TILE);
    const int y = ty0 + (threadIdx.x / TILE);
    const float px = (float)x;
    const float py = (float)y;
    const float bx0 = (float)tx0, bx1 = (float)(tx0 + TILE - 1);
    const float by0 = (float)ty0, by1 = (float)(ty0 + TILE - 1);

    const int C = Fp / CHUNK;
    const float* rec_n = rec + (size_t)n * Fp * REC;
    const float* cbox_n = cbox + (size_t)n * C * 4;

    float best_z = BIG;
    int best_f = 0;
    for (int c = 0; c < C; ++c) {
        const float* bb = cbox_n + c * 4;
        // Same values for every thread: the branch is uniform per block.
        if (bb[0] > bx1 || bb[1] < bx0 || bb[2] > by1 || bb[3] < by0) continue;
        __syncthreads();  // the previous chunk's readers are done
        const float* src = rec_n + (size_t)c * CHUNK * REC;
        for (int i = threadIdx.x; i < CHUNK * REC; i += blockDim.x) s_rec[i] = src[i];
        __syncthreads();
        for (int f = 0; f < CHUNK; ++f) {
            const float* r = s_rec + f * REC;
            if (!(r[9] > 0.f)) continue;
            const float w0 = px * r[0] + py * r[1] + r[2];
            const float w1 = px * r[3] + py * r[4] + r[5];
            const float w2 = px * r[6] + py * r[7] + r[8];
            const float eps = -1e-5f;
            if (w0 >= eps && w1 >= eps && w2 >= eps) {
                const float zs = w0 * r[10] + w1 * r[11] + w2 * r[12];
                if (zs > 1e-12f) {
                    const float z = 1.0f / zs;
                    if (z < best_z) {
                        best_z = z;
                        best_f = c * CHUNK + f;
                    }
                }
            }
        }
    }
    if (x >= W || y >= H) return;  // after the last barrier

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
    const float* va = vb_n + (size_t)faces[best_f * 3 + 0] * D;
    const float* vb = vb_n + (size_t)faces[best_f * 3 + 1] * D;
    const float* vc = vb_n + (size_t)faces[best_f * 3 + 2] * D;
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

extern "C" int fp_raster_launch(
    const float* rec, const float* cbox, const int* faces, const float* vdata,
    const float* tex, float* color, float* xyz, float* normal, uint8_t* mask,
    int N, int Fp, int V, int D, int H, int W,
    int c_col, int color_mode, int d_col, int n_col, int Ht, int Wt,
    float w_ambient, float w_diffuse, void* stream) {
    const int ntx = (W + TILE - 1) / TILE;
    const int nty = (H + TILE - 1) / TILE;
    dim3 grid(ntx * nty, N);
    raster_kernel<<<grid, TILE * TILE, 0, (cudaStream_t)stream>>>(
        rec, cbox, faces, vdata, tex, color, xyz, normal, mask, Fp, V, D, H, W,
        c_col, color_mode, d_col, n_col, Ht, Wt, w_ambient, w_diffuse);
    return (int)cudaGetLastError();
}
