// DM-NeRF field forward (K1) and backward (K2) for the training step, sm_90a.
//
// Replaces the TPU kernels of dmnerf_tpu/ops/pallas/field_kernels.py, the
// custom VJP `fused_field_packed`:
// - K1 `_fwd_call` (body `_fwd_body`): raw [P, 4+K+1] fp32 per point;
// - K2 `_fused_bwd` (body `_bwd_kernel`): recompute the forward, backprop
//   through the heads and the trunk, dW/db in fp32 and, on request, the
//   cotangents of the position and view-direction encodings.
// The math and its bf16 rounding are _fwd_body's and _bwd_kernel's; the
// packed weights are kernels/render_field.py::pack_field's.
//
// What bounds them on the H100: a chain of small matmuls through a 9-layer
// MLP, about 1.4 MFLOP per point forward and twice that backward for the
// 8x256 field. The Pallas backward keeps every weight and one dW accumulator
// in VMEM and relies on the TPU grid running in order; neither carries over.
//
// What the design does about that:
// - Tiles are 64 points of the flat point list (one block each), with the
//   activations of the layer in flight in padded shared memory and the
//   weights read from L2 straight into wmma fragments, as in
//   render_field.cu. The forward of a tile is field_common.cuh's
//   tile_forward, which K1, K2's recompute and K3/K4 all call. PE is
//   computed in the kernel in the reference channel order with precise
//   sinf/cosf.
// - A tile's post-ReLU activations for all layers are ~370 KB of bf16, more
//   than an SM's 228 KB of shared memory, so K2's per-tile pass
//   (field_bwd_tile_kernel) writes each bf16 activation it recomputes to a
//   scratch array `act` [P, ACT] in device memory and reads the ReLU masks
//   back from it (the block's own writes, mostly still in L2). Its backward
//   matmuls run against the transposed weights (col_major fragments of the
//   same packed matrices) and write every bf16 activation gradient dy to a
//   second scratch array `dys` [P, DYW].
// - dW must be deterministic (the same inputs give bit-identical gradients,
//   so a resumed run replays), which rules out fp32 atomics. dW = a^T dy is a
//   separate pass (dw_partial_kernel): one block per 64x64 tile of a weight
//   matrix and per fixed range of `psplit` points writes an fp32 partial;
//   reduce_splits_kernel then adds the partials in split order. The bias
//   gradients are column sums of dys (and of the fp32 cotangent g for the
//   output bias) taken the same way. The scratch columns are laid out so
//   that each matmul's input (e.g. [h_skip | x], [rgb_h | ins_h | h]) is one
//   contiguous column range and the dy columns follow the packed bias order.
// - Rounding is _bwd_kernel's: g is rounded to bf16 for the products (the
//   output-bias gradient sums the fp32 g), every dy is rounded to bf16 after
//   its fp32 product and mask, and the encoding cotangents come back in fp32
//   for the wrapper to round as the TPU kernel stores them (bf16).
// - The instance branch passes no cotangent into the trunk (reference
//   dm_nerf.py:95): d(ins_feat) only feeds the ins_feat dW and bias.
//
// Plain C interface for ctypes; each entry returns the first CUDA error of
// its launches (cudaGetLastError after each) so the wrapper can raise.

#include <algorithm>
#include <cstring>

#include "field_common.cuh"

namespace {

constexpr int MAXJ = MAXD + 5;          // dW jobs: D trunk matrices + 5 head matrices
constexpr int BM = 64, BN = 64;         // dW output tile of one dw_partial block

// Column layout of K2's scratch arrays (bf16 elements per point row).
struct Layout {
    int ACT, DYW;
    int a_x, a_hs[MAXD], a_hh, a_rgbf, a_encd, a_insf;    // act columns
    int y_dy[MAXD], y_rgbf, y_rh, y_insf, y_ih, y_gb;      // dys columns
    int NB;             // dys columns [0, NB) are the packed biases' order
};

Layout make_layout(const Meta& m) {
    Layout L;
    const int D = m.D, W = m.W;
    int c = 0;
    if (m.skip >= D - 1) { L.a_x = c; c += m.XP; }     // no skip concat
    for (int i = 0; i < D - 1; ++i) {
        L.a_hs[i] = c; c += W;
        if (i == m.skip) { L.a_x = c; c += m.XP; }     // [h_skip | x]
    }
    L.a_hh = c; c += W;                                // [rgb_h | ins_h | h]
    L.a_hs[D - 1] = c; c += W;
    L.a_rgbf = c; c += W;                              // [rgb_f | enc_d]
    L.a_encd = c; c += m.DP;
    L.a_insf = c; c += W;
    L.ACT = c;
    c = 0;
    for (int i = 0; i < D; ++i) { L.y_dy[i] = c; c += W; }
    L.y_rgbf = c; c += W;
    L.y_rh = c; c += W / 2;
    L.y_insf = c; c += W;
    L.y_ih = c; c += W / 2;
    L.NB = c;
    L.y_gb = c; c += m.CP;
    L.DYW = c;
    return L;
}

// Save policy of K2's forward recompute (see field_common.cuh::NoSave):
// every bf16 activation to this tile's rows of act, at its Layout column.
struct SaveAct {
    bf16* arow; int ld; const Layout& L;
    __device__ __forceinline__ int col(Act a, int layer) const {
        switch (a) {
            case A_X: return L.a_x;
            case A_H: return L.a_hs[layer];
            case A_RGBF: return L.a_rgbf;
            case A_ENCD: return L.a_encd;
            case A_HH: return L.a_hh;
            default: return L.a_insf;
        }
    }
    __device__ __forceinline__ void put(int r, int c, bf16 v) const {
        arow[(size_t)r * ld + c] = v;
    }
};

// dW = act[:, a_off:a_off+K]^T @ dys[:, y_off:y_off+N] into the packed
// matrix at w_off ([K, N] row-major); tile0 is the prefix count of 64x64 tiles.
struct Jobs {
    int n;
    int a_off[MAXJ], K[MAXJ], y_off[MAXJ], N[MAXJ], w_off[MAXJ], tile0[MAXJ + 1];
};

Jobs make_jobs(const Meta& m, const Layout& L) {
    Jobs J;
    J.n = 0;
    J.tile0[0] = 0;
    auto add = [&](int a, int K, int y, int N, int w) {
        const int j = J.n++;
        J.a_off[j] = a; J.K[j] = K; J.y_off[j] = y; J.N[j] = N; J.w_off[j] = w;
        J.tile0[j + 1] = J.tile0[j] + ((K + BM - 1) / BM) * ((N + BN - 1) / BN);
    };
    const int D = m.D, W = m.W;
    add(L.a_x, m.XP, L.y_dy[0], W, m.off_t[0]);
    for (int i = 1; i < D; ++i) {
        const bool sk = (i == m.skip + 1);
        add(sk ? L.a_hs[m.skip] : L.a_hs[i - 1], sk ? W + m.XP : W, L.y_dy[i], W,
            m.off_t[i]);
    }
    add(L.a_hs[D - 1], W, L.y_rgbf, W, m.off_rgbf);
    add(L.a_rgbf, W + m.DP, L.y_rh, W / 2, m.off_rh);
    add(L.a_hs[D - 1], W, L.y_insf, W, m.off_insf);
    add(L.a_insf, W, L.y_ih, W / 2, m.off_ih);
    add(L.a_hh, 2 * W, L.y_gb, m.CP, m.off_out);
    return J;
}

// Epilogue that hands every element of the fp32 products to f(row, col, v),
// through the warp's 16x16 fp32 scratch tile.
template <class F>
struct PerElem {
    F f; float* scratch;
    __device__ __forceinline__ void operator()(Acc (&acc)[RT], int ct) const {
        const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
        float* sc = scratch + warp * 256;
        for (int r = 0; r < RT; ++r) {
            wmma::store_matrix_sync(sc, acc[r], 16, wmma::mem_row_major);
            __syncwarp();
            for (int e = lane; e < 256; e += 32) f(r * 16 + e / 16, ct * 16 + e % 16, sc[e]);
            __syncwarp();
        }
    }
};

template <class F>
__device__ __forceinline__ PerElem<F> per_elem(F f, float* scratch) {
    return PerElem<F>{f, scratch};
}

// acc[RT] += A [TP, K] (ld lda, shared) @ Wt^T for output column tile ct,
// where Wt is a packed [rows, ldw] row-major matrix whose row j is output
// column j: a col_major fragment of Wt is a row_major fragment of Wt^T.
__device__ __forceinline__ void mma_segment_t(Acc (&acc)[RT], const bf16* A, int lda, int K,
                                              const bf16* Wt, int ldw, int ct) {
    for (int k = 0; k < K; k += 16) {
        wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::col_major> bfr;
        wmma::load_matrix_sync(bfr, Wt + (size_t)ct * 16 * ldw + k, ldw);
#pragma unroll
        for (int r = 0; r < RT; ++r) {
            wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> afr;
            wmma::load_matrix_sync(afr, A + r * 16 * lda + k, lda);
            wmma::mma_sync(acc[r], afr, bfr, acc[r]);
        }
    }
}

// out[TP, N] = A1 @ W1^T + A2 @ W2^T (the backward of `matmul`).
template <class Epilogue>
__device__ __forceinline__ void matmul_t(const bf16* A1, int lda1, int K1, const bf16* W1,
                                         int ldw1, const bf16* A2, int lda2, int K2,
                                         const bf16* W2, int ldw2, int N, Epilogue epi) {
    const int warp = threadIdx.x / 32;
    for (int ct = warp; ct < N / 16; ct += NWARPS) {
        Acc acc[RT];
#pragma unroll
        for (int r = 0; r < RT; ++r) wmma::fill_fragment(acc[r], 0.0f);
        mma_segment_t(acc, A1, lda1, K1, W1, ldw1, ct);
        if (K2) mma_segment_t(acc, A2, lda2, K2, W2, ldw2, ct);
        epi(acc, ct);
    }
}

__device__ __forceinline__ float relu_mask(bf16 a) {
    return __bfloat162float(a) > 0.0f ? 1.0f : 0.0f;
}

// three [TP, W+PAD] bf16 activation buffers and one fp32 16x16 tile per warp
size_t smem_bytes(const Meta& m) {
    return 3 * (size_t)TP * (m.W + PAD) * sizeof(bf16) + NWARPS * 256 * sizeof(float);
}

// K1: raw [P, C] for points pts [P, 3] and directions vdirs [P / ppd, 3]
// (point p looks along direction p / ppd): tile_forward, with the position
// encoding in the third buffer during the trunk and the view encoding and
// the hidden pair in it after (as render_field.cu's K3), then the output layer.
__global__ void __launch_bounds__(NTHREADS, 2)
field_forward_kernel(const float* __restrict__ pts, const float* __restrict__ vdirs,
                     int P, int ppd, const bf16* __restrict__ w,
                     const float* __restrict__ b, const Meta m, float* __restrict__ raw) {
    extern __shared__ __align__(128) unsigned char smem[];
    const int W = m.W, CP = m.CP, C = m.C;
    const int LDA = W + PAD;
    bf16* bufA = reinterpret_cast<bf16*>(smem);
    bf16* bufB = bufA + TP * LDA;
    bf16* bufC = bufB + TP * LDA;
    float* scratch = reinterpret_cast<float*>(bufC + TP * LDA);
    const int p0 = blockIdx.x * TP;
    const int nv = min(TP, P - p0);
    const int tid = threadIdx.x;

    bf16* h = tile_forward<H_ALL>(pts + (size_t)p0 * 3, nv, vdirs, p0, ppd, w, b, m, bufA, bufB,
                                  bufC, bufC, LDA, scratch, NoSave{});
    // raw = [rgb_h, ins_h, h] @ Wout + bo: rgb 0:3, sigma 3, ins 4:C
    float* stage = reinterpret_cast<float*>(h == bufA ? bufB : bufA);
    matmul(bufC, LDA, W, h, LDA, W, w + m.off_out, CP, StoreF32{stage, CP});
    __syncthreads();

    const float* bo = b + m.boff_o;
    for (int i = tid; i < nv * C; i += NTHREADS) {
        const int r = i / C, c = i % C;
        raw[(size_t)(p0 + r) * C + c] = stage[r * CP + c] + bo[c];
    }
}

// K2, per-tile pass: the forward again (every bf16 activation to `act`),
// then the backward through the heads and the trunk (every bf16 dy to
// `dys`). gx [P, XP] / gd [P, DP] (fp32 encoding cotangents) are written
// only when non-null.
__global__ void __launch_bounds__(NTHREADS, 2)
field_bwd_tile_kernel(const float* __restrict__ pts, const float* __restrict__ vdirs,
                      int P, int ppd, const bf16* __restrict__ w,
                      const float* __restrict__ b, const Meta m, const Layout L,
                      const float* __restrict__ g, bf16* __restrict__ act,
                      bf16* __restrict__ dys, float* __restrict__ gx,
                      float* __restrict__ gd) {
    extern __shared__ __align__(128) unsigned char smem[];
    const int W = m.W, XP = m.XP, DP = m.DP, CP = m.CP, C = m.C, D = m.D, HW = m.W / 2;
    const int LDA = W + PAD, LDG = CP + PAD;
    const int ACT = L.ACT, DYW = L.DYW;
    bf16* bufA = reinterpret_cast<bf16*>(smem);
    bf16* bufB = bufA + TP * LDA;
    bf16* bufC = bufB + TP * LDA;
    float* scratch = reinterpret_cast<float*>(bufC + TP * LDA);
    const int p0 = blockIdx.x * TP;
    const int nv = min(TP, P - p0);
    const int tid = threadIdx.x;
    bf16* arow = act + (size_t)p0 * ACT;      // this tile's scratch rows
    bf16* yrow = dys + (size_t)p0 * DYW;

    // ---- forward, saving every activation to act ----------------------------
    tile_forward<H_ALL>(pts + (size_t)p0 * 3, nv, vdirs, p0, ppd, w, b, m, bufA, bufB, bufC,
                        bufC, LDA, scratch, SaveAct{arow, ACT, L});

    // ---- backward ---------------------------------------------------------
    // gb = bf16(g) [TP, CP] in bufC (ld LDG) and in dys
    bf16* G = bufC;
    for (int i = tid; i < TP * CP; i += NTHREADS) {
        const int r = i / CP, c = i % CP;
        const float v = (r < nv && c < C) ? g[(size_t)(p0 + r) * C + c] : 0.0f;
        const bf16 o = __float2bfloat16_rn(v);
        G[r * LDG + c] = o;
        yrow[(size_t)r * DYW + L.y_gb + c] = o;
    }
    __syncthreads();

    // dy = bf16(v * relu'(act[:, mcol + c])): to shared memory (if sdst) and
    // to dys column ycol + c
    auto masked = [&](int mcol, bf16* sdst, int ycol) {
        return per_elem([=](int r, int c, float v) {
            const bf16 o = __float2bfloat16_rn(v * relu_mask(arow[(size_t)r * ACT + mcol + c]));
            if (sdst) sdst[r * LDA + c] = o;
            yrow[(size_t)r * DYW + ycol + c] = o;
        }, scratch);
    };

    const bf16* Wout = w + m.off_out;                  // [2W, CP]
    // [d_rgb_h | d_ins_h] = mask(hh) * (gb @ Wout[0:W]^T) -> bufA, dys
    const int y_rh = L.y_rh, y_ih = L.y_ih, a_hh = L.a_hh;
    matmul_t(G, LDG, CP, Wout, CP, nullptr, 0, 0, nullptr, 0, W,
             per_elem([=](int r, int c, float v) {
                 const bf16 o = __float2bfloat16_rn(v * relu_mask(arow[(size_t)r * ACT + a_hh + c]));
                 bufA[r * LDA + c] = o;
                 yrow[(size_t)r * DYW + (c < HW ? y_rh + c : y_ih + c - HW)] = o;
             }, scratch));
    __syncthreads();
    // d_ins_f = d_ins_h @ Wih^T: its dW and bias only, never the trunk
    const int y_insf = L.y_insf;
    matmul_t(bufA + HW, LDA, HW, w + m.off_ih, HW, nullptr, 0, 0, nullptr, 0, W,
             per_elem([=](int r, int c, float v) {
                 yrow[(size_t)r * DYW + y_insf + c] = __float2bfloat16_rn(v);
             }, scratch));
    // [d_rgb_f | g_d] = d_rgb_h @ Wrh^T; d_rgb_f -> bufB, dys; g_d -> gd
    const int y_rgbf = L.y_rgbf;
    matmul_t(bufA, LDA, HW, w + m.off_rh, HW, nullptr, 0, 0, nullptr, 0, gd ? W + DP : W,
             per_elem([=](int r, int c, float v) {
                 if (c < W) {
                     const bf16 o = __float2bfloat16_rn(v);
                     bufB[r * LDA + c] = o;
                     yrow[(size_t)r * DYW + y_rgbf + c] = o;
                 } else {
                     gd[(size_t)(p0 + r) * DP + c - W] = v;
                 }
             }, scratch));
    __syncthreads();
    // d_h = gb @ Wout[W:2W]^T (density) + d_rgb_f @ Wrgbf^T; dy_{D-1} -> bufA
    matmul_t(G, LDG, CP, Wout + (size_t)W * CP, CP, bufB, LDA, W, w + m.off_rgbf, W, W,
             masked(L.a_hs[D - 1], bufA, L.y_dy[D - 1]));
    __syncthreads();

    bf16* cur = bufA;
    bf16* nxt = bufB;
    for (int i = D - 1; i >= 1; --i) {
        const bool sk = (i == m.skip + 1);
        const int mcol = L.a_hs[i - 1], ycol = L.y_dy[i - 1];
        // rows 0:W of t_i face h_{i-1}; at the skip layer rows W:W+XP face x
        matmul_t(cur, LDA, W, w + m.off_t[i], W, nullptr, 0, 0, nullptr, 0,
                 (sk && gx) ? W + XP : W,
                 per_elem([=](int r, int c, float v) {
                     if (c < W) {
                         const bf16 o = __float2bfloat16_rn(
                             v * relu_mask(arow[(size_t)r * ACT + mcol + c]));
                         nxt[r * LDA + c] = o;
                         yrow[(size_t)r * DYW + ycol + c] = o;
                     } else {
                         gx[(size_t)(p0 + r) * XP + c - W] = v;
                     }
                 }, scratch));
        __syncthreads();
        bf16* t = cur; cur = nxt; nxt = t;
    }
    if (gx) {
        const bool skipped = m.skip + 1 < D;        // gx already holds the skip part
        matmul_t(cur, LDA, W, w + m.off_t[0], W, nullptr, 0, 0, nullptr, 0, XP,
                 per_elem([=](int r, int c, float v) {
                     float* q = gx + (size_t)(p0 + r) * XP + c;
                     *q = skipped ? *q + v : v;
                 }, scratch));
    }
}

// K2, dW pass: per (64x64 tile of one job's dW, range of psplit points) an
// fp32 partial of act^T @ dys into partial[blockIdx.y]. Each warp owns one
// 16-row strip and two 16-column tiles.
__global__ void __launch_bounds__(NTHREADS)
dw_partial_kernel(const bf16* __restrict__ act, int ACT, const bf16* __restrict__ dys,
                  int DYW, int P_pad, int psplit, const Jobs J,
                  float* __restrict__ partial, int n_w) {
    const int t = blockIdx.x;
    int j = 0;
    while (j + 1 < J.n && J.tile0[j + 1] <= t) ++j;
    const int K = J.K[j], N = J.N[j];
    const int tn = (N + BN - 1) / BN, local = t - J.tile0[j];
    const int warp = threadIdx.x / 32;
    const int m = (local / tn) * BM + (warp / 2) * 16;
    const int n0 = (local % tn) * BN + (warp % 2) * 32;
    if (m >= K) return;
    const bool has1 = n0 + 16 < N;
    if (n0 >= N) return;

    const int p_begin = blockIdx.y * psplit, p_end = min(P_pad, p_begin + psplit);
    const bf16* ap = act + J.a_off[j] + m;
    const bf16* yp = dys + J.y_off[j] + n0;
    Acc acc0, acc1;
    wmma::fill_fragment(acc0, 0.0f);
    wmma::fill_fragment(acc1, 0.0f);
    for (int p = p_begin; p < p_end; p += 16) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::col_major> afr;
        wmma::load_matrix_sync(afr, ap + (size_t)p * ACT, ACT);
        wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> bfr;
        wmma::load_matrix_sync(bfr, yp + (size_t)p * DYW, DYW);
        wmma::mma_sync(acc0, afr, bfr, acc0);
        if (has1) {
            wmma::load_matrix_sync(bfr, yp + (size_t)p * DYW + 16, DYW);
            wmma::mma_sync(acc1, afr, bfr, acc1);
        }
    }
    float* dst = partial + (size_t)blockIdx.y * n_w + J.w_off[j] + (size_t)m * N + n0;
    wmma::store_matrix_sync(dst, acc0, N, wmma::mem_row_major);
    if (has1) wmma::store_matrix_sync(dst + 16, acc1, N, wmma::mem_row_major);
}

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(bf16 v) { return __bfloat162float(v); }

// partial[blockIdx.y][pcol + c] = sum over rows [y*psplit, (y+1)*psplit) of
// x[row, c] for c < ncols, added in row order.
template <class T>
__global__ void colsum_partial_kernel(const T* __restrict__ x, int ld, int ncols, int rows,
                                      int psplit, float* __restrict__ partial, int pld,
                                      int pcol) {
    const int c = blockIdx.x * blockDim.x + threadIdx.x;
    if (c >= ncols) return;
    const int p_end = min(rows, (int)(blockIdx.y + 1) * psplit);
    float s = 0.0f;
    for (int p = blockIdx.y * psplit; p < p_end; ++p) s += to_f32(x[(size_t)p * ld + c]);
    partial[(size_t)blockIdx.y * pld + pcol + c] = s;
}

// out[e] = sum over splits s (in order) of partial[s][e]
__global__ void reduce_splits_kernel(const float* __restrict__ partial, int n_split, int n,
                                     float* __restrict__ out) {
    for (int e = blockIdx.x * blockDim.x + threadIdx.x; e < n; e += gridDim.x * blockDim.x) {
        float s = 0.0f;
        for (int k = 0; k < n_split; ++k) s += partial[(size_t)k * n + e];
        out[e] = s;
    }
}

int read_meta(const int* meta, int n_meta, Meta* m) {
    if (n_meta != META_INTS) return (int)cudaErrorInvalidValue;
    memcpy(m, meta, sizeof(Meta));
    if (m->D < 1 || m->D > MAXD || m->W % 32 || m->XP % 16 || m->DP % 16 || m->CP % 16
        || m->XP > m->W || m->DP > m->W / 2 || m->CP > m->W / 2)
        return (int)cudaErrorInvalidValue;
    return 0;
}

}  // namespace

extern "C" {

// Scratch widths (bf16 per point) of field_backward: act and dys.
int field_scratch_widths(const int* meta, int n_meta, int* act_w, int* dy_w) {
    Meta m;
    if (int err = read_meta(meta, n_meta, &m)) return err;
    const Layout L = make_layout(m);
    *act_w = L.ACT;
    *dy_w = L.DYW;
    return 0;
}

// K1: raw [P, C] <- pts [P, 3], vdirs [ceil(P / ppd), 3] (fp32).
int field_forward(const float* pts, const float* vdirs, int P, int ppd, const bf16* w,
                  const float* b, const int* meta, int n_meta, float* raw, void* stream) {
    Meta m;
    if (int err = read_meta(meta, n_meta, &m)) return err;
    if (P < 1 || ppd < 1) return (int)cudaErrorInvalidValue;
    const size_t smem = smem_bytes(m);
    cudaError_t err = cudaFuncSetAttribute(field_forward_kernel,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                                           (int)smem);
    if (err != cudaSuccess) return (int)err;
    field_forward_kernel<<<(P + TP - 1) / TP, NTHREADS, smem, (cudaStream_t)stream>>>(
        pts, vdirs, P, ppd, w, b, m, raw);
    return (int)cudaGetLastError();
}

// K2: dw [n_w], db [n_b] (the packed layouts, fp32) and, when gx / gd are
// non-null, the encoding cotangents gx [P_pad, XP], gd [P_pad, DP] (fp32)
// <- pts, vdirs as for K1, g [P, C] fp32. Scratch: act [P_pad, act_w] and
// dys [P_pad, dy_w] bf16, partial_w [ceil(P_pad / psplit), n_w] and
// partial_b [ceil(P_pad / psplit), n_b] fp32 zero-filled, with P_pad = P
// rounded up to 64 and psplit a multiple of 16.
int field_backward(const float* pts, const float* vdirs, int P, int ppd, const bf16* w,
                   const float* b, const int* meta, int n_meta, const float* g,
                   bf16* act, int act_w, bf16* dys, int dy_w, float* gx, float* gd,
                   float* partial_w, int n_w, float* partial_b, int n_b, int psplit,
                   float* dw, float* db, void* stream) {
    Meta m;
    if (int err = read_meta(meta, n_meta, &m)) return err;
    const Layout L = make_layout(m);
    const Jobs J = make_jobs(m, L);
    if (P < 1 || ppd < 1 || psplit < 16 || psplit % 16 || act_w != L.ACT || dy_w != L.DYW
        || n_b != L.NB + m.CP || n_w < m.off_out + 2 * m.W * m.CP)
        return (int)cudaErrorInvalidValue;
    cudaStream_t st = (cudaStream_t)stream;
    const int tiles = (P + TP - 1) / TP, P_pad = tiles * TP;
    const int n_split = (P_pad + psplit - 1) / psplit;
    cudaError_t err;

    const size_t smem = smem_bytes(m);
    err = cudaFuncSetAttribute(field_bwd_tile_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
    field_bwd_tile_kernel<<<tiles, NTHREADS, smem, st>>>(pts, vdirs, P, ppd, w, b, m, L, g,
                                                         act, dys, gx, gd);
    if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;

    dw_partial_kernel<<<dim3(J.tile0[J.n], n_split), NTHREADS, 0, st>>>(
        act, L.ACT, dys, L.DYW, P_pad, psplit, J, partial_w, n_w);
    if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;

    colsum_partial_kernel<bf16><<<dim3((L.NB + 255) / 256, n_split), 256, 0, st>>>(
        dys, L.DYW, L.NB, P_pad, psplit, partial_b, n_b, 0);
    if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
    colsum_partial_kernel<float><<<dim3((m.C + 255) / 256, n_split), 256, 0, st>>>(
        g, m.C, m.C, P, psplit, partial_b, n_b, L.NB);
    if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;

    reduce_splits_kernel<<<std::min((n_w + 255) / 256, 4096), 256, 0, st>>>(
        partial_w, n_split, n_w, dw);
    if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
    reduce_splits_kernel<<<(n_b + 255) / 256, 256, 0, st>>>(partial_b, n_split, n_b, db);
    return (int)cudaGetLastError();
}

const char* field_error_string(int err) {
    return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
