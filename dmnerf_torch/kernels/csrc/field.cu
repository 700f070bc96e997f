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
// What bounds them on the H100: operations. A chain of matmuls through a
// 9-layer MLP, 1.39 MFLOP per point forward for the 8x256 field against 12
// bytes in and 148 out; the backward is about 2.85 times the forward. The
// Pallas kernels keep every weight in VMEM and K2's dW accumulator in
// scratch across an in-order grid; neither carries over. On the card the
// tensor-core products and the shared-memory traffic of their operand
// fragments take most of the time, then the weight slabs' L2 reads and the
// per-slab barrier (PERF.md §6 measures each by taking it out).
//
// What the design does about that (the core is field_core.cuh):
// - Tiles of 128 points, one block of 16 warps each, on mma.sync m16n8k16
//   bf16 tensor cores with fp32 accumulators in registers. The weights (1.40
//   MB bf16 for the flagship field, far more than a block's shared memory)
//   stream through a ring of slabs in shared memory by cp.async (K1: 2
//   stages of 64 rows; K2, which also holds the ReLU masks: 2 of 32, or of
//   16 where those do not fit in a block's shared memory, CP > 64 at W 256),
//   prefetched across layer boundaries, so each weight is read from L2 once
//   per 128 points (4,608 x 1.40 MB = 6.45 GB per call at 589,824 points)
//   with the next slab in flight. The epilogues (bias, ReLU, bf16 rounding)
//   run on the accumulators and store bf16 pairs.
// - mma.sync here: a wgmma version of this core (B from the ring in the
//   canonical no-swizzle layout, A from registers) gave the same results on
//   the card but was slower, since each slab waited for its products before
//   the block barrier. The bf16 K2 now runs a pipeline of its own at widths
//   128 and 256 (field_bwd_wgmma.cuh, launch_backward_wgmma: a producer
//   warpgroup feeding a TMA ring behind mbarriers, consumer warpgroups on
//   wgmma; kernels/field.py::k2_core chooses it by shape); this core keeps
//   K1, K2's other shapes and every f32 build. Measured on the card (PERF.md
//   section 6), the mma.sync K2 at 589,824 points spent 12.9 ms in its tile
//   pass and 5.6 ms in the dW GEMM: taking out its weight slab loads saved
//   22% of the tile pass, its per-slab barrier 7%, its act/dys row stores 27%,
//   and the dW GEMM's staging 31% of the GEMM.
// - Each layer's output is written over its input once every warp has read
//   it (the accumulators hold the whole output), so a tile needs two
//   activation buffers: H (the trunk, then ins_f/ins_h) and Bf (the
//   encodings, rgb_f/rgb_h, and K2's cotangent g). K1 takes the density rows
//   of the output layer while h is still in H and keeps them in registers
//   until rgb_h and ins_h are done. That forward (forward_tile) lives in
//   field_tile.cuh, which render_field.cu's K3 and K5 run too.
// - K2's per-tile pass (field_bwd_tile_kernel) recomputes the forward on the
//   same core, stores every bf16 activation to a scratch array `act`
//   [P, ACT] (the dW pass reads it) by bulk asynchronous copies, one per row,
//   that overlap the next layer, and keeps the ReLU masks of the tile on
//   chip: one bit per value, in the same thread and register position that
//   the backward's accumulator of that layer takes, in shared memory. The
//   backward matmuls read the same packed matrices transposed (the ring's
//   trans segments) and store every bf16 activation gradient dy to a second
//   scratch array `dys` [P, DYW] the same way.
// - dW must be deterministic (the same inputs give bit-identical gradients,
//   so a resumed run replays): no fp32 atomics. dW = act^T dy is a tiled
//   tensor-core GEMM (dw_partial_kernel): one block per 128 x 256 tile of a
//   weight matrix (every column of a layer, so act is read once) and per
//   fixed range of `psplit` points, act and dys staged
//   by cp.async in 32-point slabs, writes an fp32 partial; the blocks of the
//   first row tile also sum their dy slab's columns (the bias gradients,
//   from the fp32 g for the output bias) in a fixed order.
//   reduce_splits_kernel adds the partials in split order.
// - Rounding is _bwd_kernel's: g is rounded to bf16 for the products (the
//   output-bias gradient sums the fp32 g), every dy is rounded to bf16 after
//   its fp32 product and mask, and the encoding cotangents come back in fp32
//   for the wrapper to round as the TPU kernel stores them (bf16).
// - The instance branch passes no cotangent into the trunk (reference
//   dm_nerf.py:95): d(ins_feat) only feeds the ins_feat dW and bias.
//
// - The f32 builds (field_forward_f32, field_backward_f32; the JAX kernels
//   with compute_dtype float32) run the same code on the core's float build:
//   64-point tiles, fp32 activations and scratch (act/dys twice the bytes),
//   and slabs half as deep (shared memory holds f32 H and Bf of 64 rows).
//   Their products are three TF32 passes on the tensor cores (mma.sync
//   m16n8k8: lo_a hi_b, hi_a lo_b, hi_a hi_b of split operands, fp32
//   accumulation; field_core.cuh): K1, K2's backward matmuls and the dW
//   GEMM. Their first design, fp32 FFMA with each thread at its fragment
//   positions, was bound by shared-memory words per FMA: 4 in the tile
//   pass, one scalar A and one float2 B load per 16 FMAs in the dW GEMM, at
//   32-34% of the 67 TFLOP/s fp32 peak and 1.01-1.05x the plain f32 path's
//   time (PERF.md section 6). K2's forward recompute keeps that in-order
//   FFMA loop: the gradients are held to 1e-4 relative L2 of the plain f32
//   path, which only holds where both take the same ReLU masks. Three TF32
//   passes are as accurate as an fp32 GEMM but rounded elsewhere: on the
//   card, with them in the recompute too, the trunk's gradients moved by
//   1.8e-3 relative L2 at 196,608 points, and by 1.1e-5 once the 1.3% of
//   points with a pre-activation within 1e-5 of zero carried no cotangent
//   (their masks flip); with the FFMA recompute, 6.8e-6 at every point.
//   Activations, gradients and sums stay fp32.
//
// Plain C interface for ctypes; each entry returns the first CUDA error of
// its launches (cudaGetLastError after each) so the wrapper can raise.

#include <algorithm>
#include <cstring>

#include "field_bwd_wgmma.cuh"
#include "field_tile.cuh"

using core::Ring;

namespace {

// weight ring of each kernel: stages x slab depth, per element type (shared
// memory: K2 also holds the ReLU masks, and takes slabs half as deep where a
// g tile wider than the view encoding leaves no room for K2_KS; the float
// build's tiles take twice the bytes per row, so its slabs are half as deep)
constexpr int K1_STAGES = 2, K2_STAGES = 2;
template <class T> constexpr int K1_KS = sizeof(T) == 2 ? 64 : 32;
template <class T> constexpr int K2_KS = sizeof(T) == 2 ? 32 : 16;
constexpr int MAXJ = MAXD + 5;          // dW jobs: D trunk matrices + 5 head matrices
constexpr int BM = 128, BN = 256, BK = 32, DW_STAGES = 3;   // dW GEMM tiles
// the dW slabs' row padding, in elements: 16 bytes in bf16 (ldmatrix rows in
// distinct bank groups); 8 words in float, so that a warp's scalar fragment
// loads (rows t and t + 4, columns g) hit 32 distinct banks
constexpr int DW_PAD = 8;
constexpr int NJ = BN / 32;             // 8-column tiles per dW warp
constexpr int DW_THREADS = 256;         // the dW GEMM's block: 8 warps

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

// ---- the backward's weight plan ------------------------------------------------

// field_bwd_tile_kernel's backward segments
template <class T>
void plan_backward(Planner<T>& B, const Meta& m, bool need_x, bool need_d) {
    const int W = m.W, HW = m.W / 2;
    B.add(m.off_out, m.CP, 0, HW, 1);                          // d_rgb_h
    B.add(m.off_out, m.CP, HW, HW, 1);                         // d_ins_h
    B.add(m.off_ih, HW, 0, W, 1);                              // d_ins_f
    B.add(m.off_rh, HW, 0, W, 1);                              // d_rgb_f
    if (need_d) B.add(m.off_rh, HW, W, m.DP, 1);               // g_d
    B.add(m.off_out, m.CP, W, W, 1);                           // d_h: density
    B.add(m.off_rgbf, W, 0, W, 1);                             //      + rgb branch
    for (int i = m.D - 1; i >= 1; --i) {
        if (i == m.skip + 1 && need_x) B.add(m.off_t[i], W, W, m.XP, 1);   // g_x part
        B.add(m.off_t[i], W, 0, W, 1);
    }
    if (need_x) B.add(m.off_t[0], W, 0, m.XP, 1);
}

// K1: raw [P, C] for points pts [P, 3] and directions vdirs [P / ppd, 3].
template <class T>
__global__ void __launch_bounds__(THREADS, 1)
field_forward_kernel(const float* __restrict__ pts, const float* __restrict__ vdirs, int P,
                     int ppd, const T* __restrict__ w, const float* __restrict__ b,
                     const Meta m, const __grid_constant__ Plan plan,
                     float* __restrict__ raw) {
    extern __shared__ __align__(128) unsigned char smem[];
    constexpr int TM = core::TM<T>;
    const Bufs<T> B = carve<T>(smem, m, plan, K1_STAGES, false);
    const int p0 = blockIdx.x * TM;
    const int nv = min(TM, P - p0);
    Ring<T, K1_STAGES, K1_KS<T>> R;
    R.start(B.ring, &plan, w);
    core::Acc<T> acc;
    core::AccT<T, core::NTO> acc_out;
    forward_tile<H_ALL, true, false>(R, B, acc, acc_out, pts + (size_t)p0 * 3, nv, vdirs, p0,
                                     ppd, b, m, Save<T>{nullptr, nullptr, nullptr});
    // raw = acc_out + bo: rgb 0:3, sigma 3, ins 4:C
    const float* bo = b + m.boff_o;
    const int C = m.C;
    core::for_pairs(acc_out, m.CP, [&](int r, int c, float v0, float v1, int) {
        if (r < nv) {
            float* q = raw + (size_t)(p0 + r) * C + c;
            if (c < C) q[0] = v0 + bo[c];
            if (c + 1 < C) q[1] = v1 + bo[c + 1];
        }
    });
}

// Epilogue: fp32 accumulators to the tile's rows of a global [rows, ld]
// array, added to what is there when add.
template <int M>
__device__ __forceinline__ void store_f32(float (&acc)[M][core::NT][4], int n, float* dst, int ld,
                                          bool add) {
    core::for_pairs(acc, n, [&](int r, int c, float v0, float v1, int) {
        float2* q = reinterpret_cast<float2*>(dst + (size_t)r * ld + c);
        if (add) { const float2 o = *q; v0 += o.x; v1 += o.y; }
        *q = make_float2(v0, v1);
    });
}

// K2, per-tile pass: the forward again (every bf16 activation to `act`, the
// ReLU masks to shared memory), then the backward through the heads and the
// trunk (every bf16 dy to `dys`). gx [P_pad, XP] / gd [P_pad, DP] (fp32
// encoding cotangents) are written only when non-null; the plan has their
// segments exactly then. KS: the ring's slab depth.
template <class T, int KS>
__global__ void __launch_bounds__(THREADS, 1)
field_bwd_tile_kernel(const float* __restrict__ pts, const float* __restrict__ vdirs, int P,
                      int ppd, const T* __restrict__ w, const float* __restrict__ b,
                      const Meta m, const __grid_constant__ Layout L,
                      const __grid_constant__ Plan plan,
                      const float* __restrict__ g, T* __restrict__ act,
                      T* __restrict__ dys, float* __restrict__ gx,
                      float* __restrict__ gd) {
    extern __shared__ __align__(128) unsigned char smem[];
    constexpr int TM = core::TM<T>;
    const Bufs<T> B = carve<T>(smem, m, plan, K2_STAGES, true);
    uint32_t* masks = reinterpret_cast<uint32_t*>(B.tail);
    const int W = m.W, XP = m.XP, DP = m.DP, CP = m.CP, C = m.C, D = m.D, HW = m.W / 2;
    const int p0 = blockIdx.x * TM;
    const int nv = min(TM, P - p0);
    const int tid = threadIdx.x;
    T* yrow = dys + (size_t)p0 * L.DYW;
    T* H = B.H;
    T* Bf = B.Bf;
    const int ldh = B.ldh, ldb = B.ldb;
    Ring<T, K2_STAGES, KS> R;
    R.start(B.ring, &plan, w);
    core::Acc<T> acc;
    core::AccT<T, 1> unused;

    // ---- forward, saving every activation to act ------------------------------
    const Save<T> save{act + (size_t)p0 * L.ACT, &L, masks};
    forward_tile<H_ALL, false, true>(R, B, acc, unused, pts + (size_t)p0 * 3, nv, vdirs, p0,
                                     ppd, b, m, save);

    // ---- backward -------------------------------------------------------------
    // gb = T(g) [TM, CP] -> G = Bf[:, W:W+CP] and dys
    T* G = Bf + W;
    core::sync_write();              // [rgb_f | enc_d] in Bf has been stored
    for (int i = tid; i < TM * CP; i += THREADS) {
        const int r = i / CP, c = i % CP;
        const float v = (r < nv && c < C) ? g[(size_t)(p0 + r) * C + c] : 0.0f;
        G[r * ldb + c] = core::from_float<T>(v);
    }
    core::publish();
    core::store_rows(G, ldb, CP, yrow + L.y_gb, L.DYW);

    const uint32_t* hh_mask = save.slot(D);
    // d_rgb_h = mask(rgb_h) * (gb @ Wout[0:W/2]^T) -> H[:, 0:W/2]
    core::zero(acc);
    core::run_seg(R, acc, G, ldb);
    core::sync_write();                 // ins_h in H has been copied out
    core::store_grad(acc, HW, H, ldh, hh_mask);
    // d_ins_h = mask(ins_h) * (gb @ Wout[W/2:W]^T) -> H[:, W/2:W]
    core::zero(acc);
    core::run_seg(R, acc, G, ldb);
    core::store_grad(acc, HW, H + HW, ldh, hh_mask + THREADS);
    core::publish();
    core::store_rows(H, ldh, HW, yrow + L.y_rh, L.DYW);
    core::store_rows(H + HW, ldh, HW, yrow + L.y_ih, L.DYW);
    // d_ins_f = d_ins_h @ Wih^T -> Bf[:, 0:W]: its dW and bias only, never
    // the trunk
    core::zero(acc);
    core::run_seg(R, acc, H + HW, ldh);
    core::sync_write();
    core::store_grad(acc, W, Bf, ldb, nullptr);
    core::publish();
    core::store_rows(Bf, ldb, W, yrow + L.y_insf, L.DYW);
    // [d_rgb_f | g_d] = d_rgb_h @ Wrh^T; d_rgb_f -> Bf[:, 0:W]; g_d -> gd
    core::zero(acc);
    core::run_seg(R, acc, H, ldh);
    core::sync_write();
    core::store_grad(acc, W, Bf, ldb, nullptr);
    if (gd) {
        core::zero(acc);
        core::run_seg(R, acc, H, ldh);
        store_f32(acc, DP, gd + (size_t)p0 * DP, DP, false);
    }
    core::publish();
    core::store_rows(Bf, ldb, W, yrow + L.y_rgbf, L.DYW);
    // d_h = gb @ Wout[W:2W]^T (density) + d_rgb_f @ Wrgbf^T; dy_{D-1} -> H
    core::zero(acc);
    core::run_seg(R, acc, G, ldb);
    core::run_seg(R, acc, Bf, ldb);
    core::sync_write();
    core::store_grad(acc, W, H, ldh, save.slot(D - 1));
    core::publish();
    core::store_rows(H, ldh, W, yrow + L.y_dy[D - 1], L.DYW);

    // the trunk: dy_{i-1} = mask(h_{i-1}) * (dy_i @ t_i[0:W]^T), over H; at
    // the skip layer rows W:W+XP of t_i face x and give part of g_x
    const bool skipped = m.skip + 1 < D;
    for (int i = D - 1; i >= 1; --i) {
        if (i == m.skip + 1 && gx) {
            core::zero(acc);
            core::run_seg(R, acc, H, ldh);
            store_f32(acc, XP, gx + (size_t)p0 * XP, XP, false);
        }
        core::zero(acc);
        core::run_seg(R, acc, H, ldh);
        core::sync_write();
        core::store_grad(acc, W, H, ldh, save.slot(i - 1));
        core::publish();
        core::store_rows(H, ldh, W, yrow + L.y_dy[i - 1], L.DYW);
    }
    if (gx) {
        core::zero(acc);
        core::run_seg(R, acc, H, ldh);
        store_f32(acc, XP, gx + (size_t)p0 * XP, XP, skipped);
    }
    core::drain_stores();
}

// dW = act[:, a_off:a_off+K]^T @ dys[:, y_off:y_off+N] into the packed
// matrix at w_off ([K, N] row-major); the bias gradient of job j is the
// column sum of its dys columns into db at b_off (the output bias: of the
// fp32 g). tile0 is the prefix count of BM x BN tiles.
struct Jobs {
    int n;
    int a_off[MAXJ], K[MAXJ], y_off[MAXJ], N[MAXJ], w_off[MAXJ], b_off[MAXJ], tile0[MAXJ + 1];
};

Jobs make_jobs(const Meta& m, const Layout& L) {
    Jobs J;
    J.n = 0;
    J.tile0[0] = 0;
    auto add = [&](int a, int K, int y, int N, int w) {
        const int j = J.n++;
        J.a_off[j] = a; J.K[j] = K; J.y_off[j] = y; J.N[j] = N; J.w_off[j] = w;
        J.b_off[j] = y;                 // dys columns [0, NB) are the bias order
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
    add(L.a_hh, 2 * W, L.y_gb, m.CP, m.off_out);     // bias from g, at NB
    J.b_off[J.n - 1] = L.NB;
    return J;
}

// K2, dW pass: per (BM x BN tile of one job's dW, range of psplit points) an
// fp32 partial of act^T @ dys into partial_w[blockIdx.y], and for the first
// row tile of each job the bias partial into partial_b[blockIdx.y]. 8 warps
// as 2 (rows of dW) x 4 (columns), 64 x 64 each; in bf16 A = act^T is read
// from the [points, K] slabs with ldmatrix .trans, in float (which .trans
// cannot move) each lane reads its fragments' words and splits them for
// three TF32 passes, 8 points a step. The summation order is fixed, so two
// launches give the same bits.
template <class T>
__global__ void __launch_bounds__(DW_THREADS, 1)
dw_partial_kernel(const T* __restrict__ act, int ACT, const T* __restrict__ dys, int DYW,
                  const float* __restrict__ g, int P, int C, int P_pad, int psplit,
                  const Jobs J, float* __restrict__ partial_w, int n_w,
                  float* __restrict__ partial_b, int n_b) {
    extern __shared__ __align__(128) unsigned char smem[];
    constexpr int EPC = 16 / sizeof(T);         // elements per 16-byte copy
    typedef T ATile[BK][BM + DW_PAD];
    typedef T BTile[BK][BN + DW_PAD];
    ATile* As = reinterpret_cast<ATile*>(smem);
    BTile* Bs = reinterpret_cast<BTile*>(smem + DW_STAGES * sizeof(ATile));
    const int t = blockIdx.x;
    int j = 0;
    while (j + 1 < J.n && J.tile0[j + 1] <= t) ++j;
    const int K = J.K[j], N = J.N[j];
    const int tn = (N + BN - 1) / BN, local = t - J.tile0[j];
    const int m0 = (local / tn) * BM, n0 = (local % tn) * BN;
    const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
    const int wm = (warp % 2) * 64, wn = (warp / 2) * (BN / 4);
    const bool bias = m0 == 0;
    const bool bias_g = bias && j == J.n - 1;

    const int p_begin = blockIdx.y * psplit, p_end = min(P_pad, p_begin + psplit);
    const int nsteps = (p_end - p_begin) / BK;
    const T* ap = act + J.a_off[j] + m0;
    const T* yp = dys + J.y_off[j] + n0;

    auto load = [&](int s, int step) {
        const int p = p_begin + step * BK;
        for (int i = tid; i < BK * (BM / EPC); i += DW_THREADS) {
            const int r = i / (BM / EPC), c = (i % (BM / EPC)) * EPC;
            const bool va = m0 + c < K;
            core::cp_async16_zfill(&As[s][r][c], ap + (size_t)(p + r) * ACT + (va ? c : 0), va);
        }
        for (int i = tid; i < BK * (BN / EPC); i += DW_THREADS) {
            const int r = i / (BN / EPC), c = (i % (BN / EPC)) * EPC;
            const bool vb = n0 + c < N;
            core::cp_async16_zfill(&Bs[s][r][c], yp + (size_t)(p + r) * DYW + (vb ? c : 0), vb);
        }
    };

    float acc[2][2 * NJ][4];    // [mi / 2][(mi % 2) * NJ + nj]: 4 x NJ tiles of 16 x 8
    core::zero(acc);
    float bsum = 0.0f;
#pragma unroll
    for (int s = 0; s < DW_STAGES - 1; ++s) {
        if (s < nsteps) load(s, s);
        core::cp_async_commit();
    }
    for (int step = 0; step < nsteps; ++step) {
        core::cp_async_wait<DW_STAGES - 2>();
        __syncthreads();
        if (step + DW_STAGES - 1 < nsteps)
            load((step + DW_STAGES - 1) % DW_STAGES, step + DW_STAGES - 1);
        core::cp_async_commit();
        const int s = step % DW_STAGES;
        if constexpr (sizeof(T) == 2) {
#pragma unroll
            for (int kk = 0; kk < BK; kk += 16) {
                uint32_t a[4][4];
#pragma unroll
                for (int mi = 0; mi < 4; ++mi)
                    core::ldsm_x4_t(a[mi], &As[s][kk + (lane & 7) + ((lane >> 4) & 1) * 8]
                                               [wm + mi * 16 + ((lane >> 3) & 1) * 8]);
#pragma unroll
                for (int nj = 0; nj < NJ; ++nj) {
                    uint32_t b0, b1;
                    core::ldsm_x2_t(b0, b1, &Bs[s][kk + (lane & 15)][wn + nj * 8]);
#pragma unroll
                    for (int mi = 0; mi < 4; ++mi)
                        core::mma16816(acc[mi / 2][(mi % 2) * NJ + nj], a[mi], b0, b1);
                }
            }
        } else {
            // 3xTF32 on the same fragments, operands read as words: a0 (row
            // g, point t) = As[t][g], a1 row g + 8, a2 and a3 point t + 4; b0
            // (point t, column g) = Bs[t][g], b1 point t + 4
#pragma unroll
            for (int kk = 0; kk < BK; kk += 8) {
                const int p = kk + lane % 4, gi = lane / 4;
                uint32_t ah[4][4], al[4][4];
#pragma unroll
                for (int mi = 0; mi < 4; ++mi) {
                    const int m = wm + mi * 16 + gi;
                    const uint32_t a[4] = {__float_as_uint(As[s][p][m]),
                                           __float_as_uint(As[s][p][m + 8]),
                                           __float_as_uint(As[s][p + 4][m]),
                                           __float_as_uint(As[s][p + 4][m + 8])};
                    core::split_tf32(a, ah[mi], al[mi]);
                }
#pragma unroll
                for (int nj = 0; nj < NJ; ++nj) {
                    const int n = wn + nj * 8 + gi;
                    const uint32_t b[2] = {__float_as_uint(Bs[s][p][n]),
                                           __float_as_uint(Bs[s][p + 4][n])};
                    uint32_t bh[2], bl[2];
                    core::split_tf32(b, bh, bl);
#pragma unroll
                    for (int mi = 0; mi < 4; ++mi)
                        core::mma_3xtf32(acc[mi / 2][(mi % 2) * NJ + nj], ah[mi], al[mi], bh, bl);
                }
            }
        }
        // the bias sums in a fixed order, slab by slab and row by row: of
        // this dy slab, or for the output bias of the fp32 g rows it covers
        if (bias && !bias_g && tid < BN) {
#pragma unroll 8
            for (int r = 0; r < BK; ++r) bsum += core::to_float(Bs[s][r][tid]);
        } else if (bias_g && tid < C) {
            const int p = p_begin + step * BK;
            float v[BK];
#pragma unroll
            for (int r = 0; r < BK; ++r) v[r] = p + r < P ? __ldg(g + (size_t)(p + r) * C + tid) : 0.0f;
#pragma unroll
            for (int r = 0; r < BK; ++r) bsum += v[r];
        }
    }

    float* dst = partial_w + (size_t)blockIdx.y * n_w + J.w_off[j];
#pragma unroll
    for (int mi = 0; mi < 4; ++mi)
#pragma unroll
        for (int nj = 0; nj < NJ; ++nj)
#pragma unroll
            for (int h = 0; h < 2; ++h) {
                const int r = m0 + wm + mi * 16 + lane / 4 + h * 8;
                const int c = n0 + wn + nj * 8 + 2 * (lane % 4);
                if (r < K && c < N)
                    *reinterpret_cast<float2*>(dst + (size_t)r * N + c) =
                        make_float2(acc[mi / 2][(mi % 2) * NJ + nj][2 * h],
                                    acc[mi / 2][(mi % 2) * NJ + nj][2 * h + 1]);
            }
    if (bias && tid < BN && n0 + tid < (bias_g ? C : N))
        partial_b[(size_t)blockIdx.y * n_b + J.b_off[j] + n0 + tid] = bsum;
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

// dw [n_w] and db [n_b]: the partials of the n_split point ranges, summed in
// split order
int reduce_splits(const float* partial_w, int n_w, float* dw, const float* partial_b, int n_b,
                  float* db, int n_split, cudaStream_t st) {
    reduce_splits_kernel<<<std::min((n_w + 255) / 256, 4096), 256, 0, st>>>(
        partial_w, n_split, n_w, dw);
    if (cudaError_t err = cudaGetLastError(); err != cudaSuccess) return (int)err;
    reduce_splits_kernel<<<(n_b + 255) / 256, 256, 0, st>>>(partial_b, n_split, n_b, db);
    return (int)cudaGetLastError();
}

int read_meta(const int* meta, int n_meta, Meta* m) {
    if (n_meta != META_INTS) return (int)cudaErrorInvalidValue;
    memcpy(m, meta, sizeof(Meta));
    // kernels/render_field.py::check_kernel_shape holds the wrappers to these
    if (m->D < 1 || m->D > MAXD || m->W % 32 || m->W > core::MAXW || m->XP % 16
        || m->DP % 16 || m->CP % 16 || m->XP > m->W || m->DP > m->W / 2
        || m->CP > core::MAXCP)
        return (int)cudaErrorInvalidValue;
    return 0;
}

// the most dynamic shared memory a block of this device may take
int max_smem(int* bytes) {
    int dev;
    cudaError_t err = cudaGetDevice(&dev);
    if (err == cudaSuccess)
        err = cudaDeviceGetAttribute(bytes, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
    return (int)err;
}

template <class T>
int launch_forward(const float* pts, const float* vdirs, int P, int ppd, const T* w,
                   const float* b, const int* meta, int n_meta, float* raw, void* stream) {
    Meta m;
    if (int err = read_meta(meta, n_meta, &m)) return err;
    if (P < 1 || ppd < 1) return (int)cudaErrorInvalidValue;
    Planner<T> pb(K1_KS<T>);
    plan_forward(pb, m, H_ALL, true);
    const size_t smem = tile_smem<T>(m, pb.p, K1_STAGES, false);
    cudaError_t err = cudaFuncSetAttribute(field_forward_kernel<T>,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
    constexpr int TM = core::TM<T>;
    field_forward_kernel<T><<<(P + TM - 1) / TM, THREADS, smem, (cudaStream_t)stream>>>(
        pts, vdirs, P, ppd, w, b, m, pb.p, raw);
    return (int)cudaGetLastError();
}

template <class T>
int launch_backward(const float* pts, const float* vdirs, int P, int ppd, const T* w,
                    const float* b, const int* meta, int n_meta, const float* g, T* act,
                    int act_w, T* dys, int dy_w, float* gx, float* gd, float* partial_w,
                    int n_w, float* partial_b, int n_b, int psplit, float* dw, float* db,
                    void* stream) {
    Meta m;
    if (int err = read_meta(meta, n_meta, &m)) return err;
    const Layout L = make_layout(m);
    const Jobs J = make_jobs(m, L);
    if (P < 1 || ppd < 1 || psplit < BK || psplit % BK || act_w != L.ACT || dy_w != L.DYW
        || n_b != L.NB + m.CP || n_w < m.off_out + 2 * m.W * m.CP)
        return (int)cudaErrorInvalidValue;
    cudaStream_t st = (cudaStream_t)stream;
    constexpr int TM = core::TM<T>;
    const int tiles = (P + TM - 1) / TM, P_pad = tiles * TM;
    const int n_split = (P_pad + psplit - 1) / psplit;
    cudaError_t err;

    int smem_max;
    if (int e = max_smem(&smem_max)) return e;
    auto plan_smem = [&](Planner<T>& pb) {
        plan_forward(pb, m, H_ALL, false);
        plan_backward(pb, m, gx != nullptr, gd != nullptr);
        return tile_smem<T>(m, pb.p, K2_STAGES, true)
            + (size_t)mask_slots<T>(m) * THREADS * sizeof(uint32_t);
    };
    constexpr int KS = K2_KS<T>;
    Planner<T> pb(KS);
    size_t smem = plan_smem(pb);
    const bool shallow = smem > (size_t)smem_max;    // bf16 at W 256: CP > 64
    if (shallow) {
        pb = Planner<T>(KS / 2);
        smem = plan_smem(pb);
    }
    auto kernel = shallow ? field_bwd_tile_kernel<T, KS / 2> : field_bwd_tile_kernel<T, KS>;
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
    kernel<<<tiles, THREADS, smem, st>>>(pts, vdirs, P, ppd, w, b, m, L, pb.p, g, act, dys, gx,
                                         gd);
    if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;

    const int dw_smem = DW_STAGES * BK * (BM + BN + 2 * DW_PAD) * (int)sizeof(T);
    err = cudaFuncSetAttribute(dw_partial_kernel<T>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, dw_smem);
    if (err != cudaSuccess) return (int)err;
    dw_partial_kernel<T><<<dim3(J.tile0[J.n], n_split), DW_THREADS, dw_smem, st>>>(
        act, L.ACT, dys, L.DYW, g, P, m.C, P_pad, psplit, J, partial_w, n_w, partial_b, n_b);
    if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;

    return reduce_splits(partial_w, n_w, dw, partial_b, n_b, db, n_split, st);
}

// K2's bf16 build on field_bwd_wgmma.cuh's pipeline, for the shapes k2w::fits
// admits: launch_backward's arguments, scratch and outputs, and the ReLU
// masks' scratch (k2w::mask_words per thread of each tile).
int launch_backward_wgmma(const float* pts, const float* vdirs, int P, int ppd, const bf16* w,
                          const float* b, const int* meta, int n_meta, const float* g, bf16* act,
                          int act_w, bf16* dys, int dy_w, uint32_t* masks, int mask_w, float* gx,
                          float* gd, float* partial_w, int n_w, float* partial_b, int n_b,
                          int psplit, float* dw, float* db, void* stream) {
    static_assert(k2w::TM == core::TM<bf16> && k2w::GBM == BM && k2w::GBN == BN,
                  "the tiles of field_tile_rows and the jobs of make_jobs");
    Meta m;
    if (int err = read_meta(meta, n_meta, &m)) return err;
    const Layout L = make_layout(m);
    const Jobs J = make_jobs(m, L);
    if (!k2w::fits(m) || P < 1 || ppd < 1 || psplit < k2w::GBK || psplit % k2w::GBK
        || act_w != L.ACT || dy_w != L.DYW || mask_w != k2w::mask_words(m)
        || n_b != L.NB + m.CP || n_w < m.off_out + 2 * m.W * m.CP)
        return (int)cudaErrorInvalidValue;
    cudaStream_t st = (cudaStream_t)stream;
    const int tiles = (P + k2w::TM - 1) / k2w::TM, P_pad = tiles * k2w::TM;
    const int n_split = (P_pad + psplit - 1) / psplit;
    int smem_max;
    if (int e = max_smem(&smem_max)) return e;

    CUtensorMap act_map, dys_map;
    k2w::Planner pb(w);
    k2w::plan_tile(pb, m, gx != nullptr, gd != nullptr);
    const size_t fixed = k2w::fixed_smem(m);
    pb.p.stage_bytes = k2w::stage_bytes(m);
    pb.p.stages = fixed < (size_t)smem_max
        ? std::min(k2w::MAXSTAGES, (int)(((size_t)smem_max - fixed) / (pb.p.stage_bytes + 16)))
        : 0;
    if (!pb.ok || pb.p.stages < 2
        || !k2w::encode(&act_map, act, P_pad, L.ACT, 64, 64, CU_TENSOR_MAP_SWIZZLE_128B)
        || !k2w::encode(&dys_map, dys, P_pad, L.DYW, 64, 64, CU_TENSOR_MAP_SWIZZLE_128B))
        return (int)cudaErrorInvalidValue;
    const size_t smem = fixed + (size_t)pb.p.stages * (pb.p.stage_bytes + 16);
    auto tile = m.W == 256 ? k2w::field_bwd_tile_kernel<bf16, 256>
                           : k2w::field_bwd_tile_kernel<bf16, 128>;
    cudaError_t err = cudaFuncSetAttribute(tile, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                           (int)smem);
    if (err != cudaSuccess) return (int)err;
    tile<<<tiles, k2w::THREADS, smem, st>>>(pts, vdirs, P, ppd, b, m, L, pb.p, act_map, dys_map,
                                            g, act, dys, masks, gx, gd);
    if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;

    const int dw_smem = 1024 + k2w::GSTAGES * (k2w::GSTAGE + 16);
    err = cudaFuncSetAttribute(k2w::dw_partial_kernel<bf16, Jobs>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, dw_smem);
    if (err != cudaSuccess) return (int)err;
    k2w::dw_partial_kernel<bf16, Jobs><<<dim3(J.tile0[J.n], n_split), k2w::THREADS, dw_smem, st>>>(
        act_map, dys_map, g, P, m.C, P_pad, psplit, J, partial_w, n_w, partial_b, n_b);
    if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
    return reduce_splits(partial_w, n_w, dw, partial_b, n_b, db, n_split, st);
}

}  // namespace

extern "C" {

// Points per tile of K1/K2 (the wrapper pads K2's scratch rows to it): of
// the bf16 build, and of the f32 build.
int field_tile_rows() { return core::TM<bf16>; }
int field_tile_rows_f32() { return core::TM<float>; }

// Scratch widths (elements per point, either build) of field_backward: act
// and dys.
int field_scratch_widths(const int* meta, int n_meta, int* act_w, int* dy_w) {
    Meta m;
    if (int err = read_meta(meta, n_meta, &m)) return err;
    const Layout L = make_layout(m);
    *act_w = L.ACT;
    *dy_w = L.DYW;
    return 0;
}

// K1: raw [P, C] <- pts [P, 3], vdirs [ceil(P / ppd), 3] (fp32), bf16 weights.
int field_forward(const float* pts, const float* vdirs, int P, int ppd, const bf16* w,
                  const float* b, const int* meta, int n_meta, float* raw, void* stream) {
    return launch_forward<bf16>(pts, vdirs, P, ppd, w, b, meta, n_meta, raw, stream);
}

// K1's f32 build: the same with fp32 weights.
int field_forward_f32(const float* pts, const float* vdirs, int P, int ppd, const float* w,
                      const float* b, const int* meta, int n_meta, float* raw, void* stream) {
    return launch_forward<float>(pts, vdirs, P, ppd, w, b, meta, n_meta, raw, stream);
}

// K2: dw [n_w], db [n_b] (the packed layouts, fp32) and, when gx / gd are
// non-null, the encoding cotangents gx [P_pad, XP], gd [P_pad, DP] (fp32)
// <- pts, vdirs as for K1, g [P, C] fp32, bf16 weights. Scratch: act
// [P_pad, act_w] and dys [P_pad, dy_w] bf16, partial_w [ceil(P_pad /
// psplit), n_w] and partial_b [ceil(P_pad / psplit), n_b] fp32 zero-filled,
// with P_pad = P rounded up to field_tile_rows() and psplit a multiple of 32.
int field_backward(const float* pts, const float* vdirs, int P, int ppd, const bf16* w,
                   const float* b, const int* meta, int n_meta, const float* g,
                   bf16* act, int act_w, bf16* dys, int dy_w, float* gx, float* gd,
                   float* partial_w, int n_w, float* partial_b, int n_b, int psplit,
                   float* dw, float* db, void* stream) {
    return launch_backward<bf16>(pts, vdirs, P, ppd, w, b, meta, n_meta, g, act, act_w, dys,
                                 dy_w, gx, gd, partial_w, n_w, partial_b, n_b, psplit, dw, db,
                                 stream);
}

// Words of K2's ReLU mask scratch per thread of a tile, for
// field_backward_wgmma (256 threads a tile): the shapes it takes, else 0.
int field_mask_words(const int* meta, int n_meta) {
    Meta m;
    if (read_meta(meta, n_meta, &m) || !k2w::fits(m)) return 0;
    return k2w::mask_words(m);
}

// K2 on field_bwd_wgmma.cuh's pipeline, for the shapes kernels/field.py::
// k2_core gives it: the arguments of field_backward, and the ReLU masks'
// scratch masks [P_pad / 128, mask_w, 256] (int32, mask_w from
// field_mask_words).
int field_backward_wgmma(const float* pts, const float* vdirs, int P, int ppd, const bf16* w,
                         const float* b, const int* meta, int n_meta, const float* g,
                         bf16* act, int act_w, bf16* dys, int dy_w, uint32_t* masks, int mask_w,
                         float* gx, float* gd, float* partial_w, int n_w, float* partial_b,
                         int n_b, int psplit, float* dw, float* db, void* stream) {
    return launch_backward_wgmma(pts, vdirs, P, ppd, w, b, meta, n_meta, g, act, act_w, dys,
                                 dy_w, masks, mask_w, gx, gd, partial_w, n_w, partial_b, n_b,
                                 psplit, dw, db, stream);
}

// K2's f32 build: the same with fp32 weights and fp32 act / dys, P_pad = P
// rounded up to field_tile_rows_f32().
int field_backward_f32(const float* pts, const float* vdirs, int P, int ppd, const float* w,
                       const float* b, const int* meta, int n_meta, const float* g,
                       float* act, int act_w, float* dys, int dy_w, float* gx, float* gd,
                       float* partial_w, int n_w, float* partial_b, int n_b, int psplit,
                       float* dw, float* db, void* stream) {
    return launch_backward<float>(pts, vdirs, P, ppd, w, b, meta, n_meta, g, act, act_w, dys,
                                  dy_w, gx, gd, partial_w, n_w, partial_b, n_b, psplit, dw, db,
                                  stream);
}

const char* field_error_string(int err) {
    return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
