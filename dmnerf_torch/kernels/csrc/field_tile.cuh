// The field forward of one tile on the field_core.cuh core, shared by K1 and
// K2's recompute (field.cu) and by K3, K4 and K5 (render_field.cu), so that
// they run the very same function: the weight plan of a tile, the
// shared-memory buffers it works in, and forward_tile. Each is a template of
// the element type T: bf16 (128-point tiles on the tensor cores) or float
// (64-point tiles in three TF32 passes, the f32 builds).
//
// - Heads: H_ALL runs the whole field (K1, K2, K3); H_INS the trunk, the
//   density rows and the instance branch alone (K5: no view encoding, no rgb
//   branch, ~15% fewer multiply-adds per point); H_SIGMA the trunk and the
//   density rows alone (K4).
// - The output layer (OUT) lands in a register tile of core::NTO 8-column
//   tiles per warp, for CP up to core::MAXCP = 128 (K <= 123) at any W. The
//   density rows face column 3 alone (pack_field), so only the first
//   8-column tile of them is computed, into a one-tile accumulator that is
//   live while the instance branch runs; the output tile starts from it
//   after the instance branch, when the trunk's accumulators are dead. The
//   rgb and instance rows then add to it in the order of the first port's core
//   (density, rgb, instance), and the columns left out add exact zeros, so
//   the raw is the same to the last bit whichever heads.
// - A tile's buffers: H [TM, W+SPAD] (the trunk, then ins_f/ins_h), Bf
//   [TM, W+E+SPAD] (the encodings, rgb_f/rgb_h and, in K2, the cotangent g:
//   E = max(DP, CP) there, DP elsewhere), the weight ring, then K2's mask
//   words or K3-K5's composite state. K3-K5 stage each tile's fp32 raw over
//   H and Bf, so those two span at least hb_min bytes.

#pragma once

#include <algorithm>

#include "field_core.cuh"

namespace {

using core::Plan;
using core::Seg;
using core::THREADS;

// Which heads forward_tile runs after the trunk.
enum Heads { H_ALL, H_INS, H_SIGMA };

// Column layout of K2's scratch arrays (elements per point row).
struct Layout {
    int ACT, DYW;
    int a_x, a_hs[MAXD], a_hh, a_rgbf, a_encd, a_insf;    // act columns
    int y_dy[MAXD], y_rgbf, y_rh, y_insf, y_ih, y_gb;      // dys columns
    int NB;             // dys columns [0, NB) are the packed biases' order
};

// ---- the weight plans (the order the kernels consume segments in) ------------

template <class T>
struct Planner {
    Plan p;
    int ksl;              // the ring's slab depth
    explicit Planner(int ks) : ksl(ks) { p.n = 0; p.stage_elems = 0; }
    void add(int w_off, int ldw, int r0, int rows, int trans) {
        const Seg s{w_off, ldw, r0, rows, trans};
        p.s[p.n++] = s;
        p.stage_elems = std::max(p.stage_elems, core::slab_elems<T>(s, ksl));
    }
};

// forward_tile's segments; with_out: the output layer too (K1, K3-K5)
template <class T>
void plan_forward(Planner<T>& B, const Meta& m, Heads heads, bool with_out) {
    const int W = m.W, HW = m.W / 2;
    B.add(m.off_t[0], W, 0, m.XP, 0);
    for (int i = 1; i < m.D; ++i) {
        B.add(m.off_t[i], W, 0, W, 0);
        if (i == m.skip + 1) B.add(m.off_t[i], W, W, m.XP, 0);
    }
    if (heads == H_ALL) {
        B.add(m.off_rgbf, W, 0, W, 0);
        B.add(m.off_rh, HW, 0, W + m.DP, 0);
    }
    if (with_out) B.add(m.off_out, m.CP, W, W, 0);             // density rows, from h
    if (heads == H_SIGMA) return;
    B.add(m.off_insf, W, 0, W, 0);
    B.add(m.off_ih, HW, 0, W, 0);
    if (with_out) {
        if (heads == H_ALL) B.add(m.off_out, m.CP, 0, HW, 0);  // rgb_out rows
        B.add(m.off_out, m.CP, HW, HW, 0);                     // ins_out rows
    }
}

// ---- the tile's buffers ------------------------------------------------------------

template <class T>
struct Bufs {
    T* H; int ldh;
    T* Bf; int ldb;
    T* ring;
    unsigned char* tail;  // after the ring: K2's mask words, K3-K5's composite state
};

template <class T>
__host__ __device__ inline int ld_h(const Meta& m) { return m.W + core::SPAD<T>; }
// with_g: Bf also holds K2's cotangent g [TM, CP] beside the view encoding's place
template <class T>
__host__ __device__ inline int ld_b(const Meta& m, bool with_g) {
    return m.W + (with_g && m.CP > m.DP ? m.CP : m.DP) + core::SPAD<T>;
}

// bytes of H and Bf together: at least hb_min (a multiple of 16)
template <class T>
__host__ __device__ inline size_t hb_bytes(const Meta& m, bool with_g, size_t hb_min) {
    const size_t hb = (size_t)core::TM<T> * (ld_h<T>(m) + ld_b<T>(m, with_g)) * sizeof(T);
    return hb > hb_min ? hb : hb_min;
}

// bytes of H, Bf and the ring (tail bytes on top)
template <class T>
size_t tile_smem(const Meta& m, const Plan& p, int stages, bool with_g, size_t hb_min = 0) {
    return hb_bytes<T>(m, with_g, hb_min) + (size_t)stages * p.stage_elems * sizeof(T);
}

template <class T>
__device__ __forceinline__ Bufs<T> carve(unsigned char* smem, const Meta& m, const Plan& p,
                                         int stages, bool with_g, size_t hb_min = 0) {
    Bufs<T> B;
    B.ldh = ld_h<T>(m);
    B.ldb = ld_b<T>(m, with_g);
    B.H = reinterpret_cast<T*>(smem);
    B.Bf = B.H + core::TM<T> * B.ldh;
    B.ring = reinterpret_cast<T*>(smem + hb_bytes<T>(m, with_g, hb_min));
    B.tail = reinterpret_cast<unsigned char*>(B.ring + stages * p.stage_elems);
    return B;
}

// K2's ReLU mask words per thread: MW for each trunk layer, then one word
// each for rgb_h and ins_h (W <= 256)
template <class T>
__host__ __device__ inline int mask_slots(const Meta& m) { return m.D * core::MW<T> + 2; }

// The scratch rows of a tile and its ReLU mask words (K2), or nothing.
template <class T>
struct Save {
    T* act;               // this tile's first row of act, or null
    const Layout* L;
    uint32_t* masks;      // mask_slots words per thread
    __device__ __forceinline__ void put(const T* src, int lds, int ncols, int col) const {
        if (act) {
            core::publish();
            core::store_rows(src, lds, ncols, act + col, L->ACT);
        }
    }
    // trunk layer s < D, or s = D: rgb_h's word (ins_h's is THREADS on)
    __device__ __forceinline__ uint32_t* slot(int s) const {
        return masks ? masks + s * core::MW<T> * THREADS : nullptr;
    }
};

// ---- the tile's forward ---------------------------------------------------------

// The forward of one tile of TM rows, nv of them points p_tile[3r:3r+3],
// row r looking along vdirs[3 * ((row0 + r) / ppd)] (read with H_ALL only).
// Ends with ins_h in H[:, 0:W/2] (not H_SIGMA) and (H_ALL) rgb_h in
// Bf[:, 0:W/2]. With OUT acc_out holds the output layer (without its bias)
// on return: columns 0:C with H_ALL, 3:C with H_INS (0:3 are zero), 0:8 with
// H_SIGMA (column 3 the density, the others nothing the caller reads). With
// SAVE (K2) every activation goes to the scratch rows and every ReLU mask to
// save.masks (slot i for trunk layer i; slot D word 0 rgb_h and word 1
// ins_h), and the float build's products sum in order of k (run_seg's
// KORDER), so that the masks are the plain fp32 path's.
template <Heads HEADS, bool OUT, bool SAVE, class T, int M, int NO, class RingT>
__device__ __forceinline__ void forward_tile(RingT& R, const Bufs<T>& B,
                                             float (&acc)[M][core::NT][4],
                                             float (&acc_out)[M][NO][4], const float* p_tile,
                                             int nv, const float* vdirs, int row0, int ppd,
                                             const float* __restrict__ b, const Meta& m,
                                             const Save<T>& save) {
    constexpr int TM = core::TM<T>;
    const int W = m.W, XP = m.XP, DP = m.DP, HW = W / 2;
    const int pos_ch = 3 * (1 + 2 * m.F), view_ch = 3 * (1 + 2 * m.FV);
    const int tid = threadIdx.x;
    T* H = B.H;
    T* Bf = B.Bf;
    const int ldh = B.ldh, ldb = B.ldb;
    const Layout* L = save.L;

    // the position encoding -> Bf[:, 0:XP]
    for (int i = tid; i < TM * XP; i += THREADS) {
        const int r = i / XP, j = i % XP;
        const float v = (r < nv && j < pos_ch) ? pe_channel(p_tile + r * 3, j) : 0.0f;
        Bf[r * ldb + j] = core::from_float<T>(v);
    }
    if (SAVE) save.put(Bf, ldb, XP, L->a_x);

    // trunk: layer 0 reads the encoding, layer skip+1 reads [h, x]; every
    // layer writes over its input in H
    core::zero(acc);
    core::run_seg<SAVE>(R, acc, Bf, ldb);
    core::sync_write();
    core::store_act(acc, W, b + m.boff_t, true, H, ldh, SAVE ? save.slot(0) : nullptr);
    if (SAVE) save.put(H, ldh, W, L->a_hs[0]);
    for (int i = 1; i < m.D; ++i) {
        core::zero(acc);
        core::run_seg<SAVE>(R, acc, H, ldh);
        if (i == m.skip + 1) core::run_seg<SAVE>(R, acc, Bf, ldb);
        core::sync_write();
        core::store_act(acc, W, b + m.boff_t + i * W, true, H, ldh,
                        SAVE ? save.slot(i) : nullptr);
        if (SAVE) save.put(H, ldh, W, L->a_hs[i]);
    }

    if (HEADS == H_ALL) {
        // the view encoding -> Bf[:, W:W+DP], beside rgb_f
        for (int i = tid; i < TM * DP; i += THREADS) {
            const int r = i / DP, j = i % DP;
            const float v = (r < nv && j < view_ch)
                ? pe_channel(vdirs + (size_t)((row0 + r) / ppd) * 3, j) : 0.0f;
            Bf[r * ldb + W + j] = core::from_float<T>(v);
        }
        // rgb_f = h @ Wrgbf + b (no activation) -> Bf[:, 0:W]
        core::zero(acc);
        core::run_seg<SAVE>(R, acc, H, ldh);
        core::sync_write();
        core::store_act(acc, W, b + m.boff_rgbf, false, Bf, ldb, nullptr);
        if (SAVE) save.put(Bf, ldb, W + DP, L->a_rgbf);            // [rgb_f | enc_d]
        // rgb_h = relu([rgb_f, enc_d] @ Wrh + b) -> Bf[:, 0:W/2]
        core::zero(acc);
        core::run_seg<SAVE>(R, acc, Bf, ldb);
        core::sync_write();
        core::store_act(acc, HW, b + m.boff_rh, true, Bf, ldb, SAVE ? save.slot(m.D) : nullptr);
        if (SAVE) save.put(Bf, ldb, HW, L->a_hh);
    }
    float sig[M][1][4];
    if (OUT) {   // the density rows of the output layer, while h is in H
        core::zero(sig);
        core::run_seg<SAVE>(R, sig, H, ldh, 8);
    }
    if (HEADS != H_SIGMA) {
        // ins_f = h @ Winsf + b -> H
        core::zero(acc);
        core::run_seg<SAVE>(R, acc, H, ldh);
        core::sync_write();
        core::store_act(acc, W, b + m.boff_insf, false, H, ldh, nullptr);
        if (SAVE) save.put(H, ldh, W, L->a_insf);
        // ins_h = relu(ins_f @ Wih + b) -> H[:, 0:W/2]
        core::zero(acc);
        core::run_seg<SAVE>(R, acc, H, ldh);
        core::sync_write();
        core::store_act(acc, HW, b + m.boff_ih, true, H, ldh,
                        SAVE ? save.slot(m.D) + THREADS : nullptr);
        if (SAVE) save.put(H, ldh, HW, L->a_hh + HW);
    }
    if (OUT) {   // [density | 0] + [rgb_h | ins_h] @ Wout[0:W] (H_INS: ins_h @ Wout[W/2:W])
#pragma unroll
        for (int mi = 0; mi < M; ++mi)
#pragma unroll
            for (int c = 0; c < 4; ++c) {
                acc_out[mi][0][c] = sig[mi][0][c];
#pragma unroll
                for (int j = 1; j < NO; ++j) acc_out[mi][j][c] = 0.0f;
            }
        if (HEADS == H_ALL) core::run_seg<SAVE>(R, acc_out, Bf, ldb);
        if (HEADS != H_SIGMA) core::run_seg<SAVE>(R, acc_out, H, ldh);
    }
}

}  // namespace
