// Device code of the field kernels: the packed-weight layout and the in-kernel
// positional encoding (render_field.cu's K3/K4/K5 and, through
// field_core.cuh, field.cu's K1/K2), and the bf16 wmma matmul core with its
// epilogues and the forward of one tile through the trunk and the heads
// (tile_forward) that K3/K4/K5 run.
//
// Matmuls are nvcuda::wmma bf16 16x16x16 fragments with fp32 accumulation
// over 64-point tiles whose activations live in shared memory (rows padded by
// PAD so fragment loads do not conflict on banks); weights stream from L2
// straight into fragments. Every width is padded with zero rows to a multiple
// of 16 by the packer (kernels/render_field.py::pack_field).

#pragma once

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <mma.h>

using namespace nvcuda;
typedef __nv_bfloat16 bf16;

namespace {

constexpr int TP = 64;                 // points per sub-tile (rows of every matmul)
constexpr int RT = TP / 16;            // row tiles per sub-tile
constexpr int NWARPS = 8;
constexpr int NTHREADS = NWARPS * 32;
constexpr int MAXD = 16;               // deepest trunk the meta block describes
// Shared-memory rows are padded by 8 bf16 (16 bytes): with a row stride of
// 16 mod 128 bytes the 8 rows that one fragment load reads fall in distinct
// banks. Unpadded (a stride of 512 bytes) they all hit the same banks.
constexpr int PAD = 8;

typedef wmma::fragment<wmma::accumulator, 16, 16, 16, float> Acc;

// Layout of the packed weights; filled from the int32 meta array that
// kernels/render_field.py::pack_field writes, in this field order.
struct Meta {
    int D, W, skip, XP, DP, CP, C, F, FV;
    int off_t[MAXD];                            // trunk matrices, bf16 elements
    int off_rgbf, off_rh, off_insf, off_ih, off_out;
    int boff_t, boff_rgbf, boff_rh, boff_insf, boff_ih, boff_o;  // fp32 biases
};
constexpr int META_INTS = sizeof(Meta) / sizeof(int);

// Channel j of the reference positional encoding of p[0:3] with F octaves:
// [p, sin(p), cos(p), sin(2p), cos(2p), ...], 3 channels per block.
__device__ __forceinline__ float pe_channel(const float* p, int j) {
    if (j < 3) return p[j];
    const int idx = j - 3;
    const int f = idx / 6, rem = idx % 6, d = rem % 3;
    const float xb = ldexpf(p[d], f);           // exact: x * 2^f
    return rem < 3 ? sinf(xb) : cosf(xb);
}

// acc[RT] += A [TP, K] (ld lda, shared) @ Wm [K, N] (row-major, global) for
// column tile ct.
__device__ __forceinline__ void mma_segment(Acc (&acc)[RT], const bf16* A, int lda, int K,
                                            const bf16* Wm, int N, int ct) {
    for (int k = 0; k < K; k += 16) {
        wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> bfr;
        wmma::load_matrix_sync(bfr, Wm + (size_t)k * N + ct * 16, N);
#pragma unroll
        for (int r = 0; r < RT; ++r) {
            wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> afr;
            wmma::load_matrix_sync(afr, A + r * 16 * lda + k, lda);
            wmma::mma_sync(acc[r], afr, bfr, acc[r]);
        }
    }
}

// out[TP, N] = [A1 | A2] @ Wm, A1 [TP, K1] (ld lda1) and A2 [TP, K2] (ld lda2)
// in shared memory, Wm [K1+K2, N] row-major bf16 in global memory (L2).
// Column tiles are dealt to warps; each warp keeps the RT row tiles of its
// column tile in registers so one weight fragment feeds RT products.
template <class Epilogue>
__device__ __forceinline__ void matmul(const bf16* A1, int lda1, int K1,
                                       const bf16* A2, int lda2, int K2,
                                       const bf16* Wm, int N, Epilogue epi) {
    const int warp = threadIdx.x / 32;
    for (int ct = warp; ct < N / 16; ct += NWARPS) {
        Acc acc[RT];
#pragma unroll
        for (int r = 0; r < RT; ++r) wmma::fill_fragment(acc[r], 0.0f);
        mma_segment(acc, A1, lda1, K1, Wm, N, ct);
        mma_segment(acc, A2, lda2, K2, Wm + (size_t)K1 * N, N, ct);
        epi(acc, ct);
    }
}

// Epilogue: + bias (fp32), optional ReLU, round to bf16, store [TP, N] at dst.
struct StoreBf16 {
    const float* bias; bf16* dst; int ldd; bool relu; float* scratch;
    __device__ __forceinline__ void operator()(Acc (&acc)[RT], int ct) const {
        const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
        float* sc = scratch + warp * 256;
        for (int r = 0; r < RT; ++r) {
            wmma::store_matrix_sync(sc, acc[r], 16, wmma::mem_row_major);
            __syncwarp();
            for (int e = lane; e < 256; e += 32) {
                const int rr = e / 16, cc = e % 16;
                float v = sc[e] + bias[ct * 16 + cc];
                if (relu) v = fmaxf(v, 0.0f);
                dst[(r * 16 + rr) * ldd + ct * 16 + cc] = __float2bfloat16_rn(v);
            }
            __syncwarp();
        }
    }
};

// Epilogue: store the fp32 products [TP, N] at dst (bias added by the reader).
struct StoreF32 {
    float* dst; int ldd;
    __device__ __forceinline__ void operator()(Acc (&acc)[RT], int ct) const {
        for (int r = 0; r < RT; ++r)
            wmma::store_matrix_sync(dst + r * 16 * ldd + ct * 16, acc[r], ldd,
                                    wmma::mem_row_major);
    }
};

// Which heads tile_forward runs after the trunk: none (K4: sigma only), all
// (K3) or the instance branch alone (K5: no view encoding, no rgb branch).
enum Heads { H_NONE, H_ALL, H_INS };

// The field forward of one tile of TP rows, nv of them points (_fwd_body up
// to the output layer): row r is the point p_tile[3r:3r+3] and looks along
// vdirs[3 * ((row0 + r) / ppd)] (read with H_ALL only). bufA, bufB and bufC
// are [TP, W+PAD] bf16; xenc (ld ldx) takes the position encoding and may be
// bufC, which nothing else uses until the trunk (whose last reader of xenc is
// layer skip+1) is done. Returns the buffer holding the trunk output h; the
// other of bufA/bufB is free. With H_ALL, bufC[:, 0:W] then holds the hidden
// pair [rgb_h | ins_h] (the view encoding passes through
// bufC[:, W/2:W/2+DP]); with H_INS, bufC[:, W/2:W] holds ins_h and
// bufC[:, 0:W/2] is not written.
template <Heads HEADS>
__device__ __forceinline__ bf16* tile_forward(const float* p_tile, int nv, const float* vdirs,
                                              int row0, int ppd, const bf16* w, const float* b,
                                              const Meta& m, bf16* bufA, bf16* bufB,
                                              bf16* bufC, bf16* xenc, int ldx, float* scratch) {
    const int W = m.W, XP = m.XP, DP = m.DP, HW = m.W / 2, LDA = m.W + PAD;
    const int pos_ch = 3 * (1 + 2 * m.F), view_ch = 3 * (1 + 2 * m.FV);
    const int tid = threadIdx.x;

    for (int i = tid; i < TP * XP; i += NTHREADS) {
        const int r = i / XP, j = i % XP;
        const float v = (r < nv && j < pos_ch) ? pe_channel(p_tile + r * 3, j) : 0.0f;
        xenc[r * ldx + j] = __float2bfloat16_rn(v);
    }
    __syncthreads();

    // trunk: layer 0 reads the encoding, layer skip+1 reads [h, x]
    bf16* h = bufA;
    bf16* spare = bufB;
    matmul(xenc, ldx, XP, nullptr, 0, 0, w + m.off_t[0], W,
           StoreBf16{b + m.boff_t, h, LDA, true, scratch});
    __syncthreads();
    for (int i = 1; i < m.D; ++i) {
        const bool sk = (i == m.skip + 1);
        matmul(h, LDA, W, sk ? xenc : nullptr, ldx, sk ? XP : 0, w + m.off_t[i], W,
               StoreBf16{b + m.boff_t + i * W, spare, LDA, true, scratch});
        __syncthreads();
        bf16* t = h; h = spare; spare = t;
    }
    if (HEADS == H_NONE) return h;

    if (HEADS == H_ALL) {
        // view encoding per row, in bufC's right half until rgb_h has read it
        for (int i = tid; i < TP * DP; i += NTHREADS) {
            const int r = i / DP, j = i % DP;
            const float v = (r < nv && j < view_ch)
                ? pe_channel(vdirs + (size_t)((row0 + r) / ppd) * 3, j) : 0.0f;
            bufC[r * LDA + HW + j] = __float2bfloat16_rn(v);
        }
        // rgb_f = h @ Wrgbf + b (bf16, no activation) -> spare
        matmul(h, LDA, W, nullptr, 0, 0, w + m.off_rgbf, W,
               StoreBf16{b + m.boff_rgbf, spare, LDA, false, scratch});
        __syncthreads();
        // rgb_h = relu([rgb_f, enc_d] @ Wrh + b) -> bufC[:, 0:W/2]
        matmul(spare, LDA, W, bufC + HW, LDA, DP, w + m.off_rh, HW,
               StoreBf16{b + m.boff_rh, bufC, LDA, true, scratch});
        __syncthreads();
    }
    // ins_f = h @ Winsf + b -> spare
    matmul(h, LDA, W, nullptr, 0, 0, w + m.off_insf, W,
           StoreBf16{b + m.boff_insf, spare, LDA, false, scratch});
    __syncthreads();
    // ins_h = relu(ins_f @ Wih + b) -> bufC[:, W/2:W]
    matmul(spare, LDA, W, nullptr, 0, 0, w + m.off_ih, HW,
           StoreBf16{b + m.boff_ih, bufC + HW, LDA, true, scratch});
    __syncthreads();
    return h;
}

}  // namespace
