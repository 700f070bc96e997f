// Device code of the field kernels: the packed-weight layout (Meta) and the
// in-kernel positional encoding that every kernel uses, and the first bf16
// wmma matmul core with its epilogues and the forward of one tile through the
// trunk (tile_forward), which only render_field.cu's K4 still runs; K1, K2,
// K3 and K5 run field_core.cuh's core through field_tile.cuh.
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

// acc[RT] += A [TP, K] (ld lda, shared) @ Wm [K, ldw] (row-major, global) for
// column tile ct.
__device__ __forceinline__ void mma_segment(Acc (&acc)[RT], const bf16* A, int lda, int K,
                                            const bf16* Wm, int ldw, int ct) {
    for (int k = 0; k < K; k += 16) {
        wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> bfr;
        wmma::load_matrix_sync(bfr, Wm + (size_t)k * ldw + ct * 16, ldw);
#pragma unroll
        for (int r = 0; r < RT; ++r) {
            wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> afr;
            wmma::load_matrix_sync(afr, A + r * 16 * lda + k, lda);
            wmma::mma_sync(acc[r], afr, bfr, acc[r]);
        }
    }
}

// out[TP, N] = [A1 | A2] @ Wm[:, 0:N], A1 [TP, K1] (ld lda1) and A2 [TP, K2]
// (ld lda2) in shared memory, Wm [K1+K2, ldw] row-major bf16 in global memory
// (L2). Column tiles are dealt to warps; each warp keeps the RT row tiles of
// its column tile in registers so one weight fragment feeds RT products.
template <class Epilogue>
__device__ __forceinline__ void matmul(const bf16* A1, int lda1, int K1,
                                       const bf16* A2, int lda2, int K2,
                                       const bf16* Wm, int ldw, int N, Epilogue epi) {
    const int warp = threadIdx.x / 32;
    for (int ct = warp; ct < N / 16; ct += NWARPS) {
        Acc acc[RT];
#pragma unroll
        for (int r = 0; r < RT; ++r) wmma::fill_fragment(acc[r], 0.0f);
        mma_segment(acc, A1, lda1, K1, Wm, ldw, ct);
        mma_segment(acc, A2, lda2, K2, Wm + (size_t)K1 * ldw, ldw, ct);
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

// The trunk of one tile of TP rows, nv of them points (_density_body up to
// the density head): row r is the point p_tile[3r:3r+3]. bufA and bufB are
// [TP, W+PAD] bf16, xenc [TP, ldx] takes the position encoding. Returns the
// buffer holding the trunk output h; the other of bufA/bufB is free.
__device__ __forceinline__ bf16* tile_forward(const float* p_tile, int nv, const bf16* w,
                                              const float* b, const Meta& m, bf16* bufA,
                                              bf16* bufB, bf16* xenc, int ldx, float* scratch) {
    const int W = m.W, XP = m.XP, LDA = m.W + PAD;
    const int pos_ch = 3 * (1 + 2 * m.F);
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
    matmul(xenc, ldx, XP, nullptr, 0, 0, w + m.off_t[0], W, W,
           StoreBf16{b + m.boff_t, h, LDA, true, scratch});
    __syncthreads();
    for (int i = 1; i < m.D; ++i) {
        const bool sk = (i == m.skip + 1);
        matmul(h, LDA, W, sk ? xenc : nullptr, ldx, sk ? XP : 0, w + m.off_t[i], W, W,
               StoreBf16{b + m.boff_t + i * W, spare, LDA, true, scratch});
        __syncthreads();
        bf16* t = h; h = spare; spare = t;
    }
    return h;
}

}  // namespace
