// Fused DM-NeRF field + alpha composite for the eval render and edit paths,
// sm_90a.
//
// Replaces the TPU kernel dmnerf_tpu/ops/pallas/render_field.py::_composite_kernel
// with heads="sigma" (K4, the coarse pass: importance weights only),
// heads="all" (K3, the fine pass: rgb, depth and instance logits per ray) and
// heads="ins" (K5, the edit path's accumulated-label passes: instance logits
// per ray from the trunk, sigma and the instance branch, with no view
// encoding and no rgb branch; ~15% fewer MACs per point than K3).
// The math is the JAX package's: the field of models/fields.apply_field in
// bf16 with fp32 accumulation, then core/rendering.composite.
//
// What bounds it on the H100: the work is a chain of small matmuls through a
// 9-layer MLP (about 1.4 MFLOP per point for the 8x256 field), followed by a
// scan along each ray. The weights of one field (698,789 bf16 values) do not
// fit in a block's shared memory, so the Pallas design of keeping every
// weight on chip does not carry over.
//
// What the design does about that:
// - One block renders one ray. It walks the ray's samples in sub-tiles of 64
//   points; each sub-tile's activations stay in shared memory as bf16: two
//   ping-pong buffers and a third that holds the position encoding (the skip
//   layer's second input) during the trunk and the rgb/ins hidden pair after
//   it, so two blocks fit on an SM. Rows are padded by 16 bytes so fragment
//   loads do not conflict on banks. Each layer's weights are read from L2 for
//   every sub-tile, straight into tensor-core fragments: the weights of both
//   fields fit in L2 many times over, so after the first blocks the matmuls
//   read no device memory. Staging weights through shared memory, wider
//   sub-tiles (more reuse of each weight fragment), wgmma, TMA and a
//   persistent schedule are later work.
// - Matmuls are nvcuda::wmma bf16 16x16x16 fragments with fp32 accumulation.
//   Every width is padded with zero rows to a multiple of 16 by the packer
//   (kernels/render_field.py::pack_field). Bias, ReLU and the bf16 rounding
//   run in an epilogue that goes through a 16x16 fp32 scratch tile per warp,
//   and round exactly where the JAX package stores bf16: after each trunk
//   ReLU, after the rgb/ins feature layers and after the hidden layers.
// - Positional encoding is computed in the kernel from the fp32 points, in the
//   reference channel order, with precise sinf/cosf (arguments reach x*2^9,
//   so fast-math intrinsics would be wrong); the packer needs no permutation.
// - Compositing is a scan, not the TPU's log-space triangular matmul: each
//   output channel's thread walks the samples in order carrying the
//   transmittance T_{i+1} = T_i * ((1 - alpha_i) + 1e-10) and its sum across
//   sub-tiles (the literal exclusive cumprod of core/rendering.composite).
// - Outputs carry no lane padding: weights [R,S] (sigma), rgb [R,3], depth
//   [R] and instance logits [R,K+1] (all), or instance logits [R,K+1] (ins).
//
// The device code of the tile (Meta, pe_channel, the wmma matmul and its
// epilogues, and tile_forward: a tile through the trunk and the heads) lives
// in field_common.cuh, whose Meta and pe_channel field.cu (K1/K2) uses too.
// Plain C interface for ctypes; each entry returns cudaGetLastError() after
// its launch so a refused launch is reported to the wrapper.

#include <cstring>

#include "field_common.cuh"

namespace {

// ALL and INS: three activation buffers (the encoding lives in the third
// during the trunk, the hidden pair or ins_h after it); sigma: two, plus the
// encoding. All: one fp32 16x16 tile per warp.
size_t smem_bytes(const Meta& m, bool heads) {
    const size_t act = (size_t)TP * (m.W + PAD) * sizeof(bf16);
    const size_t enc = heads ? 0 : (size_t)TP * (m.XP + PAD) * sizeof(bf16);
    return (heads ? 3 : 2) * act + enc + NWARPS * 256 * sizeof(float);
}

// One block = one ray. H_NONE: weights [R,S] (K4). H_ALL: rgb [R,3],
// depth [R], instance logits [R,K+1] (K3). H_INS: instance logits [R,K+1] (K5).
template <Heads HEADS>
__global__ void __launch_bounds__(NTHREADS, 2)
render_field_kernel(const float* __restrict__ pts, const float* __restrict__ vdirs,
                    const float* __restrict__ zv, const float* __restrict__ dists,
                    int S, const bf16* __restrict__ w, const float* __restrict__ b,
                    const Meta m, float* __restrict__ out_w, float* __restrict__ out_rgb,
                    float* __restrict__ out_depth, float* __restrict__ out_ins) {
    extern __shared__ __align__(128) unsigned char smem[];
    constexpr bool ALL = HEADS == H_ALL, INS = HEADS == H_INS;
    const int W = m.W, XP = m.XP, CP = m.CP, C = m.C, HW = m.W / 2;
    const int LDA = W + PAD;                                  // activation row stride
    const int LDX = HEADS != H_NONE ? LDA : XP + PAD;         // encoding row stride
    bf16* bufA = reinterpret_cast<bf16*>(smem);
    bf16* bufB = bufA + TP * LDA;
    bf16* bufC = bufB + TP * LDA;          // ALL/INS: hidden pair after the trunk
    // the position encoding: in ALL/INS, columns [0, XP) of bufC, which
    // nothing else uses until the trunk (its last reader is layer skip+1) is done
    bf16* xenc = bufC;
    float* scratch = reinterpret_cast<float*>(bufC + TP * LDX);
    float* alpha = scratch;                           // reused after the MLP
    float* zt = scratch + TP;
    const float* bo = b + m.boff_o;

    const int ray = blockIdx.x;
    const int tid = threadIdx.x;
    float T = 1.0f;      // transmittance, carried across sub-tiles
    float acc = 0.0f;    // this thread's output channel (ALL/INS), carried likewise

    for (int s0 = 0; s0 < S; s0 += TP) {
        const int nv = min(TP, S - s0);
        const float* p_tile = pts + ((size_t)ray * S + s0) * 3;

        // the trunk and, in ALL/INS, the heads; every row looks along the ray
        bf16* h = tile_forward<HEADS>(p_tile, nv, ALL ? vdirs + (size_t)ray * 3 : nullptr, 0,
                                      TP, w, b, m, bufA, bufB, bufC, xenc, LDX, scratch);
        // [TP, CP] fp32 raw in the activation buffer that h is not in
        float* stage = reinterpret_cast<float*>(h == bufA ? bufB : bufA);

        if (ALL) {
            // raw = [rgb_h, ins_h, h] @ Wout: rgb 0:3, sigma 3, ins 4:C
            matmul(bufC, LDA, W, h, LDA, W, w + m.off_out, CP, StoreF32{stage, CP});
        } else if (INS) {
            // [ins_h, h] @ Wout[W/2:2W] (ins_out rows, then the density rows,
            // contiguous in the pack): sigma 3, ins 4:C; columns 0:3 unused
            matmul(bufC + HW, LDA, HW, h, LDA, W, w + m.off_out + (size_t)HW * CP, CP,
                   StoreF32{stage, CP});
        } else {
            // sigma only: h @ Wout[W:2W] (the density rows; column 3)
            matmul(h, LDA, W, nullptr, 0, 0, w + m.off_out + (size_t)W * CP, CP,
                   StoreF32{stage, CP});
        }
        __syncthreads();

        if (tid < nv) {
            const float sigma = stage[tid * CP + 3] + bo[3];
            const float dist = dists[(size_t)ray * S + s0 + tid];
            alpha[tid] = 1.0f - expf(-fmaxf(sigma, 0.0f) * dist);
            zt[tid] = zv[(size_t)ray * S + s0 + tid];
        }
        __syncthreads();

        if (HEADS == H_NONE) {
            if (tid == 0) {
                float* wrow = out_w + (size_t)ray * S + s0;
                for (int i = 0; i < nv; ++i) {
                    const float a = alpha[i];
                    wrow[i] = a * T;
                    T = T * ((1.0f - a) + 1e-10f);
                }
            }
        } else if (tid < C && (ALL || tid >= 4)) {
            const float bc = bo[tid];
            for (int i = 0; i < nv; ++i) {
                const float a = alpha[i];
                const float wgt = a * T;
                float v;
                if (tid < 3) v = 1.0f / (1.0f + expf(-(stage[i * CP + tid] + bc)));
                else if (tid == 3) v = zt[i];
                else v = stage[i * CP + tid] + bc;
                acc += wgt * v;
                T = T * ((1.0f - a) + 1e-10f);
            }
        }
        __syncthreads();   // the next sub-tile overwrites stage, alpha and zt
    }

    if (HEADS != H_NONE && tid < C) {
        if (tid < 3) { if (ALL) out_rgb[(size_t)ray * 3 + tid] = acc; }
        else if (tid == 3) { if (ALL) out_depth[ray] = acc; }
        else out_ins[(size_t)ray * (C - 4) + (tid - 4)] = acc;
    }
}

// o0, o1, o2: weights, -, - (H_NONE); rgb, depth, ins (H_ALL); -, -, ins (H_INS).
template <Heads HEADS>
int launch(const float* pts, const float* vdirs, const float* z, const float* dists,
           int R, int S, const bf16* w, const float* b, const int* meta, int n_meta,
           float* o0, float* o1, float* o2, void* stream) {
    if (n_meta != META_INTS) return (int)cudaErrorInvalidValue;
    Meta m;
    memcpy(&m, meta, sizeof(Meta));
    if (m.D < 1 || m.D > MAXD || m.W % 32 || m.XP % 16 || m.DP % 16 || m.CP % 16
        || m.XP > m.W || m.DP > m.W / 2 || m.CP > m.W / 2 || R < 1 || S < 1)
        return (int)cudaErrorInvalidValue;
    const size_t smem = smem_bytes(m, HEADS != H_NONE);
    cudaError_t err = cudaFuncSetAttribute(render_field_kernel<HEADS>,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                                           (int)smem);
    if (err != cudaSuccess) return (int)err;
    constexpr bool ALL = HEADS == H_ALL;
    render_field_kernel<HEADS><<<R, NTHREADS, smem, (cudaStream_t)stream>>>(
        pts, vdirs, z, dists, S, w, b, m, HEADS == H_NONE ? o0 : nullptr,
        ALL ? o0 : nullptr, ALL ? o1 : nullptr, o2);
    return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// K4: weights [R,S] <- pts [R,S,3], z [R,S], dists [R,S] (all fp32).
int render_field_sigma(const float* pts, const float* z, const float* dists, int R, int S,
                       const bf16* w, const float* b, const int* meta, int n_meta,
                       float* weights, void* stream) {
    return launch<H_NONE>(pts, nullptr, z, dists, R, S, w, b, meta, n_meta,
                          weights, nullptr, nullptr, stream);
}

// K3: rgb [R,3], depth [R], ins logits [R,K+1] <- pts [R,S,3], viewdirs [R,3],
// z [R,S], dists [R,S] (all fp32).
int render_field_all(const float* pts, const float* vdirs, const float* z,
                     const float* dists, int R, int S, const bf16* w, const float* b,
                     const int* meta, int n_meta, float* rgb, float* depth, float* ins,
                     void* stream) {
    return launch<H_ALL>(pts, vdirs, z, dists, R, S, w, b, meta, n_meta,
                         rgb, depth, ins, stream);
}

// K5: ins logits [R,K+1] <- pts [R,S,3], z [R,S], dists [R,S] (all fp32).
int render_field_ins(const float* pts, const float* z, const float* dists, int R, int S,
                     const bf16* w, const float* b, const int* meta, int n_meta,
                     float* ins, void* stream) {
    return launch<H_INS>(pts, nullptr, z, dists, R, S, w, b, meta, n_meta,
                         nullptr, nullptr, ins, stream);
}

const char* render_field_error_string(int err) {
    return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
