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
// bf16 with fp32 accumulation (the f32 builds: fp32 throughout), then
// core/rendering.composite.
//
// What bounds it on the H100: the work is a chain of small matmuls through a
// 9-layer MLP (about 1.4 MFLOP per point for the 8x256 field), followed by a
// scan along each ray. The weights of one field (698,789 bf16 values) do not
// fit in a block's shared memory, so the Pallas design of keeping every
// weight on chip does not carry over.
//
// The bf16 K3, K4 and K5 (composite_kernel) run the field on K1's core: field_tile.cuh's
// forward_tile, the very function of field.cu's K1, on 128-point tiles with
// the weights staged through a ring of shared-memory slabs (field_core.cuh).
// - One block takes G consecutive rays, whose G*S points are contiguous in
//   pts [R,S,3], and walks them in 128-point tiles; a tile may hold the end
//   of one ray and the start of the next, so each weight slab is read once
//   per 128 points whatever S is, and the ring runs on across the tiles of a
//   block. G is chosen per launch (group_rays) to leave the fewest padded
//   rows in the block's last tile, up to 8 rays and, for K3/K5, one thread
//   per (ray, output channel): 2 at S = 192 or 64 (no padding). For K4 at
//   S = 64, 4 and 8 rays per block (2 and 4 tiles, the ring across them)
//   gain nothing over 2, and 1 (half a tile) takes about 1.8 times as long
//   (the readings are in PERF.md section 6).
// - After a tile's output layer its fp32 raw [128, CP] (bias added, the same
//   sums as K1's raw; K4: the first 8 columns, the density in column 3) is
//   staged in shared memory over H and Bf, which the tile no longer needs,
//   and alpha is computed per row. Then one thread per (ray of the block,
//   output channel) walks that ray's rows of the tile in sample order,
//   carrying the transmittance T_{i+1} = T_i * ((1 - alpha_i) + 1e-10) (the
//   literal exclusive cumprod of core/rendering.composite) and its channel's
//   sum across tiles in shared memory, and writes the ray's output after the
//   block's last tile; K4's thread (one per ray) writes each alpha_i T_i as
//   it goes. The scan is small beside the tile's matmuls.
// - The output layer's register tile holds up to 128 columns (field_tile.cuh),
//   so K3 and K5 take K <= 123 at any width.
// - The f32 builds (render_field_{sigma,all,ins}_f32; the JAX kernel with
//   compute_dtype float32) are a kernel of their own, composite_f32.cuh:
//   64-point tiles, a producer warp keeping a ring of bulk-copied weight
//   slabs, wgmma in three TF32 passes, the same composite; they read
//   pack_field's slabs, not its bf16-shaped weights.
// - Positional encoding is computed in the kernels from the fp32 points, in
//   the reference channel order, with precise sinf/cosf (arguments reach
//   x*2^9, so fast-math intrinsics would be wrong); the packer needs no
//   permutation.
// - Outputs carry no lane padding: weights [R,S] (sigma), rgb [R,3], depth
//   [R] and instance logits [R,K+1] (all), or instance logits [R,K+1] (ins).
//
// Plain C interface for ctypes; each entry returns cudaGetLastError() after
// its launch so a refused launch is reported to the wrapper.

#include <cstring>

#include "composite_f32.cuh"

using core::Ring;

namespace {

constexpr int STAGES = 2;               // the weight ring: K1's
constexpr int KS = 64;                  // and its slab depth
constexpr int MAXG = 8;                 // rays per block at most

// Rays per block: of 1 .. min(MAXG, R, threads / ch), the count whose G*S
// points leave the smallest share of padded rows in their last tm-point tile
// (the fewest rays on a tie). ch: threads per ray of the scan, of threads.
int group_rays(int R, int S, int ch, int tm, int threads = THREADS) {
    const int gmax = std::max(1, std::min({MAXG, R, threads / ch}));
    int best = 1;
    double best_pad = 1.0;
    for (int g = 1; g <= gmax; ++g) {
        const long n = (long)g * S, padded = (n + tm - 1) / tm * tm;
        const double pad = (double)(padded - n) / padded;
        if (pad < best_pad) { best = g; best_pad = pad; }
    }
    return best;
}

// a tile's fp32 raw [TM, CP + 4] (4 columns of padding against bank
// conflicts), staged over H and Bf
__host__ __device__ inline int stage_ld(const Meta& m) { return m.CP + 4; }
__host__ __device__ inline size_t stage_bytes(const Meta& m) {
    return (size_t)core::TM<bf16> * stage_ld(m) * sizeof(float);
}

// composite state after the ring: alpha [TM], then T and the sum [2, THREADS]
size_t composite_smem(const Meta& m, const Plan& p) {
    return tile_smem<bf16>(m, p, STAGES, false, stage_bytes(m))
        + (size_t)(core::TM<bf16> + 2 * THREADS) * sizeof(float);
}

// G rays per block, their points in TM-point tiles through forward_tile.
// H_ALL: rgb [R,3], depth [R], instance logits [R,K+1] (K3). H_INS: instance
// logits [R,K+1] (K5). H_SIGMA: compositing weights [R,S] in out_ins (K4).
template <Heads HEADS>
__global__ void __launch_bounds__(THREADS, 1)
composite_kernel(const float* __restrict__ pts, const float* __restrict__ vdirs,
                 const float* __restrict__ zv, const float* __restrict__ dists, int R, int S,
                 int G, const bf16* __restrict__ w, const float* __restrict__ b, const Meta m,
                 const __grid_constant__ Plan plan, float* __restrict__ out_rgb,
                 float* __restrict__ out_depth, float* __restrict__ out_ins) {
    extern __shared__ __align__(128) unsigned char smem[];
    constexpr int TM = core::TM<bf16>;
    const Bufs<bf16> B = carve<bf16>(smem, m, plan, STAGES, false, stage_bytes(m));
    float* alpha = reinterpret_cast<float*>(B.tail);
    float* carry = alpha + TM;
    float* stage = reinterpret_cast<float*>(B.H);     // fp32 raw [TM, lds], over H and Bf
    const int lds = stage_ld(m);
    const int C = m.C, tid = threadIdx.x;
    const float* bo = b + m.boff_o;

    const int ray0 = blockIdx.x * G, nr = min(G, R - ray0);
    const int n = nr * S;                             // the block's points
    const int q0 = ray0 * S;                          // and the first one's index
    const int tiles = (n + TM - 1) / TM;
    // this thread's ray of the block and output channel in the composite
    // (K4: one thread per ray)
    const int ch = HEADS == H_SIGMA ? 1 : C;
    const int g = tid / ch, c = tid % ch;
    const bool mine = g < nr && (HEADS != H_INS || c >= 4);
    carry[tid] = 1.0f;
    carry[THREADS + tid] = 0.0f;

    Ring<bf16, STAGES, KS, true> Rg;
    Rg.start(B.ring, &plan, w, tiles);
    core::Acc<bf16> acc;
    core::AccT<bf16, HEADS == H_SIGMA ? 1 : core::NTO> acc_out;
    for (int t = 0; t < tiles; ++t) {
        const int p0 = t * TM, nv = min(TM, n - p0);
        forward_tile<HEADS, true, false>(Rg, B, acc, acc_out, pts + (size_t)(q0 + p0) * 3, nv,
                                         vdirs, q0 + p0, S, b, m,
                                         Save<bf16>{nullptr, nullptr, nullptr});
        __syncthreads();                 // every warp has read ins_h in H
        core::for_pairs(acc_out, HEADS == H_SIGMA ? 8 : m.CP,
                        [&](int r, int cc, float v0, float v1, int) {
            *reinterpret_cast<float2*>(stage + r * lds + cc) =
                make_float2(v0 + bo[cc], v1 + bo[cc + 1]);
        });
        __syncthreads();
        if (tid < nv)
            alpha[tid] = 1.0f - expf(-fmaxf(stage[tid * lds + 3], 0.0f) * dists[q0 + p0 + tid]);
        __syncthreads();
        // this ray's rows of the tile, in sample order
        const int i0 = max(g * S - p0, 0), i1 = min((g + 1) * S - p0, nv);
        if (mine && i0 < i1) {
            float T_ = carry[tid], sum = carry[THREADS + tid];
            for (int i = i0; i < i1; ++i) {
                const float a = alpha[i];
                const float wgt = a * T_;
                if (HEADS == H_SIGMA) {
                    out_ins[(size_t)q0 + p0 + i] = wgt;
                } else {
                    float v;
                    if (c < 3) v = 1.0f / (1.0f + expf(-stage[i * lds + c]));
                    else if (c == 3) v = zv[q0 + p0 + i];
                    else v = stage[i * lds + c];
                    sum += wgt * v;
                }
                T_ = T_ * ((1.0f - a) + 1e-10f);
            }
            carry[tid] = T_;
            carry[THREADS + tid] = sum;
        }
        __syncthreads();   // the next tile writes its encoding over the stage
    }

    if (mine && HEADS != H_SIGMA) {
        const int ray = ray0 + g;
        const float sum = carry[THREADS + tid];
        if (c < 3) out_rgb[(size_t)ray * 3 + c] = sum;
        else if (c == 3) out_depth[ray] = sum;
        else out_ins[(size_t)ray * (C - 4) + (c - 4)] = sum;
    }
}

// kernels/render_field.py::check_kernel_shape holds the wrappers to these
int read_meta(const int* meta, int n_meta, int R, int S, Meta* m) {
    if (n_meta != META_INTS) return (int)cudaErrorInvalidValue;
    memcpy(m, meta, sizeof(Meta));
    if (m->D < 1 || m->D > MAXD || m->W % 32 || m->W > core::MAXW || m->XP % 16
        || m->DP % 16 || m->CP % 16 || m->XP > m->W || m->DP > m->W / 2
        || m->CP > core::MAXCP || R < 1 || S < 1)
        return (int)cudaErrorInvalidValue;
    return 0;
}

// The f32 builds (composite_f32.cuh): the meta ints are Meta's, then the
// slab offsets of the H_ALL plan's segments (f32c::MAXSEG, -1 past the last)
template <Heads HEADS>
int launch_composite_f32(const float* pts, const float* vdirs, const float* z,
                         const float* dists, int R, int S, const float* slabs, const float* b,
                         const int* meta, int n_meta, float* rgb, float* depth, float* ins,
                         void* stream) {
    Meta m;
    if (n_meta != META_INTS + f32c::MAXSEG) return (int)cudaErrorInvalidValue;
    if (int err = read_meta(meta, META_INTS, R, S, &m)) return err;
    int offs[f32c::MAXSEG];
    memcpy(offs, meta + META_INTS, sizeof(offs));
    f32c::Plan p;
    f32c::plan_heads(m, offs, HEADS, &p);
    for (int i = 0; i < p.n; ++i)
        if (p.s[i].off < 0) return (int)cudaErrorInvalidValue;
    int dev, optin;
    cudaError_t err = cudaGetDevice(&dev);
    if (err == cudaSuccess)
        err = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
    if (err != cudaSuccess) return (int)err;
    // as many ring stages as fit beside the activations and the tail
    const long stage_bytes = (long)p.stage_words * sizeof(float);
    const long fixed = (long)(f32c::hb_bytes(m) + f32c::tail_bytes(f32c::MAXSTAGES));
    p.stages = (int)std::min<long>(f32c::MAXSTAGES, (optin - fixed) / stage_bytes);
    if (p.stages < 2) return (int)cudaErrorInvalidValue;
    const size_t smem = f32c::hb_bytes(m) + p.stages * stage_bytes + f32c::tail_bytes(p.stages);
    auto kernel = f32c::composite_f32<HEADS>;
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
    const int G = group_rays(R, S, HEADS == H_SIGMA ? 1 : m.C, f32c::TM, f32c::CONSUMERS);
    kernel<<<(R + G - 1) / G, f32c::THREADS, smem, (cudaStream_t)stream>>>(
        pts, vdirs, z, dists, R, S, G, slabs, b, m, p, rgb, depth, ins);
    return (int)cudaGetLastError();
}

template <Heads HEADS>
int launch_composite(const float* pts, const float* vdirs, const float* z, const float* dists,
                     int R, int S, const bf16* w, const float* b, const int* meta, int n_meta,
                     float* rgb, float* depth, float* ins, void* stream) {
    Meta m;
    if (int err = read_meta(meta, n_meta, R, S, &m)) return err;
    Planner<bf16> pb(KS);
    plan_forward(pb, m, HEADS, true);
    const size_t smem = composite_smem(m, pb.p);
    auto kernel = composite_kernel<HEADS>;
    cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                           (int)smem);
    if (err != cudaSuccess) return (int)err;
    const int G = group_rays(R, S, HEADS == H_SIGMA ? 1 : m.C, core::TM<bf16>);
    kernel<<<(R + G - 1) / G, THREADS, smem, (cudaStream_t)stream>>>(
        pts, vdirs, z, dists, R, S, G, w, b, m, pb.p, rgb, depth, ins);
    return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// K4: weights [R,S] <- pts [R,S,3], z [R,S], dists [R,S] (all fp32), bf16
// weights.
int render_field_sigma(const float* pts, const float* z, const float* dists, int R, int S,
                       const bf16* w, const float* b, const int* meta, int n_meta,
                       float* weights, void* stream) {
    return launch_composite<H_SIGMA>(pts, nullptr, z, dists, R, S, w, b, meta, n_meta,
                                     nullptr, nullptr, weights, stream);
}

// K3: rgb [R,3], depth [R], ins logits [R,K+1] <- pts [R,S,3], viewdirs [R,3],
// z [R,S], dists [R,S] (all fp32), bf16 weights.
int render_field_all(const float* pts, const float* vdirs, const float* z,
                     const float* dists, int R, int S, const bf16* w, const float* b,
                     const int* meta, int n_meta, float* rgb, float* depth, float* ins,
                     void* stream) {
    return launch_composite<H_ALL>(pts, vdirs, z, dists, R, S, w, b, meta, n_meta, rgb,
                                   depth, ins, stream);
}

// K5: ins logits [R,K+1] <- pts [R,S,3], z [R,S], dists [R,S] (all fp32),
// bf16 weights.
int render_field_ins(const float* pts, const float* z, const float* dists, int R, int S,
                     const bf16* w, const float* b, const int* meta, int n_meta,
                     float* ins, void* stream) {
    return launch_composite<H_INS>(pts, nullptr, z, dists, R, S, w, b, meta, n_meta,
                                   nullptr, nullptr, ins, stream);
}

// The f32 builds of K4, K3 and K5 (composite_f32.cuh): the same with the f32
// slabs of pack_field and their meta.
int render_field_sigma_f32(const float* pts, const float* z, const float* dists, int R, int S,
                           const float* w, const float* b, const int* meta, int n_meta,
                           float* weights, void* stream) {
    return launch_composite_f32<H_SIGMA>(pts, nullptr, z, dists, R, S, w, b, meta, n_meta,
                                         nullptr, nullptr, weights, stream);
}

int render_field_all_f32(const float* pts, const float* vdirs, const float* z,
                         const float* dists, int R, int S, const float* w, const float* b,
                         const int* meta, int n_meta, float* rgb, float* depth, float* ins,
                         void* stream) {
    return launch_composite_f32<H_ALL>(pts, vdirs, z, dists, R, S, w, b, meta, n_meta, rgb,
                                       depth, ins, stream);
}

int render_field_ins_f32(const float* pts, const float* z, const float* dists, int R, int S,
                         const float* w, const float* b, const int* meta, int n_meta,
                         float* ins, void* stream) {
    return launch_composite_f32<H_INS>(pts, nullptr, z, dists, R, S, w, b, meta, n_meta,
                                       nullptr, nullptr, ins, stream);
}

const char* render_field_error_string(int err) {
    return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
