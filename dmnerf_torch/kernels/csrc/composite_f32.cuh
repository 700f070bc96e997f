// The f32 builds of K3, K4 and K5 (render_field_{all,sigma,ins}_f32 in
// render_field.cu): the field of models/fields.apply_field in fp32, then
// core/rendering.composite, as the JAX kernel
// dmnerf_tpu/ops/pallas/render_field.py::_composite_kernel computes them with
// compute_dtype float32. A design of their own for Hopper; the bf16 builds
// and K1/K2 stay on field_core.cuh.
//
// What bounds it on the H100: fp32-accurate products, three TF32 passes on
// the tensor cores (3 x 1.4 MFLOP per point at 495 TFLOP/s, the bound), and
// the weights, which a block streams from L2 once per 64-point tile. The
// design before this one ran K1's core: 16 warps of mma.sync meeting at a
// block-wide barrier once per 32-deep slab of a two-stage cp.async ring,
// each B fragment split into hi and lo after its load; it sat at 17-19% of
// the bound, its weight loads took 15% of its time and its barrier 5-10%
// (PERF.md section 6). This one:
// - A block of 4 consumer warpgroups and one producer warp. The producer's
//   lane 0 walks the weight plan once per tile and keeps the ring full: one
//   1-D bulk copy (cp.async.bulk, the TMA's 1-D form) per 8-deep slab into a
//   ring of STAGES stages, each with a full mbarrier (the copy's bytes) and
//   an empty one (an arrival from each of the 16 consumer warps). It fetches
//   ahead across layers and tiles; a consumer waits only for the slab it
//   reads, and no thread meets the others per slab.
// - Products on wgmma.mma_async m64nNk8 tf32: a 64-point tile is one M. Each
//   consumer warpgroup owns a run of the layer's 8-column tiles (N = 64 of
//   W = 256; down to 8 at W = 32). A (the tile's fp32 activations) comes
//   from registers, loaded by ldmatrix and split once per load, hi = tf32(x)
//   and lo = tf32(x - hi) rounded to nearest (in integer arithmetic, which
//   issues faster than cvt.rna: 0.92x the time); B from the slab by
//   descriptor. Per 8-deep step a partial takes lo_a hi_b (from zero), hi_a
//   lo_b and hi_a hi_b, and one fp32 add takes it into the accumulator: the
//   tensor cores' own accumulation truncates (field_core.cuh, mma_3xtf32).
// - The weights are packed for this kernel (kernels/render_field.py::
//   pack_field, slabs): per segment of the plan, per 8-deep slab, B's hi
//   block then its lo block, each K-major in the no-swizzle canonical layout
//   (core matrices of 8 output columns x 4 reduction rows, 128 bytes; the
//   two 4-deep halves LBO = N / 8 x 128 bytes apart, the 8-column groups
//   SBO = 128 bytes apart), so that one bulk copy lands a slab as wgmma
//   reads it. hi = tf32(w) rounded to nearest, lo = w - hi, exact in fp32
//   (the tensor cores read its top 19 bits). B costs no split on the card,
//   and twice the bytes per slab from L2 (5.59 MB per tile).
// - Layer barriers: the MLP is a chain, so a layer's output is stored over
//   the tile's activation buffers after every consumer warpgroup has read
//   its input, and read after all have stored it: a named barrier among the
//   512 consumer threads (bar.sync 1, 512), which the producer never joins.
// - The composite is the parent's: the tile's fp32 raw [64, CP] (bias
//   added) staged over the activation buffers, alpha per row, then one
//   thread per (ray of the block, output channel) scanning the ray's rows
//   in sample order, T_{i+1} = T_i ((1 - alpha_i) + 1e-10), T and the sums
//   carried across tiles; rays per block by group_rays.
// Measured on the card (PERF.md section 6): K3, K5 and K4 take 0.48-0.50x
// the parent's time, 34-40% of the bound. Neither L2 nor the barriers bound
// it (the slab loads taken out: 0.99-1.02x; the layer barriers: 0.96-0.98x):
// each warpgroup's step is a chain (slab wait, A load and split, three
// dependent wgmma, wait, flush into the accumulator), so the tensor cores
// idle between a warpgroup's groups (one TF32 pass: 0.74-0.77x). Two
// partials in flight per warpgroup would hide that chain, but at 96
// registers (544 threads) they spill, and setmaxnreg did not lift ptxas's
// limit; one partial ships.
// Shared memory at the flagship field (W 256, DP 32, CP 48; bytes):
//   H [64, W + 4] fp32                       66,560
//   Bf [64, W + DP + 4] fp32                 74,752
//   (the tile's raw [64, CP + 4] fp32 is staged over H and Bf)
//   ring, 5 stages x 8 x W x (hi, lo) fp32   81,920
//   alpha [64], T and sums [2, 512]           4,352
//   mbarriers, full and empty per stage          80
//   in all                                  227,664 of 232,448
// STAGES is chosen per launch: as many stages of the widest slab as fit, at
// most MAXSTAGES (W 128: 8).

#pragma once

#include <cstdint>

#include "field_tile.cuh"

namespace f32c {

using core::smem_u32;

constexpr int TM = 64;                     // points per tile: one wgmma M
constexpr int NWG = 4;                     // consumer warpgroups
constexpr int CONSUMERS = NWG * 128;
constexpr int THREADS = CONSUMERS + 32;    // and the producer warp
constexpr int KS = 8;                      // reduction rows per slab
constexpr int MAXSTAGES = 8;
constexpr int APAD = 4;                    // words of padding per activation row
constexpr int NA = 32;                     // accumulators per thread: 8 tiles of 8 columns
// the plan's segments at most (MAXD trunk layers, a skip input, 7 of the
// heads); pack_field writes as many slab offsets after the Meta ints
constexpr int MAXSEG = MAXD + 8;

// One segment of the plan: an [rows, n] matrix of the packed slabs at word
// offset off, rows / KS slabs of 16 n words (hi, then lo); nl is the width
// of the layer it adds to, which sets each warpgroup's columns.
struct Seg {
    int off, rows, n, nl;
};

struct Plan {
    int n;                 // segments
    int stages;            // ring stages
    int stage_words;       // words of one stage: the widest slab
    Seg s[MAXSEG];
};

// ---- PTX ------------------------------------------------------------------------

__device__ __forceinline__ void mbar_init(uint64_t* b, int count) {
    asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_u32(b)), "r"(count)
                 : "memory");
}

__device__ __forceinline__ void mbar_wait(uint64_t* b, uint32_t parity) {
    uint32_t done;
    do {
        asm volatile("{\n.reg .pred p;\nmbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
                     "selp.u32 %0, 1, 0, p;\n}\n"
                     : "=r"(done) : "r"(smem_u32(b)), "r"(parity) : "memory");
    } while (!done);
}

__device__ __forceinline__ void mbar_arrive(uint64_t* b) {
    asm volatile("{\n.reg .b64 st;\nmbarrier.arrive.shared::cta.b64 st, [%0];\n}\n"
                 ::"r"(smem_u32(b)) : "memory");
}

// arrive, and expect bytes of asynchronous copies to complete on b
__device__ __forceinline__ void mbar_expect_tx(uint64_t* b, uint32_t bytes) {
    asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
                 ::"r"(smem_u32(b)), "r"(bytes) : "memory");
}

// bytes (a multiple of 16) from global src to shared dst, completing on b
__device__ __forceinline__ void bulk_copy(void* dst, const void* src, uint32_t bytes, uint64_t* b) {
    asm volatile("cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
                 "[%0], [%1], %2, [%3];\n"
                 ::"r"(smem_u32(dst)), "l"(src), "r"(bytes), "r"(smem_u32(b)) : "memory");
}

__device__ __forceinline__ void consumers_sync() {
    asm volatile("bar.sync 1, %0;\n" ::"n"(CONSUMERS) : "memory");
}

__device__ __forceinline__ void wgmma_fence() {
    asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
    asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_wait() {
    asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}

// a register the compiler must take as written here: keeps it out of reach
// of the code before and after (a wgmma reads and writes its registers
// asynchronously, until wgmma_wait)
__device__ __forceinline__ void pin(float& r) { asm volatile("" : "+f"(r)::"memory"); }
__device__ __forceinline__ void pin(uint32_t& r) { asm volatile("" : "+r"(r)::"memory"); }

// The descriptor of a K-major B in the no-swizzle canonical layout at p:
// core matrices (8 columns x 16 bytes) kstride bytes apart along the
// reduction, 128 bytes apart along the columns.
__device__ __forceinline__ uint64_t b_desc(const float* p, uint32_t kstride) {
    return (uint64_t)((smem_u32(p) & 0x3FFFF) >> 4) | ((uint64_t)(kstride >> 4) << 16)
        | ((uint64_t)(128 >> 4) << 32);
}

// d (the first 4 NT of NA accumulators) = a @ B + (scale_d ? d : 0), a
// 64 x 8 tf32 A from registers (this warp's 16 rows: the m16n8k8 A
// fragment), B 8 x 8 NT by descriptor. The accumulators are the m64nN
// fragment: d[4j + {0, 1}] at row 16 (warp % 4) + lane / 4, columns 8j +
// 2 (lane % 4) + {0, 1}; d[4j + {2, 3}] 8 rows below.
template <int NT> struct Wgmma;

template <> struct Wgmma<1> {
    template <int M>
    static __device__ __forceinline__ void mma(float (&d)[M], const uint32_t (&a)[4], uint64_t b,
                                               int scale_d) {
        asm volatile(
            "{\n.reg .pred p;\nsetp.ne.b32 p, %9, 0;\n"
            "wgmma.mma_async.sync.aligned.m64n8k8.f32.tf32.tf32 {"
            "%0, %1, %2, %3 "
            "}, {%4, %5, %6, %7}, %8, p, 1, 1;\n}\n"
            : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
            : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(scale_d));
    }
};

template <> struct Wgmma<2> {
    template <int M>
    static __device__ __forceinline__ void mma(float (&d)[M], const uint32_t (&a)[4], uint64_t b,
                                               int scale_d) {
        asm volatile(
            "{\n.reg .pred p;\nsetp.ne.b32 p, %13, 0;\n"
            "wgmma.mma_async.sync.aligned.m64n16k8.f32.tf32.tf32 {"
            "%0, %1, %2, %3, %4, %5, %6, %7 "
            "}, {%8, %9, %10, %11}, %12, p, 1, 1;\n}\n"
            : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
              "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7])
            : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(scale_d));
    }
};

template <> struct Wgmma<3> {
    template <int M>
    static __device__ __forceinline__ void mma(float (&d)[M], const uint32_t (&a)[4], uint64_t b,
                                               int scale_d) {
        asm volatile(
            "{\n.reg .pred p;\nsetp.ne.b32 p, %17, 0;\n"
            "wgmma.mma_async.sync.aligned.m64n24k8.f32.tf32.tf32 {"
            "%0, %1, %2, %3, %4, %5, %6, %7, "
            "%8, %9, %10, %11 "
            "}, {%12, %13, %14, %15}, %16, p, 1, 1;\n}\n"
            : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
              "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
              "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11])
            : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(scale_d));
    }
};

template <> struct Wgmma<4> {
    template <int M>
    static __device__ __forceinline__ void mma(float (&d)[M], const uint32_t (&a)[4], uint64_t b,
                                               int scale_d) {
        asm volatile(
            "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
            "wgmma.mma_async.sync.aligned.m64n32k8.f32.tf32.tf32 {"
            "%0, %1, %2, %3, %4, %5, %6, %7, "
            "%8, %9, %10, %11, %12, %13, %14, %15 "
            "}, {%16, %17, %18, %19}, %20, p, 1, 1;\n}\n"
            : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
              "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
              "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
              "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
            : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(scale_d));
    }
};

template <> struct Wgmma<5> {
    template <int M>
    static __device__ __forceinline__ void mma(float (&d)[M], const uint32_t (&a)[4], uint64_t b,
                                               int scale_d) {
        asm volatile(
            "{\n.reg .pred p;\nsetp.ne.b32 p, %25, 0;\n"
            "wgmma.mma_async.sync.aligned.m64n40k8.f32.tf32.tf32 {"
            "%0, %1, %2, %3, %4, %5, %6, %7, "
            "%8, %9, %10, %11, %12, %13, %14, %15, "
            "%16, %17, %18, %19 "
            "}, {%20, %21, %22, %23}, %24, p, 1, 1;\n}\n"
            : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
              "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
              "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
              "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
              "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19])
            : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(scale_d));
    }
};

template <> struct Wgmma<6> {
    template <int M>
    static __device__ __forceinline__ void mma(float (&d)[M], const uint32_t (&a)[4], uint64_t b,
                                               int scale_d) {
        asm volatile(
            "{\n.reg .pred p;\nsetp.ne.b32 p, %29, 0;\n"
            "wgmma.mma_async.sync.aligned.m64n48k8.f32.tf32.tf32 {"
            "%0, %1, %2, %3, %4, %5, %6, %7, "
            "%8, %9, %10, %11, %12, %13, %14, %15, "
            "%16, %17, %18, %19, %20, %21, %22, %23 "
            "}, {%24, %25, %26, %27}, %28, p, 1, 1;\n}\n"
            : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
              "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
              "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
              "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
              "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
              "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23])
            : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(scale_d));
    }
};

template <> struct Wgmma<7> {
    template <int M>
    static __device__ __forceinline__ void mma(float (&d)[M], const uint32_t (&a)[4], uint64_t b,
                                               int scale_d) {
        asm volatile(
            "{\n.reg .pred p;\nsetp.ne.b32 p, %33, 0;\n"
            "wgmma.mma_async.sync.aligned.m64n56k8.f32.tf32.tf32 {"
            "%0, %1, %2, %3, %4, %5, %6, %7, "
            "%8, %9, %10, %11, %12, %13, %14, %15, "
            "%16, %17, %18, %19, %20, %21, %22, %23, "
            "%24, %25, %26, %27 "
            "}, {%28, %29, %30, %31}, %32, p, 1, 1;\n}\n"
            : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
              "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
              "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
              "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
              "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
              "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
              "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27])
            : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(scale_d));
    }
};

template <> struct Wgmma<8> {
    template <int M>
    static __device__ __forceinline__ void mma(float (&d)[M], const uint32_t (&a)[4], uint64_t b,
                                               int scale_d) {
        asm volatile(
            "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
            "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 {"
            "%0, %1, %2, %3, %4, %5, %6, %7, "
            "%8, %9, %10, %11, %12, %13, %14, %15, "
            "%16, %17, %18, %19, %20, %21, %22, %23, "
            "%24, %25, %26, %27, %28, %29, %30, %31 "
            "}, {%32, %33, %34, %35}, %36, p, 1, 1;\n}\n"
            : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
              "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
              "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
              "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
              "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
              "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
              "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
              "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
            : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(scale_d));
    }
};

template <int NT, int M>
__device__ __forceinline__ void wgmma_n(float (&d)[M], const uint32_t (&a)[4], uint64_t b,
                                        int scale_d) {
    static_assert(4 * NT <= M, "the accumulators hold 4 values per 8-column tile");
    Wgmma<NT>::mma(d, a, b, scale_d);
}

// ---- the ring: the consumers' side --------------------------------------------------

struct Ring {
    float* base;
    uint64_t* bars;        // full [stages], then empty [stages]
    int stages, stage_words;
    int slot;              // the slab this warp is at
    uint32_t phase;

    // the slab, landed
    __device__ __forceinline__ const float* wait() const {
        mbar_wait(bars + slot, phase);
        return base + slot * stage_words;
    }

    // this warp is done with the slab (its wgmma have completed): on to the
    // next
    __device__ __forceinline__ void release() {
        if (threadIdx.x % 32 == 0) mbar_arrive(bars + stages + slot);
        if (++slot == stages) { slot = 0; phase ^= 1; }
    }
};

// ---- the producer ------------------------------------------------------------------

// One thread: every slab of the plan, laps times, into the ring; then waits
// for the last slabs to land, so that no copy outlives the block.
__device__ __forceinline__ void produce(const Plan& plan, const float* __restrict__ slabs,
                                        float* ring, uint64_t* bars, int laps) {
    int slot = 0, fills = 0;
    uint32_t phase = 0;
    for (int lap = 0; lap < laps; ++lap)
        for (int i = 0; i < plan.n; ++i) {
            const Seg s = plan.s[i];
            const uint32_t bytes = 64u * s.n;          // 8 rows x n columns, hi and lo
            const float* src = slabs + s.off;
            for (int k = 0; k < s.rows; k += KS, src += 16 * s.n, ++fills) {
                uint64_t* full = bars + slot;
                mbar_wait(bars + plan.stages + slot, phase ^ 1);
                mbar_expect_tx(full, bytes);
                bulk_copy(ring + slot * plan.stage_words, src, bytes, full);
                if (++slot == plan.stages) { slot = 0; phase ^= 1; }
            }
        }
    for (int j = 0; j < plan.stages && j < fills; ++j) {
        if (slot == 0) { slot = plan.stages; phase ^= 1; }
        --slot;
        mbar_wait(bars + slot, phase);
    }
}

// ---- a segment's products -------------------------------------------------------

template <int M>
__device__ __forceinline__ void zero(float (&acc)[M]) {
#pragma unroll
    for (int i = 0; i < M; ++i) acc[i] = 0.0f;
}

// This warpgroup's 8-column tiles of a layer nl wide: [t0, t0 + count).
__device__ __forceinline__ int wg_first(int nl) {
    return threadIdx.x / 128 * ((nl / 8 + NWG - 1) / NWG);
}
__device__ __forceinline__ int wg_count(int nl, int n) {
    const int t0 = wg_first(nl), per = (nl / 8 + NWG - 1) / NWG;
    return max(0, min(min(nl / 8, t0 + per), n / 8) - t0);
}

// cvt.rna.tf32.f32 on the bits of x (to nearest, ties away from zero) in
// integer arithmetic: the top dropped bit carries into the kept ones
__device__ __forceinline__ uint32_t rna_tf32(uint32_t x) {
    return (x + 0x1000u) & 0xFFFFE000u;
}

// this thread's A fragment (the m16n8k8 one of its warp's 16 rows) of the 8
// reduction steps at a, split: hi = tf32(x), lo = tf32(x - hi), x - hi exact
// in fp32
__device__ __forceinline__ void load_a(const float* a, uint32_t (&ah)[4], uint32_t (&al)[4]) {
    uint32_t x[4];
    core::ldsm_x4(x, a);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
        ah[i] = rna_tf32(x[i]);
        al[i] = rna_tf32(__float_as_uint(__uint_as_float(x[i]) - __uint_as_float(ah[i])));
    }
}

// acc (4 NT values) += A [TM, rows] (shared, ld lda) @ B, B the segment's
// slabs from the ring at this warpgroup's tiles; NT = 0: the slabs pass
// through. Per 8-deep step a partial p takes lo_a hi_b (from zero), hi_a
// lo_b and hi_a hi_b, and one fp32 add per value takes it into acc.
template <int NT, int M>
__device__ __forceinline__ void seg_steps(Ring& rg, float (&acc)[M], const float* A, int lda,
                                          const Seg& s) {
    const int lane = threadIdx.x % 32;
    const float* arow = A + (threadIdx.x / 32 % 4 * 16 + (lane & 15)) * lda + (lane >> 4) * 4;
    const int t0 = wg_first(s.nl);
    const uint32_t kstride = s.n / 8 * 128, lo = s.n * 32 / 16;
    float p[M];
    zero(p);
    for (int k = 0; k < s.rows; k += KS) {
        const float* st = rg.wait();
        if constexpr (NT > 0) {
            uint32_t ah[4], al[4];
            load_a(arow + k, ah, al);
            const uint64_t bh = b_desc(st + t0 * 32, kstride), bl = bh + lo;
            wgmma_fence();
            wgmma_n<NT>(p, al, bh, 0);
            wgmma_n<NT>(p, ah, bl, 1);
            wgmma_n<NT>(p, ah, bh, 1);
            wgmma_commit();
            wgmma_wait();
#pragma unroll
            for (int i = 0; i < 4; ++i) {
                pin(ah[i]);
                pin(al[i]);
            }
#pragma unroll
            for (int i = 0; i < 4 * NT; ++i) {
                pin(p[i]);
                acc[i] += p[i];
            }
        }
        rg.release();
    }
}

// acc += A @ B over the plan's next segment (its slabs at this warpgroup's
// tiles of the layer).
template <int M>
__device__ __forceinline__ void run_seg(Ring& rg, const Plan& plan, int& si, float (&acc)[M],
                                        const float* A, int lda) {
    const Seg s = plan.s[si];
    if (++si == plan.n) si = 0;
    switch (wg_count(s.nl, s.n)) {
#define F32C_CASE(NT) \
        case NT: if constexpr (M >= 4 * NT) seg_steps<NT>(rg, acc, A, lda, s); break;
        F32C_CASE(1) F32C_CASE(2) F32C_CASE(3) F32C_CASE(4)
        F32C_CASE(5) F32C_CASE(6) F32C_CASE(7) F32C_CASE(8)
#undef F32C_CASE
        default: seg_steps<0>(rg, acc, A, lda, s); break;
    }
}

// f(row, col, v0, v1) for every pair of adjacent columns this thread holds
// of an output nl wide, n of its columns computed
template <int M, class F>
__device__ __forceinline__ void for_pairs(float (&acc)[M], int nl, int n, F f) {
    const int lane = threadIdx.x % 32, nt = wg_count(nl, n);
    const int r = threadIdx.x / 32 % 4 * 16 + lane / 4, c = wg_first(nl) * 8 + 2 * (lane % 4);
#pragma unroll
    for (int j = 0; j < M / 4; ++j) {
        if (j < nt) {
            f(r, c + 8 * j, acc[4 * j], acc[4 * j + 1]);
            f(r + 8, c + 8 * j, acc[4 * j + 2], acc[4 * j + 3]);
        }
    }
}

// dst[r, c] = relu?(acc + bias[c]) over a layer nl wide
__device__ __forceinline__ void store_act(float (&acc)[NA], int nl,
                                          const float* __restrict__ bias, bool relu, float* dst,
                                          int ldd) {
    for_pairs(acc, nl, nl, [&](int r, int c, float v0, float v1) {
        const float2 bb = *reinterpret_cast<const float2*>(bias + c);
        v0 += bb.x;
        v1 += bb.y;
        if (relu) { v0 = fmaxf(v0, 0.0f); v1 = fmaxf(v1, 0.0f); }
        *reinterpret_cast<float2*>(dst + r * ldd + c) = make_float2(v0, v1);
    });
}

// ---- the kernel --------------------------------------------------------------------

__host__ __device__ inline int ld_h(const Meta& m) { return m.W + APAD; }
__host__ __device__ inline int ld_b(const Meta& m) { return m.W + m.DP + APAD; }
__host__ __device__ inline int ld_stage(const Meta& m) { return m.CP + 4; }

// bytes of H and Bf together, at least the raw stage's, a multiple of 128
__host__ __device__ inline size_t hb_bytes(const Meta& m) {
    const size_t hb = (size_t)TM * (ld_h(m) + ld_b(m)) * sizeof(float);
    const size_t st = (size_t)TM * ld_stage(m) * sizeof(float);
    return ((hb > st ? hb : st) + 127) / 128 * 128;
}

// bytes after the ring: alpha [TM], T and the sums [2, CONSUMERS], the
// mbarriers
inline size_t tail_bytes(int stages) {
    return (size_t)(TM + 2 * CONSUMERS) * sizeof(float) + 2 * stages * sizeof(uint64_t);
}

// G rays per block, their points in TM-point tiles. H_ALL: rgb [R,3], depth
// [R], instance logits [R,K+1] (K3). H_INS: instance logits [R,K+1] (K5).
// H_SIGMA: compositing weights [R,S] in out_ins (K4).
template <Heads HEADS>
__global__ void __launch_bounds__(THREADS, 1)
composite_f32(const float* __restrict__ pts, const float* __restrict__ vdirs,
              const float* __restrict__ zv, const float* __restrict__ dists, int R, int S, int G,
              const float* __restrict__ slabs, const float* __restrict__ b, const Meta m,
              const __grid_constant__ Plan plan, float* __restrict__ out_rgb,
              float* __restrict__ out_depth, float* __restrict__ out_ins) {
    extern __shared__ __align__(1024) unsigned char smem[];
    const int ldh = ld_h(m), ldb = ld_b(m), lds = ld_stage(m);
    float* H = reinterpret_cast<float*>(smem);
    float* Bf = H + TM * ldh;
    float* stage = H;                                  // fp32 raw [TM, lds], over H and Bf
    float* ring = reinterpret_cast<float*>(smem + hb_bytes(m));
    float* alpha = ring + plan.stages * plan.stage_words;
    float* carry = alpha + TM;
    uint64_t* bars = reinterpret_cast<uint64_t*>(carry + 2 * CONSUMERS);
    const int tid = threadIdx.x;
    const int ray0 = blockIdx.x * G, nr = min(G, R - ray0);
    const int n = nr * S, q0 = ray0 * S;               // the block's points, the first one's index
    const int tiles = (n + TM - 1) / TM;

    if (tid == 0) {
        for (int i = 0; i < plan.stages; ++i) {
            mbar_init(bars + i, 1);
            mbar_init(bars + plan.stages + i, CONSUMERS / 32);
        }
        asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    }
    __syncthreads();
    if (tid >= CONSUMERS) {
        if (tid == CONSUMERS) produce(plan, slabs, ring, bars, tiles);
        return;
    }

    const int W = m.W, HW = m.W / 2, XP = m.XP, DP = m.DP, C = m.C;
    const int pos_ch = 3 * (1 + 2 * m.F), view_ch = 3 * (1 + 2 * m.FV);
    const float* bo = b + m.boff_o;
    // this thread's ray of the block and output channel in the composite
    // (K4: one thread per ray)
    const int ch = HEADS == H_SIGMA ? 1 : C;
    const int g = tid / ch, c = tid % ch;
    const bool mine = g < nr && (HEADS != H_INS || c >= 4);
    carry[tid] = 1.0f;
    carry[CONSUMERS + tid] = 0.0f;

    Ring rg{ring, bars, plan.stages, plan.stage_words, 0, 0};
    int si = 0;
    float acc[NA], sig[4];
    for (int t = 0; t < tiles; ++t) {
        const int p0 = t * TM, nv = min(TM, n - p0);
        const float* pt = pts + (size_t)(q0 + p0) * 3;
        // the position encoding -> Bf[:, 0:XP]
        for (int i = tid; i < TM * XP; i += CONSUMERS) {
            const int r = i / XP, j = i % XP;
            Bf[r * ldb + j] = (r < nv && j < pos_ch) ? pe_channel(pt + r * 3, j) : 0.0f;
        }
        consumers_sync();
        // trunk: layer 0 reads the encoding, layer skip+1 reads [h, x]; every
        // layer writes over its input in H
        zero(acc);
        run_seg(rg, plan, si, acc, Bf, ldb);
        consumers_sync();
        store_act(acc, W, b + m.boff_t, true, H, ldh);
        consumers_sync();
        for (int i = 1; i < m.D; ++i) {
            zero(acc);
            run_seg(rg, plan, si, acc, H, ldh);
            if (i == m.skip + 1) run_seg(rg, plan, si, acc, Bf, ldb);
            consumers_sync();
            store_act(acc, W, b + m.boff_t + i * W, true, H, ldh);
            consumers_sync();
        }
        if (HEADS == H_ALL) {
            // the view encoding -> Bf[:, W:W+DP], beside rgb_f
            for (int i = tid; i < TM * DP; i += CONSUMERS) {
                const int r = i / DP, j = i % DP;
                Bf[r * ldb + W + j] = (r < nv && j < view_ch)
                    ? pe_channel(vdirs + (size_t)((q0 + p0 + r) / S) * 3, j) : 0.0f;
            }
            // rgb_f = h @ Wrgbf + b (no activation) -> Bf[:, 0:W]
            zero(acc);
            run_seg(rg, plan, si, acc, H, ldh);
            consumers_sync();
            store_act(acc, W, b + m.boff_rgbf, false, Bf, ldb);
            consumers_sync();
            // rgb_h = relu([rgb_f, enc_d] @ Wrh + b) -> Bf[:, 0:W/2]
            zero(acc);
            run_seg(rg, plan, si, acc, Bf, ldb);
            consumers_sync();
            store_act(acc, HW, b + m.boff_rh, true, Bf, ldb);
            consumers_sync();
        }
        // the density rows of the output layer, while h is in H: column 3 of
        // the output's first 8-column tile (warpgroup 0)
        zero(sig);
        run_seg(rg, plan, si, sig, H, ldh);
        if (HEADS != H_SIGMA) {
            // ins_f = h @ Winsf + b -> H
            zero(acc);
            run_seg(rg, plan, si, acc, H, ldh);
            consumers_sync();
            store_act(acc, W, b + m.boff_insf, false, H, ldh);
            consumers_sync();
            // ins_h = relu(ins_f @ Wih + b) -> H[:, 0:W/2]
            zero(acc);
            run_seg(rg, plan, si, acc, H, ldh);
            consumers_sync();
            store_act(acc, HW, b + m.boff_ih, true, H, ldh);
            consumers_sync();
            // the output layer: [density | 0] + rgb_h @ Wout[0:W/2] (H_ALL)
            // + ins_h @ Wout[W/2:W]
            zero(acc);
#pragma unroll
            for (int i = 0; i < 4; ++i) acc[i] = sig[i];
            if (HEADS == H_ALL) run_seg(rg, plan, si, acc, Bf, ldb);
            run_seg(rg, plan, si, acc, H, ldh);
        }
        consumers_sync();              // every warpgroup has read H and Bf
        // the tile's fp32 raw, bias added -> the stage
        const auto put = [&](int r, int cc, float v0, float v1) {
            *reinterpret_cast<float2*>(stage + r * lds + cc) =
                make_float2(v0 + bo[cc], v1 + bo[cc + 1]);
        };
        if (HEADS == H_SIGMA) for_pairs(sig, 8, 8, put);
        else for_pairs(acc, m.CP, m.CP, put);
        consumers_sync();
        if (tid < nv)
            alpha[tid] = 1.0f - expf(-fmaxf(stage[tid * lds + 3], 0.0f) * dists[q0 + p0 + tid]);
        consumers_sync();
        // this ray's rows of the tile, in sample order
        const int i0 = max(g * S - p0, 0), i1 = min((g + 1) * S - p0, nv);
        if (mine && i0 < i1) {
            float T_ = carry[tid], sum = carry[CONSUMERS + tid];
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
            carry[CONSUMERS + tid] = sum;
        }
        consumers_sync();              // the next tile writes its encoding over the stage
    }

    if (mine && HEADS != H_SIGMA) {
        const int ray = ray0 + g;
        const float sum = carry[CONSUMERS + tid];
        if (c < 3) out_rgb[(size_t)ray * 3 + c] = sum;
        else if (c == 3) out_depth[ray] = sum;
        else out_ins[(size_t)ray * (C - 4) + (c - 4)] = sum;
    }
}

// ---- the host side ------------------------------------------------------------------

// The plan of heads over the slab offsets so (the H_ALL plan's order:
// trunk layers, each skip layer's x rows after its h rows, rgb_feat,
// rgb_hidden, density rows, ins_feat, ins_hidden, rgb_out rows, ins_out
// rows; kernels/render_field.py::pack_field writes them)
inline void plan_heads(const Meta& m, const int* so, Heads heads, Plan* p) {
    const int W = m.W, HW = m.W / 2, CP = m.CP;
    p->n = 0;
    int maxn = 8;
    auto add = [&](int off, int rows, int n, int nl) {
        p->s[p->n++] = Seg{off, rows, n, nl};
        maxn = std::max(maxn, n);
    };
    int k = 0;
    add(so[k++], m.XP, W, W);
    for (int i = 1; i < m.D; ++i) {
        add(so[k++], W, W, W);
        if (i == m.skip + 1) add(so[k++], m.XP, W, W);
    }
    const int* h = so + k;
    if (heads == H_ALL) {
        add(h[0], W, W, W);
        add(h[1], W + m.DP, HW, HW);
    }
    add(h[2], W, 8, CP);
    if (heads != H_SIGMA) {
        add(h[3], W, W, W);
        add(h[4], W, HW, HW);
        if (heads == H_ALL) add(h[5], HW, 8, CP);
        add(h[6], HW, CP, CP);
    }
    p->stage_words = 16 * maxn;
}

}  // namespace f32c
