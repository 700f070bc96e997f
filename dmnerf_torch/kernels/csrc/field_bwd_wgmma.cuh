// K2's bf16 build on a Hopper pipeline of its own: the per-tile pass
// (field_bwd_tile_kernel) and the dW GEMM (dw_partial_kernel) of field.cu's
// field_backward, for the shapes k2w::fits admits (widths 128 and 256, 4+K+1
// padded at most 128: every config of the repo and of the benchmark); other
// shapes, and the f32 build, keep field_core.cuh's mma.sync K2. The math, the
// rounding and the scratch arrays (act, dys, the fp32 partials) are
// field.cu's; only the order of the fp32 sums differs. It shares no device
// code with forward_tile, which K1, K3 and K5 run.
//
// What bounded the mma.sync K2 on the H100 (PERF.md section 6, the split at
// 589,824 points): 16 warps issuing ldmatrix for A and B before every
// mma.sync, with the weight slabs' cp.async loads taking 22% of the tile
// pass, its block-wide barrier per slab 7%, the act/dys row stores 27%, and
// in the dW GEMM the staging of act and dys 31%. This design:
// - A block of two consumer warpgroups and a producer warpgroup (384
//   threads; setmaxnreg gives each consumer thread 232 registers and each
//   producer thread 40) per tile of 128 points. Each consumer warpgroup owns
//   64 points and runs the whole chain for them, the forward recompute and
//   the backward: its layer barriers are named barriers of its own 128
//   threads, so the two meet only at the weight ring.
// - The producer warp walks the weight plan once and keeps the ring full: per
//   32-deep slab its lane 0 waits for the stage and expects its bytes, and
//   one lane per box issues a TMA load (cp.async.bulk.tensor.2d) into a ring
//   of stages with full and empty mbarriers (an arrival from each of the 8
//   consumer warps). The weights are read where pack_field(slabs=False) put
//   them, through one tensor map per segment of the plan: a forward segment
//   B = W[r0:r0+rows, :] (reduction over rows) lands N-major with the
//   128-byte swizzle (boxes of 64 columns x 32 rows); a backward one B =
//   W[r0:r0+rows, :]^T (reduction over the columns) lands K-major with the
//   64-byte swizzle (a box of 32 columns x rows). No repack, on the host or
//   on the card.
// - A warpgroup's activations (H and Bf) live in blocks of 64 rows x 64
//   columns with the 128-byte swizzle: the K-major A that wgmma reads by
//   descriptor, and a box that one TMA store writes to act or dys. Products
//   are wgmma.mma_async m64nNk16 bf16 with both operands in shared memory
//   (N = the layer's width, fp32 accumulators), the next slab's issued before
//   the last one's complete; a slab is freed once its products are done.
// - The epilogues are field_core.cuh's on the wgmma accumulator layout (the
//   m64nN fragment is the m16n8 one per warp and 8-column tile): bias (the
//   hidden layers' biases are copied to shared memory once a block), ReLU,
//   bf16 rounding and the ReLU mask bits, one 32-bit word per thread and 64
//   columns, kept per tile in a global scratch and read back by the same
//   thread in the backward. The encodings take sin and cos of a coordinate
//   and octave together (sincosf: pe_channel's values).
// - The dW GEMM: one block per 128 x 256 tile of a weight matrix and fixed
//   range of psplit points (field.cu's jobs, splits and reduction, so the
//   sums' order is fixed and two launches give the same bits). The producer
//   warp brings 64-point stages of act (A = act^T, 2 boxes of 64 rows of dW)
//   and dys (B, up to 4 boxes of 64 columns) by TMA with the 128-byte
//   swizzle, a lane per box, and each consumer warpgroup runs one m64nNk16
//   per 16 points with both operands through the transpose bits. A stage is
//   freed as soon as its products are done, before the bias sums, which read
//   the dys stage in the same order as before: point by point.
// Shared memory at the flagship field (W 256, DP 32, CP 48; bytes):
//   H [4 blocks] and Bf [5 blocks] of both warpgroups     147,456
//   the hidden layers' biases                              11,264
//   ring, 4 stages x 32 x 256 bf16                         65,536 (1024-aligned)
//   mbarriers                                                  64
// The stages are chosen per launch: as many as fit, at most MAXSTAGES. The
// split of this design's time is recorded in PERF.md section 6.

#pragma once

#include <cstdint>

#include <cuda.h>
#include <cudaTypedefs.h>

#include "composite_f32.cuh"

namespace k2w {

using core::smem_u32;
using f32c::mbar_arrive;
using f32c::mbar_expect_tx;
using f32c::mbar_init;
using f32c::pin;
using f32c::wgmma_commit;
using f32c::wgmma_fence;

constexpr int TM = 128;                    // points per tile
constexpr int WGS = 2;                     // consumer warpgroups, 64 points each
constexpr int CONSUMERS = WGS * 128;
constexpr int THREADS = CONSUMERS + 128;   // and the producer warpgroup
// registers a thread keeps after setmaxnreg: a consumer, the producer
constexpr int CONSUMER_REGS = 232, PRODUCER_REGS = 40;
constexpr int KS = 32;                     // reduction rows per slab: two wgmma k steps
constexpr int MAXSTAGES = 8;
constexpr int PAD = 8;                     // bf16 padding of an activation row
constexpr int CHUNK = 4096;                // bytes of 32 reduction rows x 64 columns
constexpr int MAXSEG = 2 * MAXD + 13;      // the plan's segments at most
constexpr int SMEM_H100 = 232448;          // shared memory a block may take (opt-in)
// the dW GEMM: BM x BN tiles (field.cu's jobs), 64-point stages of act and dys
constexpr int GBM = 128, GBN = 256, GBK = 64, GSTAGES = 3;
constexpr int GBOX = 64 * 64 * 2;          // bytes of one 64 x 64 bf16 box
constexpr int GSTAGE = 2 * GBOX + 4 * GBOX;

// One segment of the plan: red reduction rows to out outputs; the TMA
// coordinates (column c0, row r0) of slab 0 in its matrix; trans: a backward
// segment (K-major slabs), else a forward one (N-major slabs).
struct Seg {
    int red, out, trans, c0, r0;
};

struct Plan {
    CUtensorMap map[MAXSEG];   // segment i's matrix, its box and swizzle
    Seg s[MAXSEG];
    int n, stages, stage_bytes;
};

// ---- PTX ----------------------------------------------------------------------------

template <int N>
__device__ __forceinline__ void setmaxnreg_inc() {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(N));
}

template <int N>
__device__ __forceinline__ void setmaxnreg_dec() {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(N));
}

template <int N>
__device__ __forceinline__ void wgmma_wait() {
    asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// Wait for the phase of parity to complete on mbarrier b; a copy that never
// lands (a wrong tensor map) stops the kernel with an error, not a hang.
__device__ __forceinline__ void mbar_wait(uint64_t* b, uint32_t parity) {
    for (uint32_t n = 0;; ++n) {
        uint32_t done;
        asm volatile("{\n.reg .pred p;\nmbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
                     "selp.u32 %0, 1, 0, p;\n}\n"
                     : "=r"(done) : "r"(smem_u32(b)), "r"(parity) : "memory");
        if (done) return;
        if (n == (1u << 24)) __trap();
    }
}

// one 2-D box of map at (column c0, row c1) to shared dst, completing on bar
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map, int c0, int c1,
                                         uint64_t* bar) {
    asm volatile("cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes "
                 "[%0], [%1, {%2, %3}], [%4];\n"
                 ::"r"(dst), "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1),
                 "r"(smem_u32(bar)) : "memory");
}

// The descriptor of an N-major (or M-major) operand with the 128-byte
// swizzle at shared address a: rows of 64 elements 128 bytes apart, 8-row
// groups 1024 apart (SBO), 64-column atoms lbo apart (LBO).
__device__ __forceinline__ uint64_t desc_sw128(uint32_t a, uint32_t lbo) {
    return (uint64_t)((a & 0x3FFFF) >> 4) | ((uint64_t)(lbo >> 4) << 16)
        | ((uint64_t)(1024 >> 4) << 32) | (1ull << 62);
}

// A K-major operand with the 128-byte swizzle: rows of 64 elements 128 bytes
// apart, 8-row groups 1024 apart (SBO); a 16-deep step starts 32 bytes on
// within the row (the swizzle is of the address).
__device__ __forceinline__ uint64_t desc_k128(uint32_t a) {
    return (uint64_t)((a & 0x3FFFF) >> 4) | (1ull << 16) | ((uint64_t)(1024 >> 4) << 32)
        | (1ull << 62);
}

// A K-major operand with the 64-byte swizzle: rows of 32 elements 64 bytes
// apart, 8-row groups 512 apart (SBO); a 16-deep step starts 32 bytes on.
__device__ __forceinline__ uint64_t desc_k64(uint32_t a) {
    return (uint64_t)((a & 0x3FFFF) >> 4) | (1ull << 16) | ((uint64_t)(512 >> 4) << 32)
        | (2ull << 62);
}

// d (the first N / 2 of M accumulators) = A (64 x 16) @ B (16 x N) + (scale_d
// ? d : 0), both by descriptor; TA, TB: A is M-major, B N-major (the
// transpose bits)
template <int N> struct WgmmaSS;

template <> struct WgmmaSS<64> {
    template <int TA, int TB, int M>
    static __device__ __forceinline__ void mma(float (&d)[M], uint64_t a, uint64_t b, int scale_d) {
        static_assert(64 / 2 <= M, "the accumulators hold the fragment");
        asm volatile(
            "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
            "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
            "%0, %1, %2, %3, %4, %5, %6, %7, "
            "%8, %9, %10, %11, %12, %13, %14, %15, "
            "%16, %17, %18, %19, %20, %21, %22, %23, "
            "%24, %25, %26, %27, %28, %29, %30, %31 "
            "}, %32, %33, p, 1, 1, %35, %36;\n}\n"
            : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
              "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
              "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
              "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
            : "l"(a), "l"(b), "r"(scale_d), "n"(TA), "n"(TB));
    }
};

template <> struct WgmmaSS<128> {
    template <int TA, int TB, int M>
    static __device__ __forceinline__ void mma(float (&d)[M], uint64_t a, uint64_t b, int scale_d) {
        static_assert(128 / 2 <= M, "the accumulators hold the fragment");
        asm volatile(
            "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
            "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
            "%0, %1, %2, %3, %4, %5, %6, %7, "
            "%8, %9, %10, %11, %12, %13, %14, %15, "
            "%16, %17, %18, %19, %20, %21, %22, %23, "
            "%24, %25, %26, %27, %28, %29, %30, %31, "
            "%32, %33, %34, %35, %36, %37, %38, %39, "
            "%40, %41, %42, %43, %44, %45, %46, %47, "
            "%48, %49, %50, %51, %52, %53, %54, %55, "
            "%56, %57, %58, %59, %60, %61, %62, %63 "
            "}, %64, %65, p, 1, 1, %67, %68;\n}\n"
            : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
              "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
              "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
              "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
              "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
              "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
              "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
              "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
            : "l"(a), "l"(b), "r"(scale_d), "n"(TA), "n"(TB));
    }
};

template <> struct WgmmaSS<192> {
    template <int TA, int TB, int M>
    static __device__ __forceinline__ void mma(float (&d)[M], uint64_t a, uint64_t b, int scale_d) {
        static_assert(192 / 2 <= M, "the accumulators hold the fragment");
        asm volatile(
            "{\n.reg .pred p;\nsetp.ne.b32 p, %98, 0;\n"
            "wgmma.mma_async.sync.aligned.m64n192k16.f32.bf16.bf16 {"
            "%0, %1, %2, %3, %4, %5, %6, %7, "
            "%8, %9, %10, %11, %12, %13, %14, %15, "
            "%16, %17, %18, %19, %20, %21, %22, %23, "
            "%24, %25, %26, %27, %28, %29, %30, %31, "
            "%32, %33, %34, %35, %36, %37, %38, %39, "
            "%40, %41, %42, %43, %44, %45, %46, %47, "
            "%48, %49, %50, %51, %52, %53, %54, %55, "
            "%56, %57, %58, %59, %60, %61, %62, %63, "
            "%64, %65, %66, %67, %68, %69, %70, %71, "
            "%72, %73, %74, %75, %76, %77, %78, %79, "
            "%80, %81, %82, %83, %84, %85, %86, %87, "
            "%88, %89, %90, %91, %92, %93, %94, %95 "
            "}, %96, %97, p, 1, 1, %99, %100;\n}\n"
            : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
              "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
              "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
              "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
              "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
              "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
              "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
              "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]),
              "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
              "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
              "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]), "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]),
              "+f"(d[88]), "+f"(d[89]), "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95])
            : "l"(a), "l"(b), "r"(scale_d), "n"(TA), "n"(TB));
    }
};

template <> struct WgmmaSS<256> {
    template <int TA, int TB, int M>
    static __device__ __forceinline__ void mma(float (&d)[M], uint64_t a, uint64_t b, int scale_d) {
        static_assert(256 / 2 <= M, "the accumulators hold the fragment");
        asm volatile(
            "{\n.reg .pred p;\nsetp.ne.b32 p, %130, 0;\n"
            "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 {"
            "%0, %1, %2, %3, %4, %5, %6, %7, "
            "%8, %9, %10, %11, %12, %13, %14, %15, "
            "%16, %17, %18, %19, %20, %21, %22, %23, "
            "%24, %25, %26, %27, %28, %29, %30, %31, "
            "%32, %33, %34, %35, %36, %37, %38, %39, "
            "%40, %41, %42, %43, %44, %45, %46, %47, "
            "%48, %49, %50, %51, %52, %53, %54, %55, "
            "%56, %57, %58, %59, %60, %61, %62, %63, "
            "%64, %65, %66, %67, %68, %69, %70, %71, "
            "%72, %73, %74, %75, %76, %77, %78, %79, "
            "%80, %81, %82, %83, %84, %85, %86, %87, "
            "%88, %89, %90, %91, %92, %93, %94, %95, "
            "%96, %97, %98, %99, %100, %101, %102, %103, "
            "%104, %105, %106, %107, %108, %109, %110, %111, "
            "%112, %113, %114, %115, %116, %117, %118, %119, "
            "%120, %121, %122, %123, %124, %125, %126, %127 "
            "}, %128, %129, p, 1, 1, %131, %132;\n}\n"
            : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
              "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
              "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
              "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
              "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
              "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
              "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
              "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]),
              "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
              "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
              "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]), "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]),
              "+f"(d[88]), "+f"(d[89]), "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]),
              "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]), "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103]),
              "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]), "+f"(d[108]), "+f"(d[109]), "+f"(d[110]), "+f"(d[111]),
              "+f"(d[112]), "+f"(d[113]), "+f"(d[114]), "+f"(d[115]), "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]),
              "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]), "+f"(d[124]), "+f"(d[125]), "+f"(d[126]), "+f"(d[127])
            : "l"(a), "l"(b), "r"(scale_d), "n"(TA), "n"(TB));
    }
};

// ---- the ring -----------------------------------------------------------------------

// The consumers' side of a ring of stages at shared address base; bars: full
// [stages], then empty [stages].
struct Ring {
    uint32_t base;
    uint64_t* bars;
    int stages, stage_bytes;
    int slot, rslot;       // the next stage to wait for, and to free
    uint32_t phase;

    // the next stage, landed: its shared address
    __device__ __forceinline__ uint32_t wait() {
        mbar_wait(bars + slot, phase);
        const uint32_t a = base + slot * stage_bytes;
        if (++slot == stages) { slot = 0; phase ^= 1; }
        return a;
    }

    // this warp is done with the oldest stage it holds (its reads of it and
    // the products that read it have completed)
    __device__ __forceinline__ void release() {
        __syncwarp();
        if (threadIdx.x % 32 == 0) mbar_arrive(bars + stages + rslot);
        if (++rslot == stages) rslot = 0;
    }
};

// slab k of segment s to the stage at shared address dst, box b by lane b
__device__ __forceinline__ void copy_slab(uint32_t dst, const CUtensorMap* map, const Seg& s,
                                          int k, int nb, uint64_t* full, int lane) {
    if (s.trans) {
        if (lane == 0) tma_load(dst, map, s.c0 + k, s.r0, full);
    } else if (lane < nb) {
        tma_load(dst + lane * CHUNK, map, s.c0 + 64 * lane, s.r0 + k, full);
    }
}

// The producer (one warp): every slab of the plan into the ring, in order;
// lane 0 waits for the stage to be free and expects its bytes, then each
// box of the slab has a lane of its own to issue it.
__device__ __forceinline__ void produce(const Plan& plan, uint32_t ring, uint64_t* bars) {
    const int lane = threadIdx.x % 32;
    int slot = 0;
    uint32_t phase = 0;
    for (int i = 0; i < plan.n; ++i) {
        const Seg s = plan.s[i];
        const CUtensorMap* map = &plan.map[i];
        const int nb = (s.out + 63) / 64;
        const uint32_t bytes = s.trans ? s.out * 64 : nb * CHUNK;
        for (int k = 0; k < s.red; k += KS) {
            uint64_t* full = bars + slot;
            if (lane == 0) {
                mbar_wait(bars + plan.stages + slot, phase ^ 1);
                mbar_expect_tx(full, bytes);
            }
            __syncwarp();
            copy_slab(ring + slot * plan.stage_bytes, map, s, k, nb, full, lane);
            if (++slot == plan.stages) { slot = 0; phase ^= 1; }
        }
    }
}

// ---- a warpgroup's activations ----------------------------------------------------------

// A warpgroup's activations live in blocks of its 64 rows x 64 columns, each
// row 128 bytes with the 16-byte chunks swizzled as the TMA's 128-byte
// swizzle lays them (chunk q of row r at q ^ (r % 8)): ldmatrix reads 8 rows
// of one chunk from 8 distinct bank groups, and one TMA store moves a block.
constexpr int BLK = 64 * 128;

// the byte offset of element (r, col) in a warpgroup's buffer
__device__ __forceinline__ int swz(int r, int col) {
    return (col >> 6) * BLK + r * 128 + ((((col >> 3) & 7) ^ (r & 7)) << 4) + (col & 7) * 2;
}

// ---- a segment's products -------------------------------------------------------------

// acc (M accumulators) = A [64, red] (this warpgroup's rows, columns col ..
// col + red of the buffer at shared address buf) @ B + (fresh ? 0 : acc), B
// the plan's next segment, N = 64 NC of its outputs (TRANS: a backward
// segment, K-major slabs), both read by descriptor. One wgmma per slab, the
// next one issued before the last completes; a slab is freed once its
// products are done.
template <int NC, bool TRANS, int M>
__device__ __forceinline__ void seg_steps(Ring& rg, const Seg& s, float (&acc)[M], uint32_t buf,
                                          int col, bool fresh) {
    for (int k = 0; k < s.red; k += KS) {
        const uint32_t st = rg.wait();
        const int steps = min(KS, s.red - k) / 16;
        uint64_t da[KS / 16], db[KS / 16];
#pragma unroll
        for (int kk = 0; kk < KS / 16; ++kk) {
            const int c = col + k + 16 * kk;
            da[kk] = desc_k128(buf + (c / 64) * BLK + (c % 64) * 2);
            db[kk] = TRANS ? desc_k64(st + 32 * kk) : desc_sw128(st + 2048 * kk, CHUNK);
        }
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < KS / 16; ++kk)
            if (kk < steps)
                WgmmaSS<64 * NC>::template mma<0, TRANS ? 0 : 1>(acc, da[kk], db[kk],
                                                                 k > 0 || kk > 0 || !fresh);
        wgmma_commit();
        if (k > 0) {
            wgmma_wait<1>();
            rg.release();
        }
    }
    wgmma_wait<0>();
    rg.release();
}

// the same for the plan's next segment, its outputs (up to 64 M / 32) known
// only at run time
template <bool TRANS, int M>
__device__ __forceinline__ void run_seg_any(Ring& rg, const Plan& plan, int& si, float (&acc)[M],
                                            uint32_t buf, int col, bool fresh) {
    const Seg& s = plan.s[si++];
    switch ((s.out + 63) / 64) {
        case 1: seg_steps<1, TRANS>(rg, s, acc, buf, col, fresh); break;
        case 2: if constexpr (M >= 64) seg_steps<2, TRANS>(rg, s, acc, buf, col, fresh); break;
        case 3: if constexpr (M >= 96) seg_steps<3, TRANS>(rg, s, acc, buf, col, fresh); break;
        default: if constexpr (M >= 128) seg_steps<4, TRANS>(rg, s, acc, buf, col, fresh); break;
    }
}

// the plan's next segment, of NC 64-column chunks
template <int NC, bool TRANS, int M>
__device__ __forceinline__ void run_seg(Ring& rg, const Plan& plan, int& si, float (&acc)[M],
                                        uint32_t buf, int col, bool fresh) {
    seg_steps<NC, TRANS>(rg, plan.s[si++], acc, buf, col, fresh);
}

// ---- epilogues ------------------------------------------------------------------------

// f(row, col, v0, v1, word, bit) for every pair of adjacent columns (col
// even) this thread holds of an output n wide: row of the warpgroup's 64,
// word the 64-column chunk's mask word, bit the pair's first bit in it
template <int M, class F>
__device__ __forceinline__ void for_pairs(float (&acc)[M], int n, F f) {
    const int lane = threadIdx.x % 32;
    const int r = threadIdx.x / 32 % 4 * 16 + lane / 4, c0 = 2 * (lane % 4);
#pragma unroll
    for (int j = 0; j < M / 4; ++j) {
        if (8 * j < n) {
#pragma unroll
            for (int h = 0; h < 2; ++h)
                f(r + 8 * h, 8 * j + c0, acc[4 * j + 2 * h], acc[4 * j + 2 * h + 1], j / 8,
                  4 * (j % 8) + 2 * h);
        }
    }
}

// a bf16 pair at byte offset off of the buffer at generic address buf;
// returns what was stored
__device__ __forceinline__ float2 put_pair(unsigned char* buf, int off, float a, float b) {
    return core::st_pair(reinterpret_cast<bf16*>(buf + off), a, b);
}

// buf[r, col + c] = bf16(relu?(acc + bias[c])) over n columns (bias in shared
// memory) and, if mask is non-null, the bits (stored value > 0) into this
// thread's words mask[w * CONSUMERS] (one per 64 columns)
template <int M>
__device__ __forceinline__ void store_act(float (&acc)[M], int n, const float* __restrict__ bias,
                                          bool relu, unsigned char* buf, int col,
                                          uint32_t* mask) {
    constexpr int NW = (M + 31) / 32;
    uint32_t words[NW] = {};
    for_pairs(acc, n, [&](int r, int c, float v0, float v1, int w, int bit) {
        const float2 bb = *reinterpret_cast<const float2*>(bias + c);
        v0 += bb.x;
        v1 += bb.y;
        if (relu) { v0 = fmaxf(v0, 0.0f); v1 = fmaxf(v1, 0.0f); }
        put_pair(buf, swz(r, col + c), v0, v1);
        // the stored bf16 > 0: v >= 0 rounds to 0 exactly when v <= 2^-134
        if (v0 > 0x1p-134f) words[w] |= 1u << bit;
        if (v1 > 0x1p-134f) words[w] |= 2u << bit;
    });
    if (mask) {
#pragma unroll
        for (int w = 0; w < NW; ++w)
            if (64 * w < n) mask[w * CONSUMERS + threadIdx.x] = words[w];
    }
}

// this thread's mask words of an output n wide, as store_act wrote them
template <int NW>
__device__ __forceinline__ void load_mask(uint32_t (&words)[NW], const uint32_t* mask, int n) {
#pragma unroll
    for (int w = 0; w < NW; ++w) words[w] = 64 * w < n ? mask[w * CONSUMERS + threadIdx.x] : 0u;
}

// buf[r, col + c] = bf16(acc * relu'(saved)) over n columns, words from
// load_mask (null: no ReLU)
template <int M>
__device__ __forceinline__ void store_grad(float (&acc)[M], int n, unsigned char* buf, int col,
                                           const uint32_t* words) {
    for_pairs(acc, n, [&](int r, int c, float v0, float v1, int w, int bit) {
        const uint32_t wd = words ? words[w] >> bit : 3u;
        put_pair(buf, swz(r, col + c), wd & 1u ? v0 : 0.0f, wd & 2u ? v1 : 0.0f);
    });
}

// fp32 accumulators to the warpgroup's rows of a global [rows, ld] array,
// added to what is there when add
template <int M>
__device__ __forceinline__ void store_f32(float (&acc)[M], int n, float* dst, int ld, bool add) {
    for_pairs(acc, n, [&](int r, int c, float v0, float v1, int, int) {
        float2* q = reinterpret_cast<float2*>(dst + (size_t)r * ld + c);
        if (add) { const float2 o = *q; v0 += o.x; v1 += o.y; }
        *q = make_float2(v0, v1);
    });
}

// ---- the warpgroup's barriers and stores ------------------------------------------------

// the named barrier of this warpgroup's 128 threads
__device__ __forceinline__ void wg_sync() {
    asm volatile("bar.sync %0, 128;\n" ::"r"(1 + (int)threadIdx.x / 128) : "memory");
}

// every thread's shared-memory writes so far, visible to the TMA
__device__ __forceinline__ void publish() {
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    wg_sync();
}

// a barrier after which the warpgroup's buffers may be written again: every
// TMA store has finished reading them
__device__ __forceinline__ void sync_write() {
    asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
    wg_sync();
}

// columns col .. col + ncols (whole blocks) of the warpgroup's buffer at
// shared address buf to columns gcol .. of rows p0 .. p0 + 64 of the tensor
// of map: one TMA store per block, by the warpgroup's first thread. Call after
// publish().
__device__ __forceinline__ void store_blocks(uint32_t buf, int col, int ncols,
                                             const CUtensorMap* map, int gcol, int p0) {
    if (threadIdx.x % 128 == 0) {
        for (int b = 0; b < ncols / 64; ++b)
            asm volatile("cp.async.bulk.tensor.2d.global.shared::cta.bulk_group [%0, {%2, %3}], [%1];\n"
                         ::"l"(reinterpret_cast<uint64_t>(map)), "r"(buf + (col / 64 + b) * BLK),
                         "r"(gcol + 64 * b), "r"(p0) : "memory");
        asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
    }
}

// ---- the shared memory of a tile ------------------------------------------------------

// 64-column blocks of a warpgroup's H (the trunk, then ins_f/ins_h and the
// trunk's gradients) and Bf (the encodings, rgb_f/rgb_h, the cotangent g
// beside the rgb gradients)
__host__ __device__ inline int h_blocks(const Meta& m) { return m.W / 64; }
__host__ __device__ inline int b_blocks(const Meta& m) {
    return (m.W + (m.CP > m.DP ? m.CP : m.DP) + 63) / 64;
}
// bytes of the hidden layers' biases (packed.b up to the output layer's,
// fp32), whole KB
__host__ __device__ inline size_t bias_bytes(const Meta& m) {
    return ((size_t)m.boff_o * sizeof(float) + 1023) / 1024 * 1024;
}
// bytes before the ring: room to align, H and Bf of both warpgroups, then the
// biases
__host__ __device__ inline size_t fixed_smem(const Meta& m) {
    return 1024 + (size_t)WGS * (h_blocks(m) + b_blocks(m)) * BLK + bias_bytes(m);
}
// bytes of one ring stage: the widest slab (32 x W, either way)
inline int stage_bytes(const Meta& m) { return m.W * 64; }
// ReLU mask words per thread (the masks scratch holds them per tile): one per
// 64 columns of each trunk layer, of rgb_h and of ins_h
__host__ __device__ inline int mask_words(const Meta& m) { return m.D * (m.W / 64) + m.W / 64; }

// The shapes this path takes (kernels/field.py::k2_core holds the same rule):
// widths 128 and 256 (whole 64-column blocks of every layer), CP <= 128, and a
// tile's buffers beside a ring of two stages within the H100's shared memory.
inline bool fits(const Meta& m) {
    return (m.W == 128 || m.W == 256) && m.CP <= 128
        && fixed_smem(m) + 2 * ((size_t)stage_bytes(m) + 16) <= (size_t)SMEM_H100;
}

// The positional encoding of the warpgroup's 64 points (pe_channel's
// channels: the coordinates, then sin and cos of each octave, then zeros to
// np) -> columns col .. col + np of the buffer at buf and of the global rows
// at dst (ld ldg); point(r) is row r's coordinates, rows from nv on are 0.
// One thread takes sin and cos of one coordinate and octave together.
template <class F>
__device__ __forceinline__ void encode(unsigned char* buf, bf16* dst, int ldg, int col, int np,
                                       int octaves, int nv, F point) {
    const int t = threadIdx.x % 128, nch = 3 * (1 + 2 * octaves);
    auto put = [&](int r, int j, float v) {
        const bf16 b = __float2bfloat16_rn(v);
        *reinterpret_cast<bf16*>(buf + swz(r, col + j)) = b;
        dst[(size_t)r * ldg + j] = b;
    };
    for (int i = t; i < 64 * np; i += 128) {
        const int r = i / np, j = i % np;
        if (j < 3 || j >= nch) put(r, j, r < nv && j < 3 ? point(r)[j] : 0.0f);
    }
    for (int i = t; i < 64 * 3 * octaves; i += 128) {
        const int r = i / (3 * octaves), f = i % (3 * octaves) / 3, d = i % 3;
        float sv = 0.0f, cv = 0.0f;
        if (r < nv) sincosf(ldexpf(point(r)[d], f), &sv, &cv);
        put(r, 3 + 6 * f + d, sv);
        put(r, 6 + 6 * f + d, cv);
    }
}

// ---- the kernels ------------------------------------------------------------------------

// K2, per-tile pass: field.cu's field_bwd_tile_kernel on this pipeline, at
// width W_ (m.W), each consumer warpgroup on its 64 points. act_map / dys_map:
// act [P_pad, ACT] and dys [P_pad, DYW] in 64 x 64 boxes (128-byte swizzle);
// masks: mask_words per thread per tile. gx [P_pad, XP] / gd [P_pad, DP] are
// written only when non-null; the plan has their segments exactly then.
template <class T, int W_>
__global__ void __launch_bounds__(THREADS, 1)
field_bwd_tile_kernel(const float* __restrict__ pts, const float* __restrict__ vdirs, int P,
                      int ppd, const float* __restrict__ b, const Meta m,
                      const __grid_constant__ Layout L, const __grid_constant__ Plan plan,
                      const __grid_constant__ CUtensorMap act_map,
                      const __grid_constant__ CUtensorMap dys_map, const float* __restrict__ g,
                      T* __restrict__ act, T* __restrict__ dys, uint32_t* __restrict__ masks,
                      float* __restrict__ gx, float* __restrict__ gd) {
    static_assert(sizeof(T) == 2, "the bf16 build");
    constexpr int W = W_, HW = W_ / 2, NW = W_ / 64, NH = HW / 64;
    extern __shared__ __align__(1024) unsigned char smem[];
    const int XP = m.XP, DP = m.DP, CP = m.CP, C = m.C, D = m.D;
    const uint32_t s0 = smem_u32(smem), base = (s0 + 1023) / 1024 * 1024;
    const int wg_bytes = (h_blocks(m) + b_blocks(m)) * BLK;
    const uint32_t ring = base + (uint32_t)(fixed_smem(m) - 1024);
    uint64_t* bars = reinterpret_cast<uint64_t*>(smem + (ring - s0)
                                                 + (size_t)plan.stages * plan.stage_bytes);
    // the hidden layers' biases, read by every epilogue, in shared memory
    float* const sb = reinterpret_cast<float*>(smem + (ring - s0) - bias_bytes(m));
    const int tid = threadIdx.x;
    for (int i = tid; i < m.boff_o; i += THREADS) sb[i] = b[i];
    if (tid == 0) {
        for (int i = 0; i < plan.stages; ++i) {
            mbar_init(bars + i, 1);
            mbar_init(bars + plan.stages + i, CONSUMERS / 32);
        }
        asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    }
    __syncthreads();
    if (tid >= CONSUMERS) {
        setmaxnreg_dec<PRODUCER_REGS>();
        if (tid < CONSUMERS + 32) produce(plan, ring, bars);
        return;
    }
    setmaxnreg_inc<CONSUMER_REGS>();

    // this warpgroup's 64 points, its H and Bf (shared addresses and generic
    // pointers), and its rows of act, dys and the masks
    const int t = tid % 128, wg = tid / 128;
    const int p0 = blockIdx.x * TM + wg * 64;
    const int nv = max(0, min(64, P - p0));
    const uint32_t H = base + wg * wg_bytes, Bf = H + h_blocks(m) * BLK;
    unsigned char* const Hp = smem + (H - s0);
    unsigned char* const Bp = smem + (Bf - s0);
    T* const arow = act + (size_t)p0 * L.ACT;
    T* const yrow = dys + (size_t)p0 * L.DYW;
    uint32_t* const trunk_mask = masks + (size_t)blockIdx.x * mask_words(m) * CONSUMERS;
    uint32_t* const rh_mask = trunk_mask + D * NW * CONSUMERS;
    uint32_t* const ih_mask = rh_mask + NH * CONSUMERS;
    Ring rg{ring, bars, plan.stages, plan.stage_bytes, 0, 0, 0};
    int si = 0;
    float acc[W / 2];
    uint32_t words[NW];

    // ---- forward, saving every activation to act ------------------------------
    // the position encoding -> Bf[:, 0:XP] and act
    encode(Bp, arow + L.a_x, L.ACT, 0, XP, m.F, nv, [&](int r) { return pts + (size_t)(p0 + r) * 3; });
    publish();
    // trunk: layer 0 reads the encoding, layer skip+1 reads [h, x]; every
    // layer writes over its input in H
    run_seg<NW, false>(rg, plan, si, acc, Bf, 0, true);
    sync_write();
    store_act(acc, W, sb + m.boff_t, true, Hp, 0, trunk_mask);
    publish();
    store_blocks(H, 0, W, &act_map, L.a_hs[0], p0);
    for (int i = 1; i < D; ++i) {
        run_seg<NW, false>(rg, plan, si, acc, H, 0, true);
        if (i == m.skip + 1) run_seg<NW, false>(rg, plan, si, acc, Bf, 0, false);
        sync_write();
        store_act(acc, W, sb + m.boff_t + i * W, true, Hp, 0, trunk_mask + i * NW * CONSUMERS);
        publish();
        store_blocks(H, 0, W, &act_map, L.a_hs[i], p0);
    }
    // the view encoding -> Bf[:, W:W+DP], beside rgb_f, and act
    encode(Bp, arow + L.a_encd, L.ACT, W, DP, m.FV, nv,
           [&](int r) { return vdirs + (size_t)((p0 + r) / ppd) * 3; });
    // rgb_f = h @ Wrgbf + b (no activation) -> Bf[:, 0:W]
    run_seg<NW, false>(rg, plan, si, acc, H, 0, true);
    sync_write();
    store_act(acc, W, sb + m.boff_rgbf, false, Bp, 0, nullptr);
    publish();
    store_blocks(Bf, 0, W, &act_map, L.a_rgbf, p0);
    // rgb_h = relu([rgb_f, enc_d] @ Wrh + b) -> Bf[:, 0:W/2]
    run_seg<NH, false>(rg, plan, si, acc, Bf, 0, true);
    sync_write();
    store_act(acc, HW, sb + m.boff_rh, true, Bp, 0, rh_mask);
    publish();
    store_blocks(Bf, 0, HW, &act_map, L.a_hh, p0);
    // ins_f = h @ Winsf + b -> H
    run_seg<NW, false>(rg, plan, si, acc, H, 0, true);
    sync_write();
    store_act(acc, W, sb + m.boff_insf, false, Hp, 0, nullptr);
    publish();
    store_blocks(H, 0, W, &act_map, L.a_insf, p0);
    // ins_h = relu(ins_f @ Wih + b) -> H[:, 0:W/2]
    run_seg<NH, false>(rg, plan, si, acc, H, 0, true);
    sync_write();
    store_act(acc, HW, sb + m.boff_ih, true, Hp, 0, ih_mask);
    publish();
    store_blocks(H, 0, HW, &act_map, L.a_hh + HW, p0);

    // ---- backward -------------------------------------------------------------
    // gb = bf16(g) [64, CP] -> G = Bf[:, W:W+CP] and dys
    sync_write();                    // rgb_f and rgb_h in Bf have been stored
    for (int i = t; i < 64 * CP; i += 128) {
        const int r = i / CP, c = i % CP;
        const bf16 v = __float2bfloat16_rn((r < nv && c < C) ? g[(size_t)(p0 + r) * C + c] : 0.0f);
        *reinterpret_cast<bf16*>(Bp + swz(r, W + c)) = v;
        yrow[(size_t)r * L.DYW + L.y_gb + c] = v;
    }
    publish();
    // d_rgb_h = mask(rgb_h) * (gb @ Wout[0:W/2]^T) -> H[:, 0:W/2]
    load_mask(words, rh_mask, HW);
    run_seg<NH, true>(rg, plan, si, acc, Bf, W, true);
    sync_write();                    // ins_h in H has been copied out
    store_grad(acc, HW, Hp, 0, words);
    // d_ins_h = mask(ins_h) * (gb @ Wout[W/2:W]^T) -> H[:, W/2:W]
    load_mask(words, ih_mask, HW);
    run_seg<NH, true>(rg, plan, si, acc, Bf, W, true);
    store_grad(acc, HW, Hp, HW, words);
    publish();
    store_blocks(H, 0, HW, &dys_map, L.y_rh, p0);
    store_blocks(H, HW, HW, &dys_map, L.y_ih, p0);
    // d_ins_f = d_ins_h @ Wih^T -> Bf[:, 0:W]: its dW and bias only, never
    // the trunk
    run_seg<NW, true>(rg, plan, si, acc, H, HW, true);
    sync_write();
    store_grad(acc, W, Bp, 0, nullptr);
    publish();
    store_blocks(Bf, 0, W, &dys_map, L.y_insf, p0);
    // [d_rgb_f | g_d] = d_rgb_h @ Wrh^T; d_rgb_f -> Bf[:, 0:W]; g_d -> gd
    run_seg<NW, true>(rg, plan, si, acc, H, 0, true);
    sync_write();
    store_grad(acc, W, Bp, 0, nullptr);
    if (gd) {
        run_seg_any<true>(rg, plan, si, acc, H, 0, true);
        store_f32(acc, DP, gd + (size_t)p0 * DP, DP, false);
    }
    publish();
    store_blocks(Bf, 0, W, &dys_map, L.y_rgbf, p0);
    // d_h = gb @ Wout[W:2W]^T (density) + d_rgb_f @ Wrgbf^T; dy_{D-1} -> H
    load_mask(words, trunk_mask + (D - 1) * NW * CONSUMERS, W);
    run_seg<NW, true>(rg, plan, si, acc, Bf, W, true);
    run_seg<NW, true>(rg, plan, si, acc, Bf, 0, false);
    sync_write();
    store_grad(acc, W, Hp, 0, words);
    publish();
    store_blocks(H, 0, W, &dys_map, L.y_dy[D - 1], p0);
    // the trunk: dy_{i-1} = mask(h_{i-1}) * (dy_i @ t_i[0:W]^T), over H; at
    // the skip layer rows W:W+XP of t_i face x and give part of g_x
    const bool skipped = m.skip + 1 < D;
    for (int i = D - 1; i >= 1; --i) {
        if (i == m.skip + 1 && gx) {
            run_seg_any<true>(rg, plan, si, acc, H, 0, true);
            store_f32(acc, XP, gx + (size_t)p0 * XP, XP, false);
        }
        load_mask(words, trunk_mask + (i - 1) * NW * CONSUMERS, W);
        run_seg<NW, true>(rg, plan, si, acc, H, 0, true);
        sync_write();
        store_grad(acc, W, Hp, 0, words);
        publish();
        store_blocks(H, 0, W, &dys_map, L.y_dy[i - 1], p0);
    }
    if (gx) {
        run_seg_any<true>(rg, plan, si, acc, H, 0, true);
        store_f32(acc, XP, gx + (size_t)p0 * XP, XP, skipped);
    }
    asm volatile("cp.async.bulk.wait_group 0;\n" ::: "memory");
}

// a dW stage: act's columns a0 .. a0 + 128 and dys's columns y0 .. y0 + 64 nb
// at points p .. p + 64, to the stage at shared address dst, box b by lane b
__device__ __forceinline__ void copy_stage(uint32_t dst, const CUtensorMap* act_map,
                                           const CUtensorMap* dys_map, int a0, int y0, int p,
                                           int nb, uint64_t* full, int lane) {
    if (lane < 2) tma_load(dst + lane * GBOX, act_map, a0 + 64 * lane, p, full);
    else if (lane < 2 + nb) tma_load(dst + lane * GBOX, dys_map, y0 + 64 * (lane - 2), p, full);
}

// The dW GEMM's consumers at N = 64 NB columns: acc = A^T B over the stages,
// to partial_w's rows r < K and columns c < N of the tile at (m0, n0); and
// the bias sums of column tid in a fixed order, point by point: of the dys
// stages (bias), or of the fp32 g rows they cover (bias_g), to *bsum.
template <int NB>
__device__ __forceinline__ void dw_consume(Ring& rg, const unsigned char* stages, uint32_t s_base,
                                           int nsteps, bool bias, bool bias_g,
                                           const float* __restrict__ g, int P, int C,
                                           int p_begin, float* dst, int K, int N, int m0, int n0,
                                           float* bsum) {
    const int tid = threadIdx.x, wg = tid / 128, lane = tid % 32;
    float acc[32 * NB];
    float sum = 0.0f;
    for (int s = 0; s < nsteps; ++s) {
        const uint32_t st = rg.wait();
        uint64_t da[GBK / 16], db[GBK / 16];
#pragma unroll
        for (int kk = 0; kk < GBK / 16; ++kk) {
            da[kk] = desc_sw128(st + wg * GBOX + kk * 2048, GBOX);
            db[kk] = desc_sw128(st + 2 * GBOX + kk * 2048, GBOX);
        }
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < GBK / 16; ++kk)
            WgmmaSS<64 * NB>::template mma<1, 1>(acc, da[kk], db[kk], s > 0 || kk > 0);   // the first: acc = A B
        wgmma_commit();
        // the last stage's products are done: free it before the bias sums
        if (s > 0) {
            wgmma_wait<1>();
            rg.release();
        }
        if (bias && !bias_g && tid < NB * 64) {
            // column tid of this stage's dys boxes (box tid / 64, 128-byte
            // swizzle: row r's chunk q lies at q ^ (r % 8))
            const unsigned char* col = stages + (st - s_base) + (2 + tid / 64) * GBOX
                + (tid % 8) * 2;
            const int q = tid % 64 / 8;
#pragma unroll
            for (int r = 0; r < GBK; ++r)
                sum += __bfloat162float(
                    *reinterpret_cast<const bf16*>(col + r * 128 + ((q ^ (r % 8)) << 4)));
        } else if (NB <= 2 && bias_g && tid < C) {      // the output layer: N = CP <= 128
            // 16 loads in flight at a time, summed in order
            const int p = p_begin + s * GBK;
            for (int r0 = 0; r0 < GBK; r0 += 16) {
                float v[16];
#pragma unroll
                for (int r = 0; r < 16; ++r)
                    v[r] = p + r0 + r < P ? __ldg(g + (size_t)(p + r0 + r) * C + tid) : 0.0f;
#pragma unroll
                for (int r = 0; r < 16; ++r) sum += v[r];
            }
        }
    }
    wgmma_wait<0>();
#pragma unroll
    for (int i = 0; i < 32 * NB; ++i) pin(acc[i]);
    rg.release();
    *bsum = sum;

    const int r0 = m0 + wg * 64 + tid / 32 % 4 * 16 + lane / 4;
#pragma unroll
    for (int jj = 0; jj < 8 * NB; ++jj)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
            const int r = r0 + 8 * h, c = n0 + 8 * jj + 2 * (lane % 4);
            if (r < K && c < N)
                *reinterpret_cast<float2*>(dst + (size_t)r * N + c) =
                    make_float2(acc[4 * jj + 2 * h], acc[4 * jj + 2 * h + 1]);
        }
}

// K2, dW pass: field.cu's dw_partial_kernel on this pipeline. Per (GBM x GBN
// tile of one job's dW, range of psplit points) an fp32 partial of act^T @
// dys into partial_w[blockIdx.y] and, for the first row tile of each job,
// the bias partial into partial_b[blockIdx.y]: consumer warpgroup w takes
// rows 64w of the tile and every column. act_map and dys_map: [P_pad, ACT]
// and [P_pad, DYW], 64 x 64 boxes, 128-byte swizzle.
template <class T, class Jobs>
__global__ void __launch_bounds__(THREADS, 1)
dw_partial_kernel(const __grid_constant__ CUtensorMap act_map,
                  const __grid_constant__ CUtensorMap dys_map, const float* __restrict__ g, int P,
                  int C, int P_pad, int psplit, const Jobs J, float* __restrict__ partial_w,
                  int n_w, float* __restrict__ partial_b, int n_b) {
    static_assert(sizeof(T) == 2, "the bf16 build");
    extern __shared__ __align__(1024) unsigned char smem[];
    const uint32_t s0 = smem_u32(smem), ring = (s0 + 1023) / 1024 * 1024;
    uint64_t* bars = reinterpret_cast<uint64_t*>(smem + (ring - s0) + GSTAGES * GSTAGE);
    const int t = blockIdx.x;
    int j = 0;
    while (j + 1 < J.n && J.tile0[j + 1] <= t) ++j;
    const int K = J.K[j], N = J.N[j];
    const int tn = (N + GBN - 1) / GBN, local = t - J.tile0[j];
    const int m0 = (local / tn) * GBM, n0 = (local % tn) * GBN;
    const int nb = min(4, (N - n0 + 63) / 64);          // 64-column boxes of dys
    const int p_begin = blockIdx.y * psplit, p_end = min(P_pad, p_begin + psplit);
    const int nsteps = (p_end - p_begin) / GBK;
    const int tid = threadIdx.x;
    if (tid == 0) {
        for (int i = 0; i < GSTAGES; ++i) {
            mbar_init(bars + i, 1);
            mbar_init(bars + GSTAGES + i, CONSUMERS / 32);
        }
        asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    }
    __syncthreads();
    if (tid >= CONSUMERS) {
        setmaxnreg_dec<PRODUCER_REGS>();
        if (tid < CONSUMERS + 32) {         // the producer warp, as the tile pass's
            const int lane = tid % 32;
            int slot = 0;
            uint32_t phase = 0;
            for (int s = 0; s < nsteps; ++s) {
                uint64_t* full = bars + slot;
                if (lane == 0) {
                    mbar_wait(bars + GSTAGES + slot, phase ^ 1);
                    mbar_expect_tx(full, (2 + nb) * GBOX);
                }
                __syncwarp();
                copy_stage(ring + slot * GSTAGE, &act_map, &dys_map, J.a_off[j] + m0,
                           J.y_off[j] + n0, p_begin + s * GBK, nb, full, lane);
                if (++slot == GSTAGES) { slot = 0; phase ^= 1; }
            }
        }
        return;
    }
    setmaxnreg_inc<CONSUMER_REGS>();

    // the first row tile of each job sums the bias (of the fp32 g for the
    // output layer, the last job)
    const bool bias = m0 == 0, bias_g = bias && j == J.n - 1;
    float bsum = 0.0f;
    float* dst = partial_w + (size_t)blockIdx.y * n_w + J.w_off[j];
    Ring rg{ring, bars, GSTAGES, GSTAGE, 0, 0, 0};
    switch (nb) {
#define K2W_DW(NB) \
        dw_consume<NB>(rg, smem, s0, nsteps, bias, bias_g, g, P, C, p_begin, dst, K, N, m0, n0, \
                       &bsum); \
        break;
        case 1: K2W_DW(1)
        case 2: K2W_DW(2)
        case 3: K2W_DW(3)
        default: K2W_DW(4)
#undef K2W_DW
    }
    if (bias && n0 + tid < (bias_g ? C : N))
        partial_b[(size_t)blockIdx.y * n_b + J.b_off[j] + n0 + tid] = bsum;
}

// ---- the host side ----------------------------------------------------------------------

// the driver's cuTensorMapEncodeTiled, through the runtime (no -lcuda)
inline PFN_cuTensorMapEncodeTiled_v12000 encoder() {
    static PFN_cuTensorMapEncodeTiled_v12000 fn = nullptr;
    if (!fn) {
        void* p = nullptr;
        cudaDriverEntryPointQueryResult q;
        if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &q)
                == cudaSuccess && q == cudaDriverEntryPointSuccess)
            fn = reinterpret_cast<PFN_cuTensorMapEncodeTiled_v12000>(p);
    }
    return fn;
}

// A 2-D tensor map of the bf16 matrix [rows, cols] (cols contiguous) at base,
// boxes of bc columns x br rows
inline bool encode(CUtensorMap* map, const void* base, int rows, int cols, int bc, int br,
                   CUtensorMapSwizzle swizzle) {
    const PFN_cuTensorMapEncodeTiled_v12000 fn = encoder();
    const cuuint64_t dims[2] = {(cuuint64_t)cols, (cuuint64_t)rows};
    const cuuint64_t strides[1] = {(cuuint64_t)cols * sizeof(bf16)};
    const cuuint32_t box[2] = {(cuuint32_t)bc, (cuuint32_t)br};
    const cuuint32_t unit[2] = {1, 1};
    return fn && fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, const_cast<void*>(base), dims,
                    strides, box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle,
                    CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE)
        == CUDA_SUCCESS;
}

// The plan of the tile pass over the packed weights w: its segments in the
// order the consumers take them (field.cu's plan_forward without the output
// layer, then plan_backward), each with its tensor map.
struct Planner {
    Plan p;
    const bf16* w;
    bool ok = true;
    explicit Planner(const bf16* wts) : w(wts) { p.n = 0; p.stages = 0; p.stage_bytes = 0; }
    // B = M[r0:r0+rows, :] of the [mrows, ldw] matrix at off: N-major slabs
    void fwd(int off, int mrows, int ldw, int r0, int rows) {
        add(off, mrows, ldw, Seg{rows, ldw, 0, 0, r0}, 64, KS, CU_TENSOR_MAP_SWIZZLE_128B);
    }
    // B = M[r0:r0+rows, :]^T: K-major slabs
    void bwd(int off, int mrows, int ldw, int r0, int rows) {
        add(off, mrows, ldw, Seg{ldw, rows, 1, 0, r0}, KS, rows, CU_TENSOR_MAP_SWIZZLE_64B);
    }
    void add(int off, int mrows, int ldw, Seg s, int bc, int br, CUtensorMapSwizzle swizzle) {
        if (p.n == MAXSEG) { ok = false; return; }
        ok = ok && encode(&p.map[p.n], w + off, mrows, ldw, bc, br, swizzle);
        p.s[p.n++] = s;
    }
};

inline void plan_tile(Planner& B, const Meta& m, bool need_x, bool need_d) {
    const int D = m.D, W = m.W, HW = m.W / 2, XP = m.XP, DP = m.DP, CP = m.CP;
    auto rows_of = [&](int i) { return i == 0 ? XP : (i == m.skip + 1 ? W + XP : W); };
    B.fwd(m.off_t[0], XP, W, 0, XP);
    for (int i = 1; i < D; ++i) {
        B.fwd(m.off_t[i], rows_of(i), W, 0, W);
        if (i == m.skip + 1) B.fwd(m.off_t[i], rows_of(i), W, W, XP);
    }
    B.fwd(m.off_rgbf, W, W, 0, W);
    B.fwd(m.off_rh, W + DP, HW, 0, W + DP);
    B.fwd(m.off_insf, W, W, 0, W);
    B.fwd(m.off_ih, W, HW, 0, W);
    B.bwd(m.off_out, 2 * W, CP, 0, HW);                         // d_rgb_h
    B.bwd(m.off_out, 2 * W, CP, HW, HW);                        // d_ins_h
    B.bwd(m.off_ih, W, HW, 0, W);                               // d_ins_f
    B.bwd(m.off_rh, W + DP, HW, 0, W);                          // d_rgb_f
    if (need_d) B.bwd(m.off_rh, W + DP, HW, W, DP);             // g_d
    B.bwd(m.off_out, 2 * W, CP, W, W);                          // d_h: density
    B.bwd(m.off_rgbf, W, W, 0, W);                              //      + rgb branch
    for (int i = D - 1; i >= 1; --i) {
        if (i == m.skip + 1 && need_x) B.bwd(m.off_t[i], rows_of(i), W, W, XP);   // g_x part
        B.bwd(m.off_t[i], rows_of(i), W, 0, W);
    }
    if (need_x) B.bwd(m.off_t[0], XP, W, 0, XP);
}

}  // namespace k2w
