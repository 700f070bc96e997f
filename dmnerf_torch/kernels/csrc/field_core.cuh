// The matmul core of every field kernel (field.cu: K1 and both passes of K2;
// render_field.cu: K3, K4 and K5, through field_tile.cuh), in two builds
// chosen by the element type T of the weights and activations:
// - bf16: 128-point tiles on the tensor cores (mma.sync m16n8k16, operands by
//   ldmatrix), fp32 accumulation;
// - float: 64-point tiles on the tensor cores in three TF32 passes (mma.sync
//   m16n8k8 tf32, fp32 accumulation: the JAX kernels' compute_dtype
//   float32). Its tile is half as tall because a tile's activations take
//   twice the bytes, and the shared memory of a block holds H and Bf of 64
//   rows at width 256 beside the weight ring (the JAX package halves its f32
//   backward tile likewise). Its first design, fp32 FFMA on the CUDA cores
//   with each thread computing its fragment positions, sat at the shared
//   memory's rate: 4 FMAs per B word loaded, against 128 FFMA and 32 words a
//   clock per SM, 32-37% of the 67 TFLOP/s fp32 peak (PERF.md section 6).
//   The tensor cores take 8 B words per 64 multiply-adds a lane. Each
//   operand is split once in registers after its load, x = hi + lo with hi =
//   tf32(x) and lo = tf32(x - hi) (cvt.rna); per 8-deep step a zeroed
//   fragment takes lo_a hi_b, then hi_a lo_b, then hi_a hi_b, and one fp32
//   add takes it into the accumulator (mma_3xtf32). On the card the raw of
//   the flagship field is then within 9.3e-7 (rms, relative) of an f64
//   forward, against 7.9e-7 for the plain fp32 path; on the CPU the split
//   and the order, emulated, move it by 8.9e-7 of max(1, max |raw|) and the
//   gradients by 1.6e-6 relative L2, one TF32 pass by 1.1e-3 and 6.2e-2
//   (tests/test_torch_f32_split.py). K2's forward recompute alone sums in
//   order of k with fp32 FFMA (ffma_slab), so that its ReLU masks are the
//   plain path's.
// Both builds put every value in the same thread and register (the m16n8
// accumulator fragment of k16 bf16 and of k8 tf32 is one layout), so the
// epilogues, the ReLU mask bits and the tile forward are one code.
//
// - A block of THREADS = 512 threads (16 warps, at most 128 registers each)
//   owns TM<T> rows (points). For an output [TM, N], warp w computes MT<T>
//   16-row tiles from row 16 MT (w % WM) and every WN-th 8-column tile from
//   tile w / WM: fp32 accumulators in registers, each thread the values at
//   the positions of an m16n8 fragment. With WM x WN = 2 x 8 a bf16 warp
//   holds 64 rows, so each B fragment feeds 4 products and each A fragment
//   up to 4 (a 4 x 4 grid, 2 products per fragment, ran K1 slower: PERF.md
//   section 6 records the readings). Epilogues (bias, ReLU, bf16 rounding,
//   ReLU mask bits) run on those registers. Sixteen warps, four per
//   scheduler, hide the latency of the ldmatrix -> mma chains and of the
//   per-slab barrier.
// - Activations live in shared memory, rows padded by 16 bytes so that the 8
//   row addresses of one ldmatrix fall in distinct 16-byte bank groups. In
//   the float build ldmatrix moves 32-bit words: lane l receives the word at
//   row l/4, column l%4 of each 8 x 4-float matrix, which is the tf32 A
//   fragment (a0 (g, t), a1 (g+8, t), a2 (g, t+4), a3 (g+8, t+4)) and, from a
//   slab with k contiguous, the B fragment (b0 (k t, n g), b1 (k t+4, n g)).
// - The weights a block reads form a Plan: the ordered list of segments of
//   the packed matrices (kernels/render_field.py::pack_field) that its
//   matmuls consume. A segment is either W[r0:r0+rows, :] read as B (the
//   forward: reduction over rows) or the same rows read as B^T (the
//   backward: reduction over the columns, one output column per row). Both
//   come from the one packed layout: the backward's slabs are column blocks
//   of W and its fragments are ldmatrix without .trans, the forward's are row
//   blocks read with .trans (bf16) or, since .trans moves 16-bit elements
//   only, as two scalar words per lane and tile (float; its rows padded by 8
//   words so that a warp's rows t and columns g hit 32 distinct banks).
// - The ring cuts the plan into slabs of KSL reduction steps and keeps
//   STAGES - 1 of them in flight across matmul and layer boundaries (and,
//   for a block that walks several tiles, across tiles: the plan is read
//   once per tile): every thread walks the same plan, copies its share of
//   each slab with 16-byte cp.async, and one __syncthreads per slab both
//   publishes the slab and frees the stage that the next copy overwrites.
// - The weights are read once per tile from L2: per 128 points in bf16, per
//   64 in float.

#pragma once

#include <cstdint>

#include "field_common.cuh"

namespace core {

constexpr int WM = 2, WN = 8;          // the warp grid of a tile's output
constexpr int THREADS = WM * WN * 32;
constexpr int MAXW = 256;              // widest layer the register tiles hold
constexpr int NT = MAXW / 8 / WN;      // 8-column tiles per warp at N = MAXW
constexpr int MAXCP = MAXW / 2;        // widest output layer (4 + K + 1 padded to 16)
constexpr int NTO = (MAXCP / 8 + WN - 1) / WN;   // its 8-column tiles per warp
constexpr int MAXSEG = 56;

// per build: rows of a tile, 16-row tiles per warp, the padding of every
// shared-memory row (16 bytes) but a forward slab's (NPAD elements: 16 bytes
// in bf16, 8 words in float), mask words per thread at N = MAXW
template <class T> constexpr int TM = sizeof(T) == 2 ? 128 : 64;
template <class T> constexpr int MT = TM<T> / WM / 16;
template <class T> constexpr int SPAD = 16 / sizeof(T);
constexpr int NPAD = 8;
template <class T> constexpr int MW = NT * MT<T> * 4 / 32;

__device__ __forceinline__ float to_float(bf16 v) { return __bfloat162float(v); }
__device__ __forceinline__ float to_float(float v) { return v; }
template <class T> __device__ __forceinline__ T from_float(float v);
template <> __device__ __forceinline__ bf16 from_float<bf16>(float v) {
    return __float2bfloat16_rn(v);
}
template <> __device__ __forceinline__ float from_float<float>(float v) { return v; }

// One segment of the weight plan (element offsets into the packed weights).
// trans 0: B = W[r0:r0+rows, 0:ldw], reduction over the rows, ldw outputs.
// trans 1: B = W[r0:r0+rows, 0:ldw]^T, reduction over ldw, rows outputs.
struct Seg {
    int w_off, ldw, r0, rows, trans;
};

struct Plan {
    int n;                 // segments
    int stage_elems;       // elements of one ring stage (the largest slab)
    Seg s[MAXSEG];
};

__host__ __device__ inline int seg_red(const Seg& s) { return s.trans ? s.ldw : s.rows; }
__host__ __device__ inline int seg_out(const Seg& s) { return s.trans ? s.rows : s.ldw; }

// ---- PTX ----------------------------------------------------------------------

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
    return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(smem_u32(dst)), "l"(src));
}

// 16 bytes, or 16 zero bytes when !valid (src is then not read)
__device__ __forceinline__ void cp_async16_zfill(void* dst, const void* src, bool valid) {
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
                 ::"r"(smem_u32(dst)), "l"(src), "r"(valid ? 16 : 0));
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }

template <int N>
__device__ __forceinline__ void cp_async_wait() {
    asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const void* p) {
    asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
                 : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(smem_u32(p)));
}

__device__ __forceinline__ void ldsm_x4_t(uint32_t (&r)[4], const void* p) {
    asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
                 : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(smem_u32(p)));
}

__device__ __forceinline__ void ldsm_x2(uint32_t& r0, uint32_t& r1, const void* p) {
    asm volatile("ldmatrix.sync.aligned.m8n8.x2.shared.b16 {%0,%1}, [%2];\n"
                 : "=r"(r0), "=r"(r1) : "r"(smem_u32(p)));
}

__device__ __forceinline__ void ldsm_x2_t(uint32_t& r0, uint32_t& r1, const void* p) {
    asm volatile("ldmatrix.sync.aligned.m8n8.x2.trans.shared.b16 {%0,%1}, [%2];\n"
                 : "=r"(r0), "=r"(r1) : "r"(smem_u32(p)));
}

// d += a (16x16, row) @ b (16x8, col), bf16 in, fp32 accumulate
__device__ __forceinline__ void mma16816(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
    asm volatile("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
                 "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
                 : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
                 : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// d += a (16x8, row) @ b (8x8, col), tf32 in, fp32 accumulate
__device__ __forceinline__ void mma1688(float (&d)[4], const uint32_t (&a)[4],
                                        const uint32_t (&b)[2]) {
    asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
        "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// x (fp32 bits) = hi + lo, each rounded to tf32 (to nearest, ties away from
// zero); x - hi is exact in fp32
__device__ __forceinline__ void split_tf32(uint32_t x, uint32_t& hi, uint32_t& lo) {
    asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(hi) : "f"(__uint_as_float(x)));
    const float rest = __uint_as_float(x) - __uint_as_float(hi);
    asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(lo) : "f"(rest));
}

template <int N>
__device__ __forceinline__ void split_tf32(const uint32_t (&x)[N], uint32_t (&hi)[N],
                                           uint32_t (&lo)[N]) {
#pragma unroll
    for (int i = 0; i < N; ++i) split_tf32(x[i], hi[i], lo[i]);
}

// d += a b in three TF32 passes (a = ah + al, b = bh + bl), the small
// products first, into a zeroed fragment that one fp32 add (round to
// nearest) takes into d: the tensor cores' own accumulation truncates, so
// three passes straight into d would lose ~1 ulp of the running sum per
// mma, 1.5e-5 of the raw's scale (rms) at the flagship field on the card.
__device__ __forceinline__ void mma_3xtf32(float (&d)[4], const uint32_t (&ah)[4],
                                           const uint32_t (&al)[4], const uint32_t (&bh)[2],
                                           const uint32_t (&bl)[2]) {
    float t[4] = {0.0f, 0.0f, 0.0f, 0.0f};
    mma1688(t, al, bh);
    mma1688(t, ah, bl);
    mma1688(t, ah, bh);
#pragma unroll
    for (int c = 0; c < 4; ++c) d[c] += t[c];
}

// ---- the weight ring ------------------------------------------------------------

// elements of one slab of s in a ring of KSL-step slabs
template <class T>
__host__ __device__ inline int slab_elems(const Seg& s, int ksl) {
    return s.trans ? s.rows * (ksl + SPAD<T>) : ksl * (s.ldw + NPAD);
}

// LAPS: the block consumes the plan once per tile of several (K3/K4/K5), and
// the producer runs on into the next pass while the last slabs of one are
// consumed.
template <class T, int STAGES, int KSL, bool LAPS = false>
struct Ring {
    static constexpr int EPC = 16 / sizeof(T);   // elements per 16-byte copy
    T* base;               // STAGES * plan.stage_elems elements of shared memory
    const Plan* plan;
    const T* w;            // packed weights (global)
    int t;                 // slabs consumed
    int cseg;              // consumer's segment
    int pseg, pslab;       // producer's next slab
    int laps;              // LAPS: passes through the plan the producer has not finished

    __device__ __forceinline__ T* stage(int i) const { return base + i * plan->stage_elems; }

    // copy the producer's next slab into stage i (every thread its share),
    // and commit a cp.async group (an empty one past the end of the plan)
    __device__ __forceinline__ void fetch(int i) {
        if (pseg < plan->n) {
            const Seg s = plan->s[pseg];
            T* dst = stage(i);
            const int red = seg_red(s), k0 = pslab * KSL, ks = min(KSL, red - k0);
            if (!s.trans) {            // rows r0+k0 .. +ks, every column -> [ks][ldw+NPAD]
                const int cpr = s.ldw / EPC, ld = s.ldw + NPAD;
                const T* src = w + s.w_off + (size_t)(s.r0 + k0) * s.ldw;
                for (int c = threadIdx.x; c < ks * cpr; c += THREADS) {
                    const int r = c / cpr, col = (c % cpr) * EPC;
                    cp_async16(dst + r * ld + col, src + (size_t)r * s.ldw + col);
                }
            } else {                   // every row, columns k0 .. +ks -> [rows][KSL+SPAD]
                const int cpr = ks / EPC;
                const T* src = w + s.w_off + (size_t)s.r0 * s.ldw + k0;
                for (int c = threadIdx.x; c < s.rows * cpr; c += THREADS) {
                    const int r = c / cpr, col = (c % cpr) * EPC;
                    cp_async16(dst + r * (KSL + SPAD<T>) + col, src + (size_t)r * s.ldw + col);
                }
            }
            if (++pslab * KSL >= red) {
                pslab = 0;
                if (++pseg == plan->n && LAPS && --laps > 0) pseg = 0;
            }
        }
        cp_async_commit();
    }

    // n_laps (LAPS): how many times the block consumes the plan
    __device__ __forceinline__ void start(T* smem_base, const Plan* p, const T* wts,
                                          int n_laps = 1) {
        base = smem_base; plan = p; w = wts;
        t = cseg = pseg = pslab = 0;
        laps = n_laps;
#pragma unroll
        for (int i = 0; i < STAGES - 1; ++i) fetch(i);
    }

    // the next slab, landed and visible to every thread; its predecessor's
    // stage is refilled with the slab STAGES - 1 ahead
    __device__ __forceinline__ const T* acquire() {
        cp_async_wait<STAGES - 2>();
        __syncthreads();
        fetch((t + STAGES - 1) % STAGES);
        return stage(t++ % STAGES);
    }

    // the consumer's next segment (LAPS: the plan again after its end)
    __device__ __forceinline__ Seg next_seg() {
        const Seg s = plan->s[cseg++];
        if (LAPS && cseg == plan->n) cseg = 0;
        return s;
    }
};

// ---- the warp tile ----------------------------------------------------------------

// a warp's accumulators: MT row tiles x N 8-column tiles x 4 fp32
template <class T, int N>
using AccT = float[MT<T>][N][4];
template <class T>
using Acc = AccT<T, NT>;

template <int M, int N>
__device__ __forceinline__ void zero(float (&acc)[M][N][4]) {
#pragma unroll
    for (int mi = 0; mi < M; ++mi)
#pragma unroll
        for (int j = 0; j < N; ++j)
#pragma unroll
            for (int c = 0; c < 4; ++c) acc[mi][j][c] = 0.0f;
}

// This warp's place in the WM x WN warp grid of an output [TM, n]: rows
// row0(mt) ... +16 mt (mt 16-row tiles per warp), and the 8-column tiles wn,
// wn + WN, wn + 2 WN, ... (tiles() of them), so every width that is a
// multiple of 16 spreads over the warps.
__device__ __forceinline__ int warp_n() { return threadIdx.x / 32 / WM; }
__device__ __forceinline__ int row0(int mt) { return (threadIdx.x / 32 % WM) * 16 * mt; }
__device__ __forceinline__ int tiles(int n) { return (n / 8 - warp_n() + WN - 1) / WN; }

// One 16-deep reduction step over exactly X of this warp's tiles,
// branch-free so that the B fragment loads (two tiles per ldmatrix.x4) run
// ahead of the products. bp is this lane's address for tile pair 0 (lanes
// 16-31 already one tile on); tstep the element step from a tile to the next.
template <int X, bool TRANS, int M, int N>
__device__ __forceinline__ void k16_exact(float (&acc)[M][N][4], const uint32_t (&a)[M][4],
                                          const bf16* bp, int tstep) {
#pragma unroll
    for (int j = 0; j + 1 < X; j += 2) {
        uint32_t b[4];
        if (TRANS) ldsm_x4(b, bp + j * tstep);
        else ldsm_x4_t(b, bp + j * tstep);
#pragma unroll
        for (int mi = 0; mi < M; ++mi) {
            mma16816(acc[mi][j], a[mi], b[0], b[1]);
            mma16816(acc[mi][j + 1], a[mi], b[2], b[3]);
        }
    }
    if (X % 2) {
        uint32_t b0, b1;
        if (TRANS) ldsm_x2(b0, b1, bp + (X - 1) * tstep);
        else ldsm_x2_t(b0, b1, bp + (X - 1) * tstep);
#pragma unroll
        for (int mi = 0; mi < M; ++mi) mma16816(acc[mi][X - 1], a[mi], b0, b1);
    }
}

// The same for nt tiles known only at run time (every count up to N has its
// branch-free body).
template <bool TRANS, int M, int N>
__device__ __forceinline__ void k16(float (&acc)[M][N][4], int nt, const uint32_t (&a)[M][4],
                                    const bf16* bp, int tstep) {
    switch (nt) {
        case 8: if constexpr (N >= 8) k16_exact<8, TRANS>(acc, a, bp, tstep); break;
        case 7: if constexpr (N >= 7) k16_exact<7, TRANS>(acc, a, bp, tstep); break;
        case 6: if constexpr (N >= 6) k16_exact<6, TRANS>(acc, a, bp, tstep); break;
        case 5: if constexpr (N >= 5) k16_exact<5, TRANS>(acc, a, bp, tstep); break;
        case 4: if constexpr (N >= 4) k16_exact<4, TRANS>(acc, a, bp, tstep); break;
        case 3: if constexpr (N >= 3) k16_exact<3, TRANS>(acc, a, bp, tstep); break;
        case 2: if constexpr (N >= 2) k16_exact<2, TRANS>(acc, a, bp, tstep); break;
        case 1: k16_exact<1, TRANS>(acc, a, bp, tstep); break;
        default: break;
    }
}

// K2's forward recompute in the float build: acc += A[:, kbase:kbase+ks] @
// B for a forward slab st ([ks][ld]), 4 reduction steps at a time, each
// value summed in order of k by fp32 FFMA at this thread's fragment
// positions (rows r + 16 mi + 8 h, columns c + 8 WN j + {0, 1}). Its ReLU
// masks are then those of an fp32 GEMM that sums in order of k, as the
// plain path's does; three TF32 passes, as fp32-accurate as that GEMM but
// rounded elsewhere, flip the masks of points whose pre-activations lie
// within ~1e-5 of zero, and each flip moves a layer's whole gradient
// (PERF.md section 6).
template <int M, int N>
__device__ __forceinline__ void ffma_slab(float (&acc)[M][N][4], int nt, const float* A,
                                          int lda, int kbase, int ks, const float* st, int ld) {
    const int lane = threadIdx.x % 32;
    const int r = row0(M) + lane / 4, c = warp_n() * 8 + 2 * (lane % 4);
    for (int kk = 0; kk < ks; kk += 4) {
        float4 a[M][2];
#pragma unroll
        for (int mi = 0; mi < M; ++mi)
#pragma unroll
            for (int h = 0; h < 2; ++h)
                a[mi][h] = *reinterpret_cast<const float4*>(
                    A + (r + mi * 16 + h * 8) * lda + kbase + kk);
#pragma unroll
        for (int j = 0; j < N; ++j) {
            if (j < nt) {
                const int cj = c + j * 8 * WN;
                float b[2][4];          // B[kk + q][cj + e] = b[e][q]
#pragma unroll
                for (int q = 0; q < 4; ++q) {
                    const float2 v = *reinterpret_cast<const float2*>(st + (kk + q) * ld + cj);
                    b[0][q] = v.x; b[1][q] = v.y;
                }
#pragma unroll
                for (int mi = 0; mi < M; ++mi)
#pragma unroll
                    for (int h = 0; h < 2; ++h) {
                        const float av[4] = {a[mi][h].x, a[mi][h].y, a[mi][h].z, a[mi][h].w};
#pragma unroll
                        for (int e = 0; e < 2; ++e)
#pragma unroll
                            for (int q = 0; q < 4; ++q)
                                acc[mi][j][2 * h + e] = fmaf(av[q], b[e][q], acc[mi][j][2 * h + e]);
                    }
            }
        }
    }
}

// The float build's 8-deep reduction step over exactly X of this warp's
// tiles, branch-free like k16_exact: the A fragments come split (ah + al),
// each B fragment is split as it loads. TRANS: by ldmatrix, as k16_exact;
// else b0 and b1 are words bp[j tstep] and bp[j tstep + kstep] (this lane's
// rows t and t + 4, column g).
template <int X, bool TRANS, int M, int N>
__device__ __forceinline__ void k8_exact(float (&acc)[M][N][4], const uint32_t (&ah)[M][4],
                                         const uint32_t (&al)[M][4], const float* bp, int tstep,
                                         int kstep) {
    const uint32_t* bw = reinterpret_cast<const uint32_t*>(bp);
#pragma unroll
    for (int j = 0; j < X; j += 2) {
        uint32_t b[2][2], bh[2][2], bl[2][2];
        const int n = j + 1 < X ? 2 : 1;
        if (TRANS && n == 2) {
            uint32_t r[4];
            ldsm_x4(r, bp + j * tstep);
            b[0][0] = r[0]; b[0][1] = r[1]; b[1][0] = r[2]; b[1][1] = r[3];
        } else if (TRANS) {
            ldsm_x2(b[0][0], b[0][1], bp + j * tstep);
        } else {
#pragma unroll
            for (int q = 0; q < n; ++q) {
                b[q][0] = bw[(j + q) * tstep];
                b[q][1] = bw[(j + q) * tstep + kstep];
            }
        }
#pragma unroll
        for (int q = 0; q < n; ++q) {
            split_tf32(b[q], bh[q], bl[q]);
#pragma unroll
            for (int mi = 0; mi < M; ++mi) mma_3xtf32(acc[mi][j + q], ah[mi], al[mi], bh[q], bl[q]);
        }
    }
}

// The same for nt tiles known only at run time.
template <bool TRANS, int M, int N>
__device__ __forceinline__ void k8(float (&acc)[M][N][4], int nt, const uint32_t (&ah)[M][4],
                                   const uint32_t (&al)[M][4], const float* bp, int tstep,
                                   int kstep) {
    switch (nt) {
        case 8: if constexpr (N >= 8) k8_exact<8, TRANS>(acc, ah, al, bp, tstep, kstep); break;
        case 7: if constexpr (N >= 7) k8_exact<7, TRANS>(acc, ah, al, bp, tstep, kstep); break;
        case 6: if constexpr (N >= 6) k8_exact<6, TRANS>(acc, ah, al, bp, tstep, kstep); break;
        case 5: if constexpr (N >= 5) k8_exact<5, TRANS>(acc, ah, al, bp, tstep, kstep); break;
        case 4: if constexpr (N >= 4) k8_exact<4, TRANS>(acc, ah, al, bp, tstep, kstep); break;
        case 3: if constexpr (N >= 3) k8_exact<3, TRANS>(acc, ah, al, bp, tstep, kstep); break;
        case 2: if constexpr (N >= 2) k8_exact<2, TRANS>(acc, ah, al, bp, tstep, kstep); break;
        case 1: k8_exact<1, TRANS>(acc, ah, al, bp, tstep, kstep); break;
        default: break;
    }
}

// acc += A [TM, red] (shared, ld lda) @ B, B the plan's next segment, over
// its first min(seg_out, ncols) columns, of which this warp holds tiles(.) <=
// N tiles. KORDER (K2's forward recompute, forward segments only): the
// float build sums in order of k on the CUDA cores (ffma_slab).
template <bool KORDER = false, class T, int STAGES, int KSL, bool LAPS, int M, int N>
__device__ __forceinline__ void run_seg(Ring<T, STAGES, KSL, LAPS>& R, float (&acc)[M][N][4],
                                        const T* A, int lda, int ncols = MAXW) {
    const Seg s = R.next_seg();
    const int red = seg_red(s), nt = tiles(min(seg_out(s), ncols));
    const int ldt = KSL + SPAD<T>, ldn = s.ldw + NPAD;
    if constexpr (sizeof(T) == 2) {
        const int lane = threadIdx.x % 32, c0 = warp_n() * 8;
        const bf16* arow = A + (row0(M) + (lane & 15)) * lda + (lane >> 4) * 8;
        // this lane's ldmatrix row of B for tile pair 0 at reduction step 0
        const int boff = s.trans
            ? (c0 + (lane & 7) + ((lane >> 4) & 1) * 8 * WN) * ldt + ((lane >> 3) & 1) * 8
            : (lane & 15) * ldn + c0 + (lane >> 4) * 8 * WN;
        for (int k0 = 0; k0 < red; k0 += KSL) {
            const bf16* st = R.acquire() + boff;
            const int ks = min(KSL, red - k0);
            for (int kk = 0; kk < ks; kk += 16) {
                uint32_t a[M][4];
#pragma unroll
                for (int mi = 0; mi < M; ++mi) ldsm_x4(a[mi], arow + mi * 16 * lda + k0 + kk);
                if (s.trans) k16<true>(acc, nt, a, st + kk, 8 * WN * ldt);
                else k16<false>(acc, nt, a, st + kk * ldn, 8 * WN);
            }
        }
    } else if constexpr (KORDER) {
        for (int k0 = 0; k0 < red; k0 += KSL) {
            const float* st = R.acquire();
            ffma_slab(acc, nt, A, lda, k0, min(KSL, red - k0), st, ldn);
        }
    } else {
        // the same lanes and steps in 32-bit words: 8-deep k steps, A and
        // trans B by ldmatrix (4 words a row), forward B as scalar words
        const int lane = threadIdx.x % 32, c0 = warp_n() * 8;
        const float* arow = A + (row0(M) + (lane & 15)) * lda + (lane >> 4) * 4;
        const int boff = s.trans
            ? (c0 + (lane & 7) + ((lane >> 4) & 1) * 8 * WN) * ldt + ((lane >> 3) & 1) * 4
            : (lane % 4) * ldn + c0 + lane / 4;
        for (int k0 = 0; k0 < red; k0 += KSL) {
            const float* st = R.acquire() + boff;
            const int ks = min(KSL, red - k0);
            for (int kk = 0; kk < ks; kk += 8) {
                uint32_t a[M][4], ah[M][4], al[M][4];
#pragma unroll
                for (int mi = 0; mi < M; ++mi) {
                    ldsm_x4(a[mi], arow + mi * 16 * lda + k0 + kk);
                    split_tf32(a[mi], ah[mi], al[mi]);
                }
                if (s.trans) k8<true>(acc, nt, ah, al, st + kk, 8 * WN * ldt, 0);
                else k8<false>(acc, nt, ah, al, st + kk * ldn, 8 * WN, 4 * ldn);
            }
        }
    }
}

// f(row, col, v0, v1, bit) for every pair of adjacent columns (col even) of
// this warp's accumulators of an output with n columns; bit is the pair's
// first bit in this thread's mask words (the second is bit + 1).
template <int M, int N, class F>
__device__ __forceinline__ void for_pairs(float (&acc)[M][N][4], int n, F f) {
    const int lane = threadIdx.x % 32, nt = tiles(n);
    const int r0 = row0(M) + lane / 4;
    const int c0 = warp_n() * 8 + 2 * (lane % 4);
#pragma unroll
    for (int j = 0; j < N; ++j) {
        if (j < nt) {
#pragma unroll
            for (int mi = 0; mi < M; ++mi) {
#pragma unroll
                for (int h = 0; h < 2; ++h) {
                    f(r0 + mi * 16 + h * 8, c0 + j * 8 * WN, acc[mi][j][2 * h],
                      acc[mi][j][2 * h + 1], (j * M + mi) * 4 + 2 * h);
                }
            }
        }
    }
}

// a pair of adjacent values stored as T; returns what was stored
__device__ __forceinline__ float2 st_pair(bf16* p, float a, float b) {
    const __nv_bfloat162 o = __floats2bfloat162_rn(a, b);
    *reinterpret_cast<__nv_bfloat162*>(p) = o;
    return make_float2(__bfloat162float(o.x), __bfloat162float(o.y));
}
__device__ __forceinline__ float2 st_pair(float* p, float a, float b) {
    const float2 o = make_float2(a, b);
    *reinterpret_cast<float2*>(p) = o;
    return o;
}

// mask words a thread keeps for an output of n columns (one bit per value)
__device__ __forceinline__ int mask_words(int n, int mt) { return (tiles(n) * mt * 4 + 31) / 32; }

// Epilogue: dst[r, c] = T(relu?(acc + bias[c])) over n columns and, if mask
// is non-null, the bits (stored value > 0) into this thread's words
// mask[w * THREADS] (w < mask_words(n) <= MW).
template <int M, class T>
__device__ __forceinline__ void store_act(float (&acc)[M][NT][4], int n,
                                          const float* __restrict__ bias, bool relu, T* dst,
                                          int ldd, uint32_t* mask) {
    constexpr int NW = NT * M * 4 / 32;
    uint32_t words[NW] = {};
    for_pairs(acc, n, [&](int r, int c, float v0, float v1, int bit) {
        const float2 bb = *reinterpret_cast<const float2*>(bias + c);
        v0 += bb.x;
        v1 += bb.y;
        if (relu) { v0 = fmaxf(v0, 0.0f); v1 = fmaxf(v1, 0.0f); }
        const float2 o = st_pair(dst + r * ldd + c, v0, v1);
        if (o.x > 0.0f) words[bit / 32] |= 1u << (bit % 32);
        if (o.y > 0.0f) words[bit / 32] |= 1u << (bit % 32 + 1);
    });
    if (mask) {
        const int nw = mask_words(n, M);
#pragma unroll
        for (int i = 0; i < NW; ++i)
            if (i < nw) mask[i * THREADS + threadIdx.x] = words[i];
    }
}

// Epilogue of a backward matmul: dst[r, c] = T(acc * relu'(saved)) over n
// columns, the mask words as store_act wrote them (mask null: no ReLU).
template <int M, class T>
__device__ __forceinline__ void store_grad(float (&acc)[M][NT][4], int n, T* dst, int ldd,
                                           const uint32_t* mask) {
    constexpr int NW = NT * M * 4 / 32;
    uint32_t words[NW];
#pragma unroll
    for (int i = 0; i < NW; ++i) words[i] = ~0u;
    if (mask) {
        const int nw = mask_words(n, M);
#pragma unroll
        for (int i = 0; i < NW; ++i)
            if (i < nw) words[i] = mask[i * THREADS + threadIdx.x];
    }
    for_pairs(acc, n, [&](int r, int c, float v0, float v1, int bit) {
        const uint32_t wd = words[bit / 32];
        st_pair(dst + r * ldd + c, (wd >> (bit % 32)) & 1u ? v0 : 0.0f,
                (wd >> (bit % 32 + 1)) & 1u ? v1 : 0.0f);
    });
}

// ---- bulk stores of a tile's rows (K2's scratch) ---------------------------------

// [TM, ncols] of T from shared memory (ld lds) to global rows (ld ldg): one
// asynchronous bulk copy per row (cp.async.bulk, the TMA's 1-D form), started
// by threads 0 .. TM-1, so the copies overlap the next matmul. ncols, lds,
// ldg and both column offsets are multiples of 16 bytes. Call after publish().
template <class T>
__device__ __forceinline__ void store_rows(const T* src, int lds, int ncols, T* dst, int ldg) {
    if (threadIdx.x < TM<T>) {
        asm volatile("cp.async.bulk.global.shared::cta.bulk_group [%0], [%1], %2;\n"
                     ::"l"(dst + (size_t)threadIdx.x * ldg),
                     "r"(smem_u32(src + threadIdx.x * lds)), "r"(ncols * (int)sizeof(T))
                     : "memory");
        asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
    }
}

// Every thread's shared-memory writes so far, visible to the bulk copies.
__device__ __forceinline__ void publish() {
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    __syncthreads();
}

// A barrier after which shared memory may be written again: every bulk copy
// has finished reading its rows.
__device__ __forceinline__ void sync_write() {
    asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
    __syncthreads();
}

// The bulk copies' writes complete (before the block exits).
__device__ __forceinline__ void drain_stores() {
    asm volatile("cp.async.bulk.wait_group 0;\n" ::: "memory");
}

}  // namespace core
