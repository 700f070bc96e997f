// Device code that every field kernel shares: the packed-weight layout (Meta)
// and the in-kernel positional encoding. The matmul core is field_core.cuh,
// the tile forward field_tile.cuh.

#pragma once

#include <cuda_runtime.h>
#include <cuda_bf16.h>

typedef __nv_bfloat16 bf16;

namespace {

constexpr int MAXD = 16;               // deepest trunk the meta block describes

// Layout of the packed weights; filled from the int32 meta array that
// kernels/render_field.py::pack_field writes, in this field order.
struct Meta {
    int D, W, skip, XP, DP, CP, C, F, FV;
    int off_t[MAXD];                            // trunk matrices, elements of the weights
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

}  // namespace
