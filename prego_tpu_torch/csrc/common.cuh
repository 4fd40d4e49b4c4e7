// Shared helpers for the port's hand-written Hopper kernels.
//
// Every library built from this directory exposes a plain C interface:
// pointers and the stream arrive as void*, sizes as int, and each entry
// point returns the cudaError_t of its launches as an int (0 = success),
// so the Python wrapper can raise on a launch the driver refused.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#define PREGO_EXPORT extern "C" __attribute__((visibility("default")))

// An argument the kernel cannot take; returned before any launch.
constexpr int PREGO_BAD_ARGUMENT = 9001;

__device__ __forceinline__ float bf2f(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ __nv_bfloat16 f2bf(float x) { return __float2bfloat16(x); }

// Round a float through bf16 and back (the cast a bf16 operand goes
// through before an f32-accumulated product).
__device__ __forceinline__ float round_bf16(float x) { return bf2f(f2bf(x)); }

// Two packed bf16 values -> float2 (low half first, as they sit in memory).
__device__ __forceinline__ float2 bf16x2_to_float2(unsigned int raw) {
    __nv_bfloat162 v = *reinterpret_cast<__nv_bfloat162*>(&raw);
    return __bfloat1622float2(v);
}

// Four packed int8 values -> four floats, exactly (low byte first). Each
// byte, its sign bit flipped, becomes the low mantissa byte of 2^23, so
// the float is 2^23 + 128 + b; one subtraction leaves b. A byte permute
// and an add a value, both issued at a multiple of the rate of a plain
// int-to-float conversion.
__device__ __forceinline__ void int8x4_to_float(unsigned int raw, float* out) {
    const unsigned int u = raw ^ 0x80808080u;
#pragma unroll
    for (int i = 0; i < 4; ++i)
        out[i] = __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7650 + i)) - 8388736.f;
}

// Rows r0..r3 of 4 int8 columns -> w[j] = the 4 rows of column j, low
// byte first: 4 consecutive k of a column in one word, as __dp4a takes them.
__device__ __forceinline__ void transpose4x4(unsigned int r0, unsigned int r1, unsigned int r2,
                                             unsigned int r3, unsigned int* w) {
    const unsigned int a_lo = __byte_perm(r0, r1, 0x5140), a_hi = __byte_perm(r0, r1, 0x7362);
    const unsigned int b_lo = __byte_perm(r2, r3, 0x5140), b_hi = __byte_perm(r2, r3, 0x7362);
    w[0] = __byte_perm(a_lo, b_lo, 0x5410);
    w[1] = __byte_perm(a_lo, b_lo, 0x7632);
    w[2] = __byte_perm(a_hi, b_hi, 0x5410);
    w[3] = __byte_perm(a_hi, b_hi, 0x7632);
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
    return v;
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, off));
    return v;
}

// Each library is built from one .cu file, so this definition appears once
// per shared object.
PREGO_EXPORT const char* prego_error_string(int err) {
    if (err == PREGO_BAD_ARGUMENT) return "argument the kernel does not take";
    return cudaGetErrorString(static_cast<cudaError_t>(err));
}
