// bfloat16 vectors for the kernels built on them (the _bf16 entries).
//
// cgx keeps bfloat16 vectors in the vectors' dtype wherever its kernels do
// (band products and their sum, x + alpha p, r - alpha Ap, p, ...): each
// operation rounds to bfloat16. cgx::bf16 stores 16 bits and does each
// operation in float, rounding to nearest even with __float2bfloat16_rn right
// after it, so a kernel templated on the vector type runs the plain torch
// version's arithmetic on bfloat16 tensors bit for bit: torch also computes a
// bfloat16 operation in float and rounds once. It uses no bfloat16 intrinsic
// that fuses two operations (__hfma2, __hmul2), which round once for two, and
// none that rounds the exact result straight to bfloat16 (torch rounds through
// float: a sum a hair off a bfloat16 midpoint can round otherwise). A double
// rounds through float too, as torch's .to(torch.bfloat16) does.
//
// Dots: prod64(a, b) is the product a dot sums, exact in double for every
// vector type (a product of two bfloat16 needs 16 bits). cgx's kernels round a
// bfloat16 product to bfloat16 before they widen it ((p * ap).astype(float32));
// on the streaming recurrence that loses the Chronopoulos-Gear denominator's
// digits (lap2d_fd(48) at 5e-2 ||b||: 117 iterations to a NaN, against 62 with
// exact products, the plain pipelined loop's count), so the port keeps the float
// kernels' exact products here too.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstring>

namespace cgx {

struct bf16 {
  unsigned short bits;
  bf16() = default;
  __device__ __forceinline__ explicit bf16(float f)
      : bits(__bfloat16_as_ushort(__float2bfloat16_rn(f))) {}
  __device__ __forceinline__ explicit bf16(double d) : bf16(static_cast<float>(d)) {}
  __device__ __forceinline__ explicit bf16(int i) : bf16(static_cast<float>(i)) {}
  __device__ __forceinline__ explicit operator float() const {
    return __bfloat162float(__ushort_as_bfloat16(bits));
  }
  __device__ __forceinline__ explicit operator double() const {
    return static_cast<double>(static_cast<float>(*this));
  }
};
static_assert(sizeof(bf16) == 2, "bf16 is 16 bits");

// A scalar the host hands a kernel in the vectors' type (the s-step basis's
// theta, delta and shifts): static_cast, and for bfloat16 the device
// constructor's rounding done on the host, through float to nearest even.
template <typename T>
inline T host_scalar(double d) {
  return static_cast<T>(d);
}
template <>
inline bf16 host_scalar<bf16>(double d) {
  const float f = static_cast<float>(d);
  unsigned int u;
  memcpy(&u, &f, sizeof(u));
  bf16 out;
  out.bits = (u & 0x7fffffffu) > 0x7f800000u
                 ? static_cast<unsigned short>(0x7fc0u)  // NaN
                 : static_cast<unsigned short>((u + 0x7fffu + ((u >> 16) & 1u)) >> 16);
  return out;
}

__device__ __forceinline__ bf16 operator+(bf16 a, bf16 b) {
  return bf16(static_cast<float>(a) + static_cast<float>(b));
}
__device__ __forceinline__ bf16 operator-(bf16 a, bf16 b) {
  return bf16(static_cast<float>(a) - static_cast<float>(b));
}
__device__ __forceinline__ bf16 operator*(bf16 a, bf16 b) {
  return bf16(static_cast<float>(a) * static_cast<float>(b));
}
__device__ __forceinline__ bf16 operator/(bf16 a, bf16 b) {
  return bf16(static_cast<float>(a) / static_cast<float>(b));
}
__device__ __forceinline__ bf16& operator+=(bf16& a, bf16 b) { return a = a + b; }
__device__ __forceinline__ bf16& operator-=(bf16& a, bf16 b) { return a = a - b; }

// The product a dot sums, in double (see the note above).
template <typename T>
__device__ __forceinline__ double prod64(T a, T b) {
  return static_cast<double>(a) * b;
}
template <>
__device__ __forceinline__ double prod64<bf16>(bf16 a, bf16 b) {
  return static_cast<double>(a) * static_cast<double>(b);
}

// A load through L2 only (ld.global.cg), for values other blocks rewrite.
template <typename T>
__device__ __forceinline__ T ldcg(const T* p) {
  return __ldcg(p);
}
template <>
__device__ __forceinline__ bf16 ldcg<bf16>(const bf16* p) {
  bf16 v;
  v.bits = __ldcg(reinterpret_cast<const unsigned short*>(p));
  return v;
}

// The type a kernel sums a dense row in: float for bfloat16 vectors (B3 rounds
// once, at the store), else the vectors' own.
template <typename T>
struct Acc {
  using type = T;
};
template <>
struct Acc<bf16> {
  using type = float;
};

}  // namespace cgx
