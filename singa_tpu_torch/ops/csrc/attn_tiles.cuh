// Device building blocks shared by the flash-attention kernels
// (flash_fwd.cu, flash_bwd.cu): 16-byte asynchronous tile copies into
// shared memory, warp-level tensor-core products (mma.sync) with their
// operand fragments, the precision splits and the causal live-tile bounds.
//
// Fragment layouts are those of the PTX ISA for mma.sync; with
// g = lane / 4 and t = lane % 4 a thread holds, of a 16x8 fp32
// accumulator C, the elements (g, 2t), (g, 2t+1), (g+8, 2t), (g+8, 2t+1)
// as c[0..3].
//
// Products, by operand type:
// - TF32X3 (fp32 operands, fp32 accuracy): m16n8k8 TF32 MMAs on the split
//   x = hi + lo, hi = tf32_rna(x), lo = tf32_rna(x - hi), summing
//   a_lo*b_hi + a_hi*b_lo + a_hi*b_hi in fp32 (three passes; the lo*lo
//   term is below fp32's last bit).
// - BF16: m16n8k16 bf16 MMAs with fp32 accumulation. fp32 operands are
//   rounded to bf16 (round to nearest even) as their fragments are formed.
//
// The accumulator of S = A.B^T is reused as the A operand of the next
// product P.V without leaving registers. For BF16 its layout is the
// A layout itself. For TF32 the A operand wants columns t and t+4 where C
// holds 2t and 2t+1, so the eight keys of a k-step are taken in the order
// (0, 2, 4, 6, 1, 3, 5, 7): the A slot t is key 2t, the slot t+4 key
// 2t+1, and the B fragment is read from the same keys. The sum is over
// the same terms in a fixed order, so no shuffle is needed.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace attn {

constexpr float NEG = -1e30f;  // the reference's _NEG

enum Mode { TF32X3 = 0, BF16 = 1 };

// ---- element conversions -------------------------------------------------

// two adjacent outputs (columns c, c+1) in the output dtype
__device__ __forceinline__ void store2(float* p, float x0, float x1) {
  *reinterpret_cast<float2*>(p) = make_float2(x0, x1);
}
__device__ __forceinline__ void store2(__nv_bfloat16* p, float x0,
                                       float x1) {
  // round to nearest even, as astype does
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(x0, x1);
}

// (x0, x1) as one bf16x2 register, x0 in the low half
__device__ __forceinline__ uint32_t pack_bf16(float x0, float x1) {
  __nv_bfloat162 v = __floats2bfloat162_rn(x0, x1);
  return *reinterpret_cast<uint32_t*>(&v);
}

// hi + lo split of two values into bf16x2 registers: hi = bf16(x),
// lo = bf16(x - hi); keeps about 16 bits of x
__device__ __forceinline__ void split_bf16(float x0, float x1, uint32_t& hi,
                                           uint32_t& lo) {
  __nv_bfloat162 h = __floats2bfloat162_rn(x0, x1);
  __nv_bfloat162 l = __floats2bfloat162_rn(x0 - __low2float(h),
                                           x1 - __high2float(h));
  hi = *reinterpret_cast<uint32_t*>(&h);
  lo = *reinterpret_cast<uint32_t*>(&l);
}

__device__ __forceinline__ uint32_t tf32_rna(float x) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(r) : "f"(x));
  return r;
}

__device__ __forceinline__ void split_tf32(float x, uint32_t& hi,
                                           uint32_t& lo) {
  hi = tf32_rna(x);
  lo = tf32_rna(x - __uint_as_float(hi));
}

// ---- asynchronous copies ---------------------------------------------------

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared; src_bytes 0 writes zeros and reads nothing
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(src_bytes)
               : "memory");
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src,
                                          int src_bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(src_bytes)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Row stride (elements) of a staged (rows, D) tile: padded by 16 bytes
// for fp32 and bf16 alike, so the fragment reads below and ldmatrix's
// eight 16-byte rows fall in distinct banks.
template <int D, typename T>
struct Tile {
  static constexpr int LD = D + 16 / static_cast<int>(sizeof(T));
};

// Rows [r0, r0 + ROWS) of a (time, D) matrix with row stride `stride`
// into dst[r * LD + d], 16 bytes per cp.async; rows at or past n are
// zero-filled. Global rows must start 16-byte aligned (the wrapper
// checks the pointers and strides).
template <int ROWS, int D, int NT, typename T>
__device__ __forceinline__ void load_rows_async(T* dst, const T* src,
                                                int64_t stride, int r0,
                                                int n) {
  constexpr int EPC = 16 / sizeof(T);  // elements per 16-byte chunk
  constexpr int CPR = D / EPC;         // chunks per row
  constexpr int LD = Tile<D, T>::LD;
#pragma unroll
  for (int it = 0; it < (ROWS * CPR + NT - 1) / NT; ++it) {
    const int i = it * NT + static_cast<int>(threadIdx.x);
    if (ROWS * CPR % NT != 0 && i >= ROWS * CPR) break;
    const int r = i / CPR, c = i % CPR;
    const bool in = r0 + r < n;
    const T* s = src + (in ? (int64_t)(r0 + r) * stride : 0) + c * EPC;
    cp_async16(dst + r * LD + c * EPC, s, in ? 16 : 0);
  }
}

// ROWS fp32 values (a row vector of lse or delta, any stride) into dst;
// entries at or past n are zero-filled.
template <int ROWS, int NT>
__device__ __forceinline__ void load_vec_async(float* dst, const float* src,
                                               int64_t stride, int r0,
                                               int n) {
  for (int r = threadIdx.x; r < ROWS; r += NT) {
    const bool in = r0 + r < n;
    cp_async4(dst + r, src + (in ? (int64_t)(r0 + r) * stride : 0),
              in ? 4 : 0);
  }
}

// ---- tensor-core instructions ------------------------------------------------

__device__ __forceinline__ void mma_tf32(float* c, const uint32_t* a,
                                         const uint32_t* b) {
  asm(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

__device__ __forceinline__ void mma_bf16(float* c, const uint32_t* a,
                                         const uint32_t* b) {
  asm(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// three-pass TF32 product: c += a.b at fp32 accuracy
__device__ __forceinline__ void mma_tf32x3(float* c, const uint32_t* ahi,
                                           const uint32_t* alo,
                                           const uint32_t* bhi,
                                           const uint32_t* blo) {
  mma_tf32(c, alo, bhi);
  mma_tf32(c, ahi, blo);
  mma_tf32(c, ahi, bhi);
}

// 2^x by the fast hardware approximation (about 2 ulp); -1e30 gives +0
__device__ __forceinline__ float exp2_fast(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ void ldsm_x4(uint32_t* r, const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}

__device__ __forceinline__ void ldsm_x4_t(uint32_t* r, const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}

// ---- warp-level products on staged tiles -----------------------------------

// acc[j] (16 x 8, j < NJ) += A . B^T over the D columns: A the warp's 16
// rows of a staged (rows, D) tile, B rows [8j, 8j + 8) of another. Both
// tiles are row-major with row stride Tile<D, T>::LD. NJ is even. CROSS
// (TF32X3): sum the cross terms in registers of their own.
template <int MODE, int D, int NJ, typename T, bool CROSS = true>
__device__ __forceinline__ void mma_abt(float (*acc)[4], const T* A,
                                        const T* B) {
  constexpr int LD = Tile<D, T>::LD;
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  if constexpr (MODE == TF32X3) {
    static_assert(sizeof(T) == 4, "TF32X3 takes fp32 tiles");
    // the hi.hi terms and the two cross terms sum in separate registers,
    // so three independent MMA chains per output tile are in flight
    float cross[NJ][4];
#pragma unroll
    for (int j = 0; j < NJ; ++j)
      cross[j][0] = cross[j][1] = cross[j][2] = cross[j][3] = 0.f;
#pragma unroll
    for (int k = 0; k < D; k += 8) {
      uint32_t ahi[4], alo[4];
      split_tf32(A[g * LD + k + t], ahi[0], alo[0]);
      split_tf32(A[(g + 8) * LD + k + t], ahi[1], alo[1]);
      split_tf32(A[g * LD + k + t + 4], ahi[2], alo[2]);
      split_tf32(A[(g + 8) * LD + k + t + 4], ahi[3], alo[3]);
#pragma unroll
      for (int j = 0; j < NJ; ++j) {
        const T* b = B + (8 * j + g) * LD + k + t;
        uint32_t bhi[2], blo[2];
        split_tf32(b[0], bhi[0], blo[0]);
        split_tf32(b[4], bhi[1], blo[1]);
        float* c = CROSS ? cross[j] : acc[j];
        mma_tf32(c, alo, bhi);
        mma_tf32(c, ahi, blo);
        mma_tf32(acc[j], ahi, bhi);
      }
    }
    if (CROSS) {
#pragma unroll
      for (int j = 0; j < NJ; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[j][e] += cross[j][e];
    }
  } else if constexpr (sizeof(T) == 4) {  // BF16 products of fp32 tiles
#pragma unroll
    for (int k = 0; k < D; k += 16) {
      uint32_t a[4];
      const float2 a0 = *reinterpret_cast<const float2*>(
          A + g * LD + k + 2 * t);
      const float2 a1 = *reinterpret_cast<const float2*>(
          A + (g + 8) * LD + k + 2 * t);
      const float2 a2 = *reinterpret_cast<const float2*>(
          A + g * LD + k + 2 * t + 8);
      const float2 a3 = *reinterpret_cast<const float2*>(
          A + (g + 8) * LD + k + 2 * t + 8);
      a[0] = pack_bf16(a0.x, a0.y);
      a[1] = pack_bf16(a1.x, a1.y);
      a[2] = pack_bf16(a2.x, a2.y);
      a[3] = pack_bf16(a3.x, a3.y);
#pragma unroll
      for (int j = 0; j < NJ; ++j) {
        const T* b = B + (8 * j + g) * LD + k + 2 * t;
        const float2 b0 = *reinterpret_cast<const float2*>(b);
        const float2 b1 = *reinterpret_cast<const float2*>(b + 8);
        const uint32_t bb[2] = {pack_bf16(b0.x, b0.y), pack_bf16(b1.x, b1.y)};
        mma_bf16(acc[j], a, bb);
      }
    }
  } else {  // BF16 products of bf16 tiles, fragments by ldmatrix
    const int ar = lane & 15, ac = (lane >> 4) * 8;
    const int br = (lane & 7) + ((lane >> 4) << 3);
    const int bc = ((lane >> 3) & 1) * 8;
#pragma unroll
    for (int k = 0; k < D; k += 16) {
      uint32_t a[4];
      ldsm_x4(a, A + ar * LD + k + ac);
#pragma unroll
      for (int j = 0; j < NJ; j += 2) {
        uint32_t b[4];
        ldsm_x4(b, B + (8 * j + br) * LD + k + bc);
        mma_bf16(acc[j], a, b);
        mma_bf16(acc[j + 1], a, b + 2);
      }
    }
  }
}

// acc[n] (16 x 8, n < D / 8) += P . V: P the 16 x (8 * NJ) accumulator
// pc[j] of an mma_abt (values in registers), V rows [0, 8 * NJ) of a staged
// (rows, D) tile. split: with BF16, P runs as two bf16 products
// (hi + lo, about 16 bits of P); without, P is rounded to bf16 once.
template <int MODE, int D, int NJ, typename T>
__device__ __forceinline__ void mma_pv(float (*acc)[4], float (*pc)[4],
                                       const T* V, bool split) {
  constexpr int LD = Tile<D, T>::LD;
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  if constexpr (MODE == TF32X3) {
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
      // keys in the order (0, 2, 4, 6, 1, 3, 5, 7): slot t is key 2t
      uint32_t ahi[4], alo[4];
      split_tf32(pc[j][0], ahi[0], alo[0]);
      split_tf32(pc[j][2], ahi[1], alo[1]);
      split_tf32(pc[j][1], ahi[2], alo[2]);
      split_tf32(pc[j][3], ahi[3], alo[3]);
      const T* v = V + (8 * j + 2 * t) * LD + g;
#pragma unroll
      for (int n = 0; n < D / 8; ++n) {
        uint32_t bhi[2], blo[2];
        split_tf32(v[8 * n], bhi[0], blo[0]);
        split_tf32(v[LD + 8 * n], bhi[1], blo[1]);
        mma_tf32x3(acc[n], ahi, alo, bhi, blo);
      }
    }
  } else {
    static_assert(NJ % 2 == 0, "BF16 steps take 16 keys");
#pragma unroll
    for (int j = 0; j < NJ; j += 2) {
      uint32_t ahi[4], alo[4];
      if (split) {
        split_bf16(pc[j][0], pc[j][1], ahi[0], alo[0]);
        split_bf16(pc[j][2], pc[j][3], ahi[1], alo[1]);
        split_bf16(pc[j + 1][0], pc[j + 1][1], ahi[2], alo[2]);
        split_bf16(pc[j + 1][2], pc[j + 1][3], ahi[3], alo[3]);
      } else {
        ahi[0] = pack_bf16(pc[j][0], pc[j][1]);
        ahi[1] = pack_bf16(pc[j][2], pc[j][3]);
        ahi[2] = pack_bf16(pc[j + 1][0], pc[j + 1][1]);
        ahi[3] = pack_bf16(pc[j + 1][2], pc[j + 1][3]);
      }
      if constexpr (sizeof(T) == 4) {  // fp32 tile, rounded to bf16 here
        const T* v = V + (8 * j + 2 * t) * LD + g;
#pragma unroll
        for (int n = 0; n < D / 8; ++n) {
          const uint32_t b[2] = {
              pack_bf16(v[8 * n], v[LD + 8 * n]),
              pack_bf16(v[8 * LD + 8 * n], v[9 * LD + 8 * n])};
          if (split) mma_bf16(acc[n], alo, b);
          mma_bf16(acc[n], ahi, b);
        }
      } else {  // bf16 tile: V^T fragments by ldmatrix.trans
        const T* v = V + (8 * j + (lane & 15)) * LD + (lane >> 4) * 8;
#pragma unroll
        for (int n = 0; n < D / 8; n += 2) {
          uint32_t b[4];
          ldsm_x4_t(b, v + 8 * n);
          if (split) {
            mma_bf16(acc[n], alo, b);
            mma_bf16(acc[n + 1], alo, b + 2);
          }
          mma_bf16(acc[n], ahi, b);
          mma_bf16(acc[n + 1], ahi, b + 2);
        }
      }
    }
  }
}

// ---- causal live-tile bounds -----------------------------------------------
// Causal keeps k <= q + shift, shift = Tk - Tq (bottom-right).

// number of key tiles of width bk that rows [q0, q0 + bq) may see
__device__ __forceinline__ int live_key_tiles(int q0, int bq, int bk, int tk,
                                              int shift, bool causal) {
  int n = (tk + bk - 1) / bk;
  if (causal) {
    const int kmax = q0 + bq - 1 + shift;  // last key any row here sees
    n = min(n, kmax < 0 ? 0 : kmax / bk + 1);
  }
  return n;
}

// first query tile of height bq whose rows can see key k0
__device__ __forceinline__ int first_query_tile(int k0, int bq, int shift,
                                                bool causal) {
  if (!causal) return 0;
  const int first_row = k0 - shift;
  return first_row <= 0 ? 0 : first_row / bq;
}

}  // namespace attn
