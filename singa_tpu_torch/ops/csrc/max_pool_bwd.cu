// NHWC max-pool backward for Hopper (sm_90a), CUDA C++ with a plain C
// interface (loaded with ctypes by singa_tpu_torch/ops/max_pool.py).
//
// Replaces the Pallas kernel _bwd_kernel of singa_tpu/ops/max_pool.py
// (:152, pallas_call at :287). The function is the TPU kernel's, which is
// XLA select-and-scatter's: given x (N,H,W,C), y = maxpool(x) (N,OH,OW,C)
// and dy, each input position gets the sum, in fp32, of dy over the
// windows whose FIRST maximum in row-major window order it is. Padded
// positions are never selected (the `ok` mask, :206-213); a NaN never
// equals y, so it is never selected either. dx is written in x's dtype.
// Every tensor comes with its 4 element strides, so a channels-last view
// or a non-contiguous incoming gradient is read in place. Every shape is
// taken: the TPU's VMEM sizing (_pick_cblock) and its XLA fallback have no
// counterpart.
//
// Bound at the ResNet-50 stem shape (128,112,112,64) -> (128,56,56,64),
// fp32: x read and dx written, 411.0 MB each, y and dy read, 102.8 MB
// each: 1.028 GB, 0.307 ms at the data sheet's 3.35 TB/s (half in bf16).
// The work is a few comparisons and adds per byte, so bytes bound it. The
// first version, a gather with one thread per dx element and 4-byte loads
// that rescanned each matching window for an earlier match, took the same
// time in bf16 as in fp32, 9x the bound: too few loads were in flight.
//
// Design: decide each window once, then gather, in one launch.
// - A CTA of 256 threads owns a tile of dx: bh rows x 16 columns of one
//   image x cv channel vectors (an item is one position's channel
//   vector; each thread owns 4 items). At most 128 registers a thread,
//   so that two CTAs share an SM.
// - Phase 1: for every window (a, b) that covers the tile, and each
//   channel vector, one thread reads y, dy and the window's in-bounds x
//   and keeps, per channel, the offset of the first x equal to y in
//   row-major window order (-1 if none). Offsets and dy go to shared
//   memory. A window that straddles two tiles is decided by both. For
//   windows of up to 3 x 3 on the vector route, all of a window's loads
//   (11 of 16 bytes) are issued before its comparisons.
// - Phase 2: each thread adds, for its dx items, dy of the covering
//   windows whose offset is the item's own, in fp32 and in a fixed window
//   order, then writes the item once. Each dx element is written by one
//   thread: no atomics, bitwise repeats, nothing crosses CTAs.
// - Vector route: where C is innermost with stride 1, C and every other
//   stride are multiples of the vector width and the pointers are 16-byte
//   aligned (the main path: a channels-last activation and a contiguous
//   gradient), an item is 16 bytes of channels (4 fp32 or 8 bf16), loaded
//   and stored as one 16-byte access, neighbouring threads on neighbouring
//   channel vectors. Any other stride runs the same kernel with one
//   channel per item (max_pool_bwd_vector_width says which).
// - Integer work: the per-item index arithmetic is shifts and masks (cv
//   and the tile width are powers of two) and each tile row's and
//   column's covering windows are computed once per CTA; runtime
//   divisions in the per-item loops cost measurable time at the stem
//   (scripts/ab_torch_kernels.py, PERF.md).
// - Shared memory holds 8 bytes per window and channel; where a tile's
//   windows need more than 48 KB (large windows at stride 1), they are
//   taken in chunks, phase 1 and 2 per chunk, so every window size fits.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int NT = 256;              // threads per CTA
constexpr int IPT = 4;               // dx items per thread
constexpr int BW = 16;               // dx columns per tile
constexpr int SMEM_CAP = 48 * 1024;  // window offsets and dy per chunk

struct Params {
  const void* x;
  const void* y;
  const void* dy;
  void* dx;
  int n, h, w, c, oh, ow;
  int kh, kw, sh, sw, ph, pw;
  // element strides for (n, h, w, c)
  int64_t sx[4], sy[4], sdy[4], sdx[4];
  // the tile: channel vectors (cv = 2^lcv), rows; windows per chunk
  int cv, lcv, bh, ca, cb;
};

// An item's channels as loaded: 16 bytes on the vector route, one element
// on the scalar route
template <typename T, int VEC>
struct Raw {
  using type = uint4;
};
template <typename T>
struct Raw<T, 1> {
  using type = T;
};

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename T, int VEC>
__device__ __forceinline__ typename Raw<T, VEC>::type load_raw(
    const T* src) {
  return *reinterpret_cast<const typename Raw<T, VEC>::type*>(src);
}

// the VEC channels of a loaded item as fp32
template <typename T, int VEC>
__device__ __forceinline__ void unpack(float (&out)[VEC],
                                       const typename Raw<T, VEC>::type& r) {
  if constexpr (VEC == 1) {
    out[0] = to_f(r);
  } else {
    static_assert(VEC * sizeof(T) == 16, "16 bytes of channels");
    const uint32_t u[4] = {r.x, r.y, r.z, r.w};
    if constexpr (sizeof(T) == 4) {
#pragma unroll
      for (int i = 0; i < 4; ++i) out[i] = __uint_as_float(u[i]);
    } else {
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float2 f = __bfloat1622float2(
            *reinterpret_cast<const __nv_bfloat162*>(&u[i]));
        out[2 * i] = f.x;
        out[2 * i + 1] = f.y;
      }
    }
  }
}

// VEC values to dst in T, rounded to nearest even as astype does
template <int VEC, typename T>
__device__ __forceinline__ void store_vec(T* dst, const float (&in)[VEC]) {
  if constexpr (VEC == 1) {
    if constexpr (sizeof(T) == 4) {
      *dst = in[0];
    } else {
      *dst = __float2bfloat16(in[0]);
    }
  } else if constexpr (sizeof(T) == 4) {
    *reinterpret_cast<float4*>(dst) = make_float4(in[0], in[1], in[2],
                                                  in[3]);
  } else {
    uint32_t u[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      __nv_bfloat162 b = __floats2bfloat162_rn(in[2 * i], in[2 * i + 1]);
      u[i] = *reinterpret_cast<uint32_t*>(&b);
    }
    *reinterpret_cast<uint4*>(dst) = make_uint4(u[0], u[1], u[2], u[3]);
  }
}

// first window index (along one axis) whose window covers i:
// a * s - pad + k - 1 >= i
__device__ __forceinline__ int first_cover(int i, int k, int s, int pad) {
  const int t = i + pad - k + 1;
  return t <= 0 ? 0 : (t + s - 1) / s;
}

// Keeps in off[e] the first offset o whose x equals y, per channel.
template <int VEC>
__device__ __forceinline__ void first_match(int (&off)[VEC],
                                            const float (&xv)[VEC],
                                            const float (&yv)[VEC], int o) {
#pragma unroll
  for (int e = 0; e < VEC; ++e)
    off[e] = (off[e] < 0 && xv[e] == yv[e]) ? o : off[e];
}

// K > 0: windows of at most K x K, whose loads are all issued before the
// comparisons; K = 0: any window, a row of loads at a time.
template <typename T, int VEC, int K>
__global__ void __launch_bounds__(NT, 2)
    max_pool_bwd_kernel(const Params p) {
  using RawT = typename Raw<T, VEC>::type;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int per_chunk = p.ca * p.cb * p.cv * VEC;
  int* s_off = reinterpret_cast<int*>(smem_raw);  // [window][cv][VEC]
  float* s_dy = reinterpret_cast<float*>(s_off + per_chunk);
  // per tile row and column: the first and last window covering it
  __shared__ int s_acov[2][NT * IPT / BW], s_bcov[2][BW];

  // the tile: channel group fastest, then columns, rows, image
  const int n_cg = (p.c + p.cv * VEC - 1) / (p.cv * VEC);
  const int n_wt = (p.w + BW - 1) / BW;
  const int n_ht = (p.h + p.bh - 1) / p.bh;
  int t = blockIdx.x;
  const int cg = t % n_cg;
  t /= n_cg;
  const int w0 = t % n_wt * BW;
  t /= n_wt;
  const int h0 = t % n_ht * p.bh;
  const int n = t / n_ht;
  const int c0 = cg * p.cv * VEC;
  const int h1 = min(p.h, h0 + p.bh) - 1, w1 = min(p.w, w0 + BW) - 1;
  // the windows that cover rows [h0, h1] and columns [w0, w1]
  const int a0 = first_cover(h0, p.kh, p.sh, p.ph);
  const int a1 = min(p.oh - 1, (h1 + p.ph) / p.sh);
  const int b0 = first_cover(w0, p.kw, p.sw, p.pw);
  const int b1 = min(p.ow - 1, (w1 + p.pw) / p.sw);
  const int tid = threadIdx.x;
  if (tid < p.bh) {
    s_acov[0][tid] = first_cover(h0 + tid, p.kh, p.sh, p.ph);
    s_acov[1][tid] = min(p.oh - 1, (h0 + tid + p.ph) / p.sh);
  } else if (tid < p.bh + BW) {
    const int q = tid - p.bh;
    s_bcov[0][q] = first_cover(w0 + q, p.kw, p.sw, p.pw);
    s_bcov[1][q] = min(p.ow - 1, (w0 + q + p.pw) / p.sw);
  }

  const T* x = static_cast<const T*>(p.x) + n * p.sx[0];
  const T* y = static_cast<const T*>(p.y) + n * p.sy[0];
  const T* dy = static_cast<const T*>(p.dy) + n * p.sdy[0];
  const int items = p.bh * BW << p.lcv;

  float acc[IPT][VEC];
#pragma unroll
  for (int k = 0; k < IPT; ++k)
#pragma unroll
    for (int e = 0; e < VEC; ++e) acc[k][e] = 0.f;

  for (int ac = a0; ac <= a1; ac += p.ca) {
    const int na = min(p.ca, a1 - ac + 1);
    for (int bc = b0; bc <= b1; bc += p.cb) {
      const int nb = min(p.cb, b1 - bc + 1);
      __syncthreads();  // the previous chunk's readers are done

      // phase 1: each window's first maximum, per channel
      for (int j = tid; j < na * nb << p.lcv; j += NT) {
        const int v = j & (p.cv - 1), wi = j >> p.lcv;
        const int wa = wi / nb;
        const int a = ac + wa, b = bc + wi - wa * nb;
        const int ch = c0 + v * VEC;
        int off[VEC];
        float dyv[VEC];
#pragma unroll
        for (int e = 0; e < VEC; ++e) {
          off[e] = -1;
          dyv[e] = 0.f;
        }
        if (ch < p.c) {
          const RawT yr =
              load_raw<T, VEC>(y + a * p.sy[1] + b * p.sy[2] + ch * p.sy[3]);
          const RawT dyr = load_raw<T, VEC>(dy + a * p.sdy[1] +
                                            b * p.sdy[2] + ch * p.sdy[3]);
          const int r0 = a * p.sh - p.ph, q0 = b * p.sw - p.pw;
          const int dr0 = max(0, -r0), dq0 = max(0, -q0);
          const int dr1 = min(p.kh, p.h - r0), dq1 = min(p.kw, p.w - q0);
          const T* xw = x + r0 * p.sx[1] + q0 * p.sx[2] + ch * p.sx[3];
          float yv[VEC], xv[VEC];
          if constexpr (K > 0) {
            RawT xr[K][K];
#pragma unroll
            for (int dr = 0; dr < K; ++dr)
#pragma unroll
              for (int dq = 0; dq < K; ++dq)
                if (dr >= dr0 && dr < dr1 && dq >= dq0 && dq < dq1)
                  xr[dr][dq] =
                      load_raw<T, VEC>(xw + dr * p.sx[1] + dq * p.sx[2]);
            unpack<T, VEC>(yv, yr);
#pragma unroll
            for (int dr = 0; dr < K; ++dr)
#pragma unroll
              for (int dq = 0; dq < K; ++dq)
                if (dr >= dr0 && dr < dr1 && dq >= dq0 && dq < dq1) {
                  unpack<T, VEC>(xv, xr[dr][dq]);
                  first_match<VEC>(off, xv, yv, dr * p.kw + dq);
                }
          } else {
            unpack<T, VEC>(yv, yr);
            for (int dr = dr0; dr < dr1; ++dr) {
#pragma unroll 4
              for (int dq = dq0; dq < dq1; ++dq) {
                unpack<T, VEC>(xv, load_raw<T, VEC>(xw + dr * p.sx[1] +
                                                    dq * p.sx[2]));
                first_match<VEC>(off, xv, yv, dr * p.kw + dq);
              }
            }
          }
          unpack<T, VEC>(dyv, dyr);
        }
#pragma unroll
        for (int e = 0; e < VEC; ++e) {
          s_off[j * VEC + e] = off[e];
          s_dy[j * VEC + e] = dyv[e];
        }
      }
      __syncthreads();

      // phase 2: each dx item takes dy of the covering windows it won
#pragma unroll
      for (int k = 0; k < IPT; ++k) {
        const int i = tid + k * NT;
        if (i >= items) break;
        const int v = i & (p.cv - 1), pos = i >> p.lcv;
        const int r = pos / BW, q = pos % BW;
        const int a_lo = max(ac, s_acov[0][r]);
        const int a_hi = min(ac + na - 1, s_acov[1][r]);
        const int b_lo = max(bc, s_bcov[0][q]);
        const int b_hi = min(bc + nb - 1, s_bcov[1][q]);
        // offset of (h0 + r, w0 + q) in window (a, b): d_row * kw + d_col
        const int o_a = (h0 + r + p.ph - a_lo * p.sh) * p.kw;
        const int o_b = w0 + q + p.pw - b_lo * p.sw;
        for (int a = a_lo; a <= a_hi; ++a) {
          const int o_ab = o_a - (a - a_lo) * p.sh * p.kw;
          const int* wo = s_off + (((a - ac) * nb + b_lo - bc) << p.lcv) * VEC;
          const float* wd = s_dy + (wo - s_off);
          for (int b = b_lo; b <= b_hi; ++b) {
            const int o = o_ab + o_b - (b - b_lo) * p.sw;
            const int jj = (((b - b_lo) << p.lcv) + v) * VEC;
#pragma unroll
            for (int e = 0; e < VEC; ++e)
              if (wo[jj + e] == o) acc[k][e] += wd[jj + e];
          }
        }
      }
    }
  }

  T* dx = static_cast<T*>(p.dx) + n * p.sdx[0];
#pragma unroll
  for (int k = 0; k < IPT; ++k) {
    const int i = tid + k * NT;
    if (i >= items) break;
    const int v = i & (p.cv - 1), pos = i >> p.lcv;
    const int hh = h0 + pos / BW, ww = w0 + pos % BW;
    const int ch = c0 + v * VEC;
    if (hh > h1 || ww > w1 || ch >= p.c) continue;
    store_vec<VEC>(dx + hh * p.sdx[1] + ww * p.sdx[2] + ch * p.sdx[3],
                   acc[k]);
  }
}

// channels per 16 bytes where the vector route applies, else 1
int vector_width(const void* const* ptrs, int c, const int64_t* strides,
                 int dtype) {
  const int vec = dtype == 1 ? 8 : 4;
  if (c % vec != 0) return 1;
  for (int t = 0; t < 4; ++t) {
    if (reinterpret_cast<uintptr_t>(ptrs[t]) % 16 != 0) return 1;
    if (strides[4 * t + 3] != 1) return 1;
    for (int k = 0; k < 3; ++k)
      if (strides[4 * t + k] % vec != 0) return 1;
  }
  return vec;
}

template <typename T, int VEC>
cudaError_t launch(Params p, cudaStream_t stream) {
  // the tile: cv channel vectors (a power of two, up to 16, or 8 where
  // windows overlap row to row, sh = 1, and a taller tile reads fewer
  // halo rows), BW columns, and rows up to NT * IPT items
  const int cvec = (p.c + VEC - 1) / VEC;
  const int max_lcv = p.sh > 1 ? 4 : 3;
  p.lcv = 0;
  while (p.lcv < max_lcv && (2 << p.lcv) <= cvec) ++p.lcv;
  p.cv = 1 << p.lcv;
  p.bh = min(p.h, NT * IPT / (p.cv * BW));
  const int64_t tiles = (int64_t)p.n * ((p.h + p.bh - 1) / p.bh) *
                        ((p.w + BW - 1) / BW) *
                        ((p.c + p.cv * VEC - 1) / (p.cv * VEC));
  if (tiles > 0x7fffffff) return cudaErrorInvalidConfiguration;
  // windows covering the tile, in chunks that fit SMEM_CAP
  const int na = min(p.oh, (p.bh + p.kh - 2) / p.sh + 1);
  const int nb = min(p.ow, (BW + p.kw - 2) / p.sw + 1);
  const int per_win = p.cv * VEC * 8;  // an int offset and fp32 dy
  p.cb = min(nb, max(1, SMEM_CAP / per_win));
  p.ca = min(na, max(1, SMEM_CAP / (per_win * p.cb)));
  const size_t smem = (size_t)p.ca * p.cb * per_win;
  // windows of up to 3 x 3 (every pool of the reference's models) issue
  // all their loads at once
  if constexpr (VEC > 1) {
    if (p.kh <= 3 && p.kw <= 3) {
      max_pool_bwd_kernel<T, VEC, 3><<<(unsigned)tiles, NT, smem, stream>>>(
          p);
      return cudaGetLastError();
    }
  }
  max_pool_bwd_kernel<T, VEC, 0><<<(unsigned)tiles, NT, smem, stream>>>(p);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Channels per thread access that max_pool_bwd takes for these operands:
// 4 (fp32) or 8 (bf16) on the 16-byte vector route, 1 otherwise.
// Arguments as max_pool_bwd's.
int max_pool_bwd_vector_width(const void* x, const void* y, const void* dy,
                              const void* dx, int c, const int64_t* strides,
                              int dtype) {
  const void* ptrs[4] = {x, y, dy, dx};
  return vector_width(ptrs, c, strides, dtype);
}

// dtype: 0 float32, 1 bfloat16. strides: x, y, dy, dx, 4 each, in
// elements, for (n, h, w, c). Returns the cudaError_t of the launch (0 on
// success); launches nothing for an empty tensor.
int max_pool_bwd(const void* x, const void* y, const void* dy, void* dx,
                 int n, int h, int w, int c, int oh, int ow, int kh, int kw,
                 int sh, int sw, int ph, int pw, const int64_t* strides,
                 int dtype, void* stream) {
  Params p{x, y, dy, dx, n, h, w, c, oh, ow, kh, kw, sh, sw, ph, pw,
           {}, {}, {}, {}, 0, 0, 0, 0, 0};
  for (int k = 0; k < 4; ++k) {
    p.sx[k] = strides[k];
    p.sy[k] = strides[4 + k];
    p.sdy[k] = strides[8 + k];
    p.sdx[k] = strides[12 + k];
  }
  if ((int64_t)n * h == 0 || w == 0 || c == 0) return 0;
  const void* ptrs[4] = {x, y, dy, dx};
  const int vec = vector_width(ptrs, c, strides, dtype);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (dtype == 1) {
    err = vec == 8 ? launch<__nv_bfloat16, 8>(p, s)
                   : launch<__nv_bfloat16, 1>(p, s);
  } else {
    err = vec == 4 ? launch<float, 4>(p, s) : launch<float, 1>(p, s);
  }
  return (int)err;
}

const char* max_pool_bwd_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
