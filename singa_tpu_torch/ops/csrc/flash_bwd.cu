// Flash-attention backward for Hopper (sm_90a), CUDA C++ with a plain C
// interface (loaded with ctypes by singa_tpu_torch/ops/flash_attention.py).
//
// Two kernels replace the four backward Pallas kernels of
// singa_tpu/ops/flash_attention.py:
//   flash_bwd_dq_kernel   <- _bwd_dq_kernel       (:297, pallas_call :426)
//                            _bwd_dq_kernel_qkv   (:670, pallas_call :872)
//   flash_bwd_dkv_kernel  <- _bwd_dkv_kernel      (:350, pallas_call :449)
//                            _bwd_dkv_kernel_qkv  (:727, pallas_call :911)
// Each serves the head-split (B, H, T, D) layout and the fused (B, T, 3d)
// layout through (batch, head, time) element strides, as flash_fwd.cu
// does: in the fused layout dq, dk and dv are the three column blocks of
// one (B, T, 3d) gradient of qkv, written in place with no concatenation.
//
// The function is the TPU kernels': from the forward's lse and
// delta = rowsum(dO * O) (computed by the caller, fp32),
//   s  = q.k^T * scale            p  = exp(s - lse), masked p an exact 0
//   dp = dO.v^T                   ds = p * (dp - delta) * scale
//   dq = ds.k     dk = ds^T.q     dv = p^T.dO
// in fp32. Masked pairs are keys past Tk, rows past Tq and, when causal,
// k > q + (Tk - Tq) (bottom-right). The mask zeroes p explicitly: on a row
// with no key, lse = -1e30 + log(1e-30) and exp(s - lse) would not be 0.
// Such a row gets dq = 0 exactly and adds nothing to dk or dv. With
// mxu_bf16, q, k, v, dO, p (for dv) and ds are rounded to bf16 before
// their products, with fp32 accumulation (_op, :97; the casts at :322,
// :372, :380). Gradients are written in the input dtype.
//
// Design (first, simple version, FMA in fp32 as in the forward):
// - dQ: one CTA of 256 threads per (batch*head, 64-row Q tile). Q, dO, the
//   tile's lse and delta stay in shared memory; a loop over the live
//   64-key K/V tiles (it stops at the causal bound, as the forward does)
//   stages K^T and V^T, computes S and dP as 4x4 register micro-tiles per
//   thread, writes dS to shared memory and accumulates dQ = dS K in
//   registers (each row's D columns spread over 4 adjacent lanes).
// - dK/dV: one CTA of 256 threads per (batch*head, 64-key K tile). K and V
//   stay in shared memory; a loop over the live Q tiles starts at the
//   first tile whose rows can see this K tile (the reference's clamp,
//   _q_index_map :130, qi_map :896) and stages Q, dO, lse and delta;
//   P and dS go to shared memory, dK and dV accumulate in registers.
// - Nothing is reduced across CTAs: no atomics, a fixed summation order,
//   so the gradients are bitwise equal run to run.
// - Shared memory at hd 128 (fp32 tiles, rows padded by one float against
//   bank conflicts): dQ 150 KB, dK/dV 166 KB, so one CTA per SM. The dK/dV
//   accumulators (2 x 32 floats per thread at hd 128) live in registers.
//
// Bound at gpt_medium's shape (B=4, T=1024, H=8, hd=128, causal): the five
// products on the kept pairs are 10*B*H*pairs*D = 21.5 GFLOP, ~0.32 ms at
// 67 TFLOP/s (fp32 outside the tensor cores), while q, k, v, O, dO, lse,
// delta in and dq, dk, dv out are ~100 MB, ~0.03 ms at 3.35 TB/s: bound by
// operations (reckoned from the data sheet, not measured). The two kernels
// recompute S and dP each, so they run 7 products, not 5; tensor cores
// (wgmma) and TMA are later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BQ = 64;   // query rows per tile
constexpr int BK = 64;   // key rows per tile
constexpr int NT = 256;  // threads per CTA

struct Params {
  const void* q;
  const void* k;
  const void* v;
  const void* dout;
  const float* lse;
  const float* delta;
  void* dq;
  void* dk;
  void* dv;
  int heads, tq, tk;
  // element strides for (batch, head, time); the last dim is contiguous
  int64_t sq[3], sk[3], sv[3], sdo[3], sl[3], sdl[3], sdq[3], sdk[3], sdv[3];
  float scale;
  int causal, mxu_bf16;
};

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16(x);  // round to nearest even, as astype does
}
__device__ __forceinline__ float round_bf16(float x) {
  return __bfloat162float(__float2bfloat16(x));
}

// Rows [r0, r0 + R) of a (time, D) matrix with time stride `st` into
// shared memory: dst[r * ld + d], or transposed dst[d * ld + r]. Rows at
// or past n load as 0.
template <int R, int D, bool TRANSPOSE, typename T>
__device__ __forceinline__ void load_tile(float* dst, int ld, const T* src,
                                          int64_t st, int r0, int n,
                                          bool rnd) {
  for (int i = threadIdx.x; i < R * D; i += NT) {
    const int r = i / D, d = i % D;
    float x = 0.f;
    if (r0 + r < n) x = to_f(src[(int64_t)(r0 + r) * st + d]);
    if (rnd) x = round_bf16(x);
    dst[TRANSPOSE ? d * ld + r : r * ld + d] = x;
  }
}

__device__ __forceinline__ bool kept(const Params& p, int qi, int kk) {
  return qi < p.tq && kk < p.tk &&
         (!p.causal || kk <= qi + (p.tk - p.tq));
}

template <int D>
constexpr size_t dq_smem_floats() {
  return 2 * BQ * (D + 1)     // Qs, dOs: [r][d]
         + 2 * D * (BK + 1)   // Kt, Vt: [d][c], transposed
         + BQ * (BK + 1)      // dSs: [r][c]
         + 2 * BQ;            // lse, delta of the tile's rows
}

template <int D, typename T>
__global__ void __launch_bounds__(NT) flash_bwd_dq_kernel(const Params p) {
  extern __shared__ float smem[];
  float* Qs = smem;
  float* dOs = Qs + BQ * (D + 1);
  float* Kt = dOs + BQ * (D + 1);
  float* Vt = Kt + D * (BK + 1);
  float* dSs = Vt + D * (BK + 1);
  float* Ls = dSs + BQ * (BK + 1);
  float* Dl = Ls + BQ;

  const int bh = blockIdx.y;
  const int b = bh / p.heads, h = bh % p.heads;
  const int q0 = blockIdx.x * BQ;
  const int tid = threadIdx.x;
  const bool rnd = p.mxu_bf16 != 0;

  const T* qg = static_cast<const T*>(p.q) + b * p.sq[0] + h * p.sq[1];
  const T* kg = static_cast<const T*>(p.k) + b * p.sk[0] + h * p.sk[1];
  const T* vg = static_cast<const T*>(p.v) + b * p.sv[0] + h * p.sv[1];
  const T* dog =
      static_cast<const T*>(p.dout) + b * p.sdo[0] + h * p.sdo[1];

  load_tile<BQ, D, false>(Qs, D + 1, qg, p.sq[2], q0, p.tq, rnd);
  load_tile<BQ, D, false>(dOs, D + 1, dog, p.sdo[2], q0, p.tq, rnd);
  for (int r = tid; r < BQ; r += NT) {
    const int qi = q0 + r;
    const bool in = qi < p.tq;
    Ls[r] = in ? p.lse[b * p.sl[0] + h * p.sl[1] + (int64_t)qi * p.sl[2]]
               : 0.f;
    Dl[r] = in ? p.delta[b * p.sdl[0] + h * p.sdl[1] +
                         (int64_t)qi * p.sdl[2]]
               : 0.f;
  }

  // S / dP ownership: rows ty*4 + i, columns tx + 16*j
  const int ty = tid >> 4, tx = tid & 15;
  // dQ ownership: row `row`, columns sub + 4*j
  const int row = tid >> 2, sub = tid & 3;
  float acc[D / 4];
#pragma unroll
  for (int j = 0; j < D / 4; ++j) acc[j] = 0.f;

  int n_tiles = (p.tk + BK - 1) / BK;
  if (p.causal) {
    const int kmax = q0 + BQ - 1 + (p.tk - p.tq);  // last key seen here
    n_tiles = min(n_tiles, kmax < 0 ? 0 : kmax / BK + 1);
  }

  for (int t = 0; t < n_tiles; ++t) {
    const int k0 = t * BK;
    __syncthreads();  // the previous tile's readers are done
    load_tile<BK, D, true>(Kt, BK + 1, kg, p.sk[2], k0, p.tk, rnd);
    load_tile<BK, D, true>(Vt, BK + 1, vg, p.sv[2], k0, p.tk, rnd);
    __syncthreads();

    float s[4][4], dp[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = dp[i][j] = 0.f;
#pragma unroll 4
    for (int d = 0; d < D; ++d) {
      float a[4], g[4], bk[4], bv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        a[i] = Qs[(ty * 4 + i) * (D + 1) + d];
        g[i] = dOs[(ty * 4 + i) * (D + 1) + d];
      }
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        bk[j] = Kt[d * (BK + 1) + tx + 16 * j];
        bv[j] = Vt[d * (BK + 1) + tx + 16 * j];
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          s[i][j] = fmaf(a[i], bk[j], s[i][j]);
          dp[i][j] = fmaf(g[i], bv[j], dp[i][j]);
        }
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = ty * 4 + i;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int c = tx + 16 * j;
        float ds = 0.f;
        if (kept(p, q0 + r, k0 + c)) {
          const float pr = expf(s[i][j] * p.scale - Ls[r]);
          ds = pr * (dp[i][j] - Dl[r]) * p.scale;
          if (rnd) ds = round_bf16(ds);
        }
        dSs[r * (BK + 1) + c] = ds;
      }
    }
    __syncthreads();

    // dQ += dS K
    const float* dsrow = dSs + row * (BK + 1);
#pragma unroll 4
    for (int c = 0; c < BK; ++c) {
      const float w = dsrow[c];
#pragma unroll
      for (int j = 0; j < D / 4; ++j)
        acc[j] = fmaf(w, Kt[(sub + 4 * j) * (BK + 1) + c], acc[j]);
    }
  }

  const int qi = q0 + row;
  if (qi < p.tq) {
    T* dqg = static_cast<T*>(p.dq) + b * p.sdq[0] + h * p.sdq[1] +
             (int64_t)qi * p.sdq[2];
#pragma unroll
    for (int j = 0; j < D / 4; ++j) store(dqg + sub + 4 * j, acc[j]);
  }
}

template <int D>
constexpr size_t dkv_smem_floats() {
  return 2 * BK * (D + 1)     // Ks, Vs: [c][d]
         + 2 * BQ * (D + 1)   // Qs, dOs: [r][d]
         + 2 * BQ * (BK + 1)  // Ps, dSs: [r][c]
         + 2 * BQ;            // lse, delta of the Q tile's rows
}

template <int D, typename T>
__global__ void __launch_bounds__(NT) flash_bwd_dkv_kernel(const Params p) {
  extern __shared__ float smem[];
  float* Ks = smem;
  float* Vs = Ks + BK * (D + 1);
  float* Qs = Vs + BK * (D + 1);
  float* dOs = Qs + BQ * (D + 1);
  float* Ps = dOs + BQ * (D + 1);
  float* dSs = Ps + BQ * (BK + 1);
  float* Ls = dSs + BQ * (BK + 1);
  float* Dl = Ls + BQ;

  const int bh = blockIdx.y;
  const int b = bh / p.heads, h = bh % p.heads;
  const int k0 = blockIdx.x * BK;
  const int tid = threadIdx.x;
  const bool rnd = p.mxu_bf16 != 0;

  const T* qg = static_cast<const T*>(p.q) + b * p.sq[0] + h * p.sq[1];
  const T* kg = static_cast<const T*>(p.k) + b * p.sk[0] + h * p.sk[1];
  const T* vg = static_cast<const T*>(p.v) + b * p.sv[0] + h * p.sv[1];
  const T* dog =
      static_cast<const T*>(p.dout) + b * p.sdo[0] + h * p.sdo[1];
  const float* lg = p.lse + b * p.sl[0] + h * p.sl[1];
  const float* dlg = p.delta + b * p.sdl[0] + h * p.sdl[1];

  load_tile<BK, D, false>(Ks, D + 1, kg, p.sk[2], k0, p.tk, rnd);
  load_tile<BK, D, false>(Vs, D + 1, vg, p.sv[2], k0, p.tk, rnd);

  const int ty = tid >> 4, tx = tid & 15;      // S / dP micro-tiles
  const int col = tid >> 2, sub = tid & 3;     // dK / dV: key row `col`
  float acc_k[D / 4], acc_v[D / 4];
#pragma unroll
  for (int j = 0; j < D / 4; ++j) acc_k[j] = acc_v[j] = 0.f;

  const int n_q = (p.tq + BQ - 1) / BQ;
  int t0 = 0;
  if (p.causal) {
    // the first row that sees key k0 is k0 - (Tk - Tq); earlier Q tiles
    // see nothing of this K tile
    const int first_row = k0 - (p.tk - p.tq);
    t0 = first_row <= 0 ? 0 : first_row / BQ;
  }

  for (int t = t0; t < n_q; ++t) {
    const int q0 = t * BQ;
    __syncthreads();  // the previous tile's readers are done
    load_tile<BQ, D, false>(Qs, D + 1, qg, p.sq[2], q0, p.tq, rnd);
    load_tile<BQ, D, false>(dOs, D + 1, dog, p.sdo[2], q0, p.tq, rnd);
    for (int r = tid; r < BQ; r += NT) {
      const int qi = q0 + r;
      const bool in = qi < p.tq;
      Ls[r] = in ? lg[(int64_t)qi * p.sl[2]] : 0.f;
      Dl[r] = in ? dlg[(int64_t)qi * p.sdl[2]] : 0.f;
    }
    __syncthreads();

    float s[4][4], dp[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = dp[i][j] = 0.f;
#pragma unroll 4
    for (int d = 0; d < D; ++d) {
      float a[4], g[4], bk[4], bv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        a[i] = Qs[(ty * 4 + i) * (D + 1) + d];
        g[i] = dOs[(ty * 4 + i) * (D + 1) + d];
      }
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        bk[j] = Ks[(tx + 16 * j) * (D + 1) + d];
        bv[j] = Vs[(tx + 16 * j) * (D + 1) + d];
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          s[i][j] = fmaf(a[i], bk[j], s[i][j]);
          dp[i][j] = fmaf(g[i], bv[j], dp[i][j]);
        }
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = ty * 4 + i;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int c = tx + 16 * j;
        float pr = 0.f, ds = 0.f;
        if (kept(p, q0 + r, k0 + c)) {
          pr = expf(s[i][j] * p.scale - Ls[r]);
          ds = pr * (dp[i][j] - Dl[r]) * p.scale;
          if (rnd) {
            pr = round_bf16(pr);
            ds = round_bf16(ds);
          }
        }
        Ps[r * (BK + 1) + c] = pr;
        dSs[r * (BK + 1) + c] = ds;
      }
    }
    __syncthreads();

    // dV += P^T dO, dK += dS^T Q
#pragma unroll 2
    for (int r = 0; r < BQ; ++r) {
      const float pw = Ps[r * (BK + 1) + col];
      const float dw = dSs[r * (BK + 1) + col];
      const float* qrow = Qs + r * (D + 1) + sub;
      const float* gorow = dOs + r * (D + 1) + sub;
#pragma unroll
      for (int j = 0; j < D / 4; ++j) {
        acc_v[j] = fmaf(pw, gorow[4 * j], acc_v[j]);
        acc_k[j] = fmaf(dw, qrow[4 * j], acc_k[j]);
      }
    }
  }

  const int kk = k0 + col;
  if (kk < p.tk) {
    T* dkg = static_cast<T*>(p.dk) + b * p.sdk[0] + h * p.sdk[1] +
             (int64_t)kk * p.sdk[2];
    T* dvg = static_cast<T*>(p.dv) + b * p.sdv[0] + h * p.sdv[1] +
             (int64_t)kk * p.sdv[2];
#pragma unroll
    for (int j = 0; j < D / 4; ++j) {
      store(dkg + sub + 4 * j, acc_k[j]);
      store(dvg + sub + 4 * j, acc_v[j]);
    }
  }
}

enum Which { DQ = 0, DKV = 1 };

template <int D, typename T>
cudaError_t launch(const Params& p, Which which, int bh,
                   cudaStream_t stream) {
  const bool dq = which == DQ;
  const size_t smem =
      (dq ? dq_smem_floats<D>() : dkv_smem_floats<D>()) * sizeof(float);
  const void* fn = dq ? reinterpret_cast<const void*>(
                            flash_bwd_dq_kernel<D, T>)
                      : reinterpret_cast<const void*>(
                            flash_bwd_dkv_kernel<D, T>);
  cudaError_t err = cudaFuncSetAttribute(
      fn, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  if (dq) {
    const dim3 grid((p.tq + BQ - 1) / BQ, bh);
    flash_bwd_dq_kernel<D, T><<<grid, NT, smem, stream>>>(p);
  } else {
    const dim3 grid((p.tk + BK - 1) / BK, bh);
    flash_bwd_dkv_kernel<D, T><<<grid, NT, smem, stream>>>(p);
  }
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_d(const Params& p, Which which, int d, int bh,
                     cudaStream_t stream) {
  switch (d) {
    case 32: return launch<32, T>(p, which, bh, stream);
    case 64: return launch<64, T>(p, which, bh, stream);
    case 128: return launch<128, T>(p, which, bh, stream);
    default: return cudaErrorInvalidValue;
  }
}

int run(Which which, const void* const* ptrs, int batch, int heads, int tq,
        int tk, int d, const int64_t* strides, float scale, int causal,
        int mxu_bf16, int dtype, void* stream) {
  Params p;
  p.q = ptrs[0];
  p.k = ptrs[1];
  p.v = ptrs[2];
  p.dout = ptrs[3];
  p.lse = static_cast<const float*>(ptrs[4]);
  p.delta = static_cast<const float*>(ptrs[5]);
  p.dq = const_cast<void*>(ptrs[6]);
  p.dk = const_cast<void*>(ptrs[7]);
  p.dv = const_cast<void*>(ptrs[8]);
  p.heads = heads;
  p.tq = tq;
  p.tk = tk;
  int64_t* dst[9] = {p.sq, p.sk, p.sv, p.sdo, p.sl, p.sdl,
                     p.sdq, p.sdk, p.sdv};
  for (int t = 0; t < 9; ++t)
    for (int i = 0; i < 3; ++i) dst[t][i] = strides[3 * t + i];
  p.scale = scale;
  p.causal = causal;
  p.mxu_bf16 = mxu_bf16;
  const int bh = batch * heads;
  if (bh == 0 || (which == DQ ? tq : tk) == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (dtype == 0) {
    err = launch_d<float>(p, which, d, bh, s);
  } else if (dtype == 1) {
    err = launch_d<__nv_bfloat16>(p, which, d, bh, s);
  } else {
    err = cudaErrorInvalidValue;
  }
  return static_cast<int>(err);
}

}  // namespace

extern "C" {

// ptrs: q, k, v, dout, lse, delta, dq, dk, dv (device pointers).
// strides: 27 int64 element strides, (batch, head, time) for each of the
// nine in that order. dtype: 0 = float32, 1 = bfloat16 (q, k, v, dout and
// the gradients; lse and delta are float32). Each returns the CUDA error
// of its launch (0 on success) and never synchronises.
int flash_bwd_dq(const void* const* ptrs, int batch, int heads, int tq,
                 int tk, int d, const int64_t* strides, float scale,
                 int causal, int mxu_bf16, int dtype, void* stream) {
  return run(DQ, ptrs, batch, heads, tq, tk, d, strides, scale, causal,
             mxu_bf16, dtype, stream);
}

int flash_bwd_dkv(const void* const* ptrs, int batch, int heads, int tq,
                  int tk, int d, const int64_t* strides, float scale,
                  int causal, int mxu_bf16, int dtype, void* stream) {
  return run(DKV, ptrs, batch, heads, tq, tk, d, strides, scale, causal,
             mxu_bf16, dtype, stream);
}

const char* flash_bwd_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
