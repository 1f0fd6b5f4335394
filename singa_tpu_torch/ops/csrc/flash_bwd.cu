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
// What bounds them on this card, at gpt_medium's shape (B 4, T 1024, H 8,
// hd 128, causal): the five products on the kept pairs are 10*B*H*pairs*D
// = 21.5 GFLOP; q, k, v, O, dO, lse, delta in and dq, dk, dv out are
// ~100 MB in fp32, ~0.03 ms at 3.35 TB/s. dK/dV alone runs four of the
// products (17.2 GFLOP): 0.10 ms at 165 TFLOP/s (three TF32 passes on the
// tensor cores, the units it uses in fp32; 0.26 ms at the 67 TFLOP/s of
// FMA), 0.017 ms at 989 TFLOP/s in bf16 against ~0.02 ms of bytes. dQ runs
// three (S, dP, dQ) on FMA: 0.19 ms at 67 TFLOP/s. Operations bound both
// in fp32. (Data-sheet figures, reckoned, not measured.)
//
// Design:
// - dQ (first, simple version, FMA in fp32): one CTA of 256 threads per
//   (batch*head, 64-row Q tile). Q, dO, the tile's lse and delta stay in
//   shared memory; a loop over the live 64-key K/V tiles (it stops at the
//   causal bound, as the forward does) stages K^T and V^T, computes S and
//   dP as 4x4 register micro-tiles per thread, writes dS to shared memory
//   and accumulates dQ = dS K in registers (each row's D columns spread
//   over 4 adjacent lanes). 150 KB of shared memory at hd 128.
// - dK/dV (tensor cores; building blocks in attn_tiles.cuh): one CTA of 4
//   warps per (batch*head, 64-key tile), the first (heaviest causal) key
//   tiles first. K and V stay in shared memory; the live Q tiles, from the
//   first whose rows can see this K tile (the reference's clamp,
//   _q_index_map :130, qi_map :896), stream with their dO, lse and delta
//   through a two-stage ring filled by 16-byte cp.async, the next tile's
//   copy issued before this tile's products. Each warp owns 16 keys and
//   computes S^T = K Q^T and dP^T = V dO^T in mma.sync registers, forms
//   P^T and dS^T there and accumulates dV += P^T dO, dK += dS^T Q in
//   registers, P^T and dS^T going from the accumulators straight into the
//   A operands. The transposed operands thus cost nothing: Q and dO are
//   read as B fragments, by rows for S^T and dP^T and by columns for dK
//   and dV (ldmatrix.trans for bf16 tiles). fp32 runs 3xTF32 (m16n8k8),
//   mxu_bf16 and bf16 inputs bf16 m16n8k16; for bf16 inputs without
//   mxu_bf16, P^T and dS^T run as two bf16 products each (hi + lo), since
//   the reference keeps them in fp32. Tiles: 32 query rows a stage; for
//   fp32, 8 warps and 128 keys a CTA (K and V 135 KB plus two stages of Q
//   and dO 68 KB at hd 128: one CTA of 8 warps per SM, the Q tiles shared
//   by all 8), for bf16 4 warps and 64 keys (68 KB at hd 128). A warp
//   holds dK and dV (2 x 16 x hd fp32) and S^T, dP^T (2 x 16 x 32) in
//   registers: 252 of them at hd 128 in fp32, no spills.
// - Nothing is reduced across CTAs: no atomics, a fixed summation order,
//   so the gradients are bitwise equal run to run.

#include "attn_tiles.cuh"

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

// ---- dK/dV: tensor cores, a ring of Q/dO tiles (attn_tiles.cuh) ----------

template <int D, typename T>
struct DkvCfg {
  // fp32 tiles: 8 warps share each Q/dO stage (one CTA per SM at hd 128);
  // bf16 tiles: 4 warps, two or more CTAs per SM
  static constexpr int WARPS = sizeof(T) == 4 ? 8 : 4;
  static constexpr int BK = 16 * WARPS;  // keys per CTA, 16 per warp
  static constexpr int NT = 32 * WARPS;
  static constexpr int BQ = 32;          // query rows per stage
  static constexpr int LD = attn::Tile<D, T>::LD;
  static constexpr size_t SMEM =
      sizeof(T) * LD * (2 * BK + 4 * BQ) + sizeof(float) * 4 * BQ;
};

// One CTA per (batch*head, key tile), the first (heaviest causal) key
// tiles first. K and V stay in shared memory; the live Q tiles stream
// through a two-stage ring of Q, dO, lse and delta filled by cp.async.
// Each warp owns 16 keys: it recomputes S^T = K Q^T and dP^T = V dO^T in
// MMA registers, forms P^T and dS^T there, and accumulates
// dV += P^T dO and dK += dS^T Q in MMA registers, the register-resident
// P^T and dS^T being the A operands (attn_tiles.cuh, mma_pv).
template <int D, typename T, int MODE>
__global__ void __launch_bounds__((DkvCfg<D, T>::NT))
    flash_bwd_dkv_kernel(const Params p) {
  using namespace attn;
  constexpr int BQ = DkvCfg<D, T>::BQ, LD = DkvCfg<D, T>::LD;
  constexpr int DKV_BK = DkvCfg<D, T>::BK, DKV_NT = DkvCfg<D, T>::NT;
  constexpr int NJ = BQ / 8;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* Ks = reinterpret_cast<T*>(smem_raw);  // [DKV_BK][LD]
  T* Vs = Ks + DKV_BK * LD;                // [DKV_BK][LD]
  T* Qs = Vs + DKV_BK * LD;                // [2][BQ][LD]
  T* dOs = Qs + 2 * BQ * LD;               // [2][BQ][LD]
  float* Ls = reinterpret_cast<float*>(dOs + 2 * BQ * LD);  // [2][BQ]
  float* Dl = Ls + 2 * BQ;                                  // [2][BQ]

  const int bh = blockIdx.x;
  const int b = bh / p.heads, h = bh % p.heads;
  const int k0 = blockIdx.y * DKV_BK;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t4 = lane & 3;
  const int shift = p.tk - p.tq;
  const bool causal = p.causal != 0;
  const bool split = p.mxu_bf16 == 0;
  constexpr float kLog2e = 1.4426950408889634f;
  const float scale2 = p.scale * kLog2e;

  const T* qg = static_cast<const T*>(p.q) + b * p.sq[0] + h * p.sq[1];
  const T* kg = static_cast<const T*>(p.k) + b * p.sk[0] + h * p.sk[1];
  const T* vg = static_cast<const T*>(p.v) + b * p.sv[0] + h * p.sv[1];
  const T* dog =
      static_cast<const T*>(p.dout) + b * p.sdo[0] + h * p.sdo[1];
  const float* lg = p.lse + b * p.sl[0] + h * p.sl[1];
  const float* dlg = p.delta + b * p.sdl[0] + h * p.sdl[1];

  const int n_q = (p.tq + BQ - 1) / BQ;
  const int t0 = first_query_tile(k0, BQ, shift, causal);

  auto load_q_tile = [&](int t, int st) {
    const int q0 = t * BQ;
    load_rows_async<BQ, D, DKV_NT>(Qs + st * BQ * LD, qg, p.sq[2], q0, p.tq);
    load_rows_async<BQ, D, DKV_NT>(dOs + st * BQ * LD, dog, p.sdo[2], q0,
                                   p.tq);
    load_vec_async<BQ, DKV_NT>(Ls + st * BQ, lg, p.sl[2], q0, p.tq);
    load_vec_async<BQ, DKV_NT>(Dl + st * BQ, dlg, p.sdl[2], q0, p.tq);
  };
  load_rows_async<DKV_BK, D, DKV_NT>(Ks, kg, p.sk[2], k0, p.tk);
  load_rows_async<DKV_BK, D, DKV_NT>(Vs, vg, p.sv[2], k0, p.tk);
  if (t0 < n_q) load_q_tile(t0, 0);
  cp_async_commit();

  const int kw = k0 + warp * 16;  // the warp's first key
  const int kr = kw + g;          // this thread's keys: kr and kr + 8
  float acc_k[D / 8][4], acc_v[D / 8][4];
#pragma unroll
  for (int n = 0; n < D / 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc_k[n][e] = acc_v[n][e] = 0.f;

  for (int t = t0; t < n_q; ++t) {
    const int st = (t - t0) & 1;
    if (t + 1 < n_q) load_q_tile(t + 1, st ^ 1);
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();

    const int q0 = t * BQ;
    const T* Qt = Qs + st * BQ * LD;
    const T* dOt = dOs + st * BQ * LD;
    const float* Lt = Ls + st * BQ;
    const float* Dt = Dl + st * BQ;
    float s[NJ][4], dp[NJ][4];
#pragma unroll
    for (int j = 0; j < NJ; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = dp[j][e] = 0.f;
    // S^T and dP^T: 2 x NJ independent accumulator chains, so the cross
    // terms share them (register room goes to the 32-row Q tile)
    mma_abt<MODE, D, NJ, T, false>(s, Ks + warp * 16 * LD, Qt);
    mma_abt<MODE, D, NJ, T, false>(dp, Vs + warp * 16 * LD, dOt);

    // P^T and dS^T in place; masked pairs are an exact 0 (on a row with no
    // key exp(s - lse) is not small, so the mask is explicit)
    const bool edge = q0 + BQ > p.tq || kw + 16 > p.tk ||
                      (causal && kw + 15 > q0 + shift);
#pragma unroll
    for (int j = 0; j < NJ; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int ql = 8 * j + 2 * t4 + (e & 1);
        const int qi = q0 + ql, kk = kr + (e >> 1) * 8;
        const bool ok = !edge || (qi < p.tq && kk < p.tk &&
                                  (!causal || kk <= qi + shift));
        // exp(s * scale - lse) in base 2
        const float pr =
            ok ? exp2_fast(fmaf(s[j][e], scale2, -Lt[ql] * kLog2e)) : 0.f;
        s[j][e] = pr;
        dp[j][e] = pr * (dp[j][e] - Dt[ql]) * p.scale;
      }

    mma_pv<MODE, D, NJ>(acc_v, s, dOt, split);   // dV += P^T dO
    mma_pv<MODE, D, NJ>(acc_k, dp, Qt, split);   // dK += dS^T Q
    __syncthreads();  // every warp is done with stage st
  }
  cp_async_wait<0>();

  T* dkg = static_cast<T*>(p.dk) + b * p.sdk[0] + h * p.sdk[1];
  T* dvg = static_cast<T*>(p.dv) + b * p.sdv[0] + h * p.sdv[1];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int kk = kr + 8 * r;
    if (kk >= p.tk) continue;
    T* dkrow = dkg + (int64_t)kk * p.sdk[2] + 2 * t4;
    T* dvrow = dvg + (int64_t)kk * p.sdv[2] + 2 * t4;
#pragma unroll
    for (int n = 0; n < D / 8; ++n) {
      store2(dkrow + 8 * n, acc_k[n][2 * r], acc_k[n][2 * r + 1]);
      store2(dvrow + 8 * n, acc_v[n][2 * r], acc_v[n][2 * r + 1]);
    }
  }
}

enum Which { DQ = 0, DKV = 1 };

template <int D, typename T>
cudaError_t launch_dq(const Params& p, int bh, cudaStream_t stream) {
  const size_t smem = dq_smem_floats<D>() * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      flash_bwd_dq_kernel<D, T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const dim3 grid((p.tq + BQ - 1) / BQ, bh);
  flash_bwd_dq_kernel<D, T><<<grid, NT, smem, stream>>>(p);
  return cudaGetLastError();
}

template <int D, typename T, int MODE>
cudaError_t launch_dkv(const Params& p, int bh, cudaStream_t stream) {
  const size_t smem = DkvCfg<D, T>::SMEM;
  cudaError_t err = cudaFuncSetAttribute(
      flash_bwd_dkv_kernel<D, T, MODE>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  // key tiles on y: all (batch, head) of the first, heaviest tile start
  // first
  constexpr int BK = DkvCfg<D, T>::BK, THREADS = DkvCfg<D, T>::NT;
  const dim3 grid(bh, (p.tk + BK - 1) / BK);
  flash_bwd_dkv_kernel<D, T, MODE><<<grid, THREADS, smem, stream>>>(p);
  return cudaGetLastError();
}

template <int D>
cudaError_t launch(const Params& p, Which which, int dtype, int bh,
                   cudaStream_t stream) {
  if (which == DQ) {
    return dtype == 1 ? launch_dq<D, __nv_bfloat16>(p, bh, stream)
                      : launch_dq<D, float>(p, bh, stream);
  }
  if (dtype == 1) {
    return launch_dkv<D, __nv_bfloat16, attn::BF16>(p, bh, stream);
  }
  if (p.mxu_bf16) return launch_dkv<D, float, attn::BF16>(p, bh, stream);
  return launch_dkv<D, float, attn::TF32X3>(p, bh, stream);
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
  if (dtype != 0 && dtype != 1) return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  switch (d) {
    case 32: err = launch<32>(p, which, dtype, bh, s); break;
    case 64: err = launch<64>(p, which, dtype, bh, s); break;
    case 128: err = launch<128>(p, which, dtype, bh, s); break;
    default: err = cudaErrorInvalidValue;
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
