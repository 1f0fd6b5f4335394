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
// ~100 MB in fp32, ~0.03 ms at 3.35 TB/s. Both kernels run on the tensor
// cores, in fp32 as three TF32 passes (495/3 = 165 TFLOP/s; 67 TFLOP/s is
// the FMA figure). dK/dV runs four of the products (17.2 GFLOP): 0.10 ms
// at 165 TFLOP/s (0.26 ms on FMA), 0.017 ms at 989 TFLOP/s in bf16
// against ~0.02 ms of bytes. dQ runs three (S, dP, dQ; 12.9 GFLOP): 0.078
// ms at 165 TFLOP/s (0.19 ms on FMA), 0.013 ms in bf16 against ~84 MB,
// 0.025 ms, in fp32 (half in bf16). Operations bound both in fp32; in
// bf16 operations and bytes are about level. (Data-sheet figures,
// reckoned, not measured.)
//
// Design (building blocks in attn_tiles.cuh):
// - dQ: the forward's arrangement with one more product. One CTA per
//   (batch*head, Q tile), the last (heaviest causal) Q tiles first; each
//   warp owns 16 query rows. Q and dO stay in shared memory; K and V
//   stream through a two-stage ring filled by 16-byte cp.async up to the
//   causal bound, the next tile's copy issued before this tile's
//   products. Each warp computes S = Q K^T and dP = dO V^T in mma.sync
//   registers, forms P (base 2, masked p an exact 0) and dS there, and
//   accumulates dQ += dS K in registers, dS going from the accumulator
//   straight into the A operand and K read as a B operand by rows, as V
//   is in the forward's P V: no score tile touches shared memory. A
//   warp skips a key tile that all its rows mask. The lse and delta of a
//   thread's two rows sit in registers. Tiles: fp32 at hd 128 takes 8
//   warps (128 rows) and 32-key stages, one CTA per SM (Q and dO 135 KB,
//   the ring 68 KB), as dK/dV does; elsewhere 4 warps and 64-key stages,
//   two CTAs per SM.
// - dK/dV: one CTA per (batch*head, key tile), the first (heaviest
//   causal) key tiles first. K and V stay in shared memory; the live Q
//   tiles, from the first whose rows can see this K tile (the reference's
//   clamp, _q_index_map :130, qi_map :896), stream with their dO, lse and delta
//   through a two-stage ring filled by 16-byte cp.async, the next tile's
//   copy issued before this tile's products. Each warp owns 16 keys and
//   computes S^T = K Q^T and dP^T = V dO^T in mma.sync registers, forms
//   P^T and dS^T there and accumulates dV += P^T dO, dK += dS^T Q in
//   registers, P^T and dS^T going from the accumulators straight into the
//   A operands. The transposed operands thus cost nothing: Q and dO are
//   read as B fragments, by rows for S^T and dP^T and by columns for dK
//   and dV (ldmatrix.trans for bf16 tiles). Tiles: 32 query rows a
//   stage; for fp32, 8 warps and 128 keys a CTA (K and V 135 KB plus two
//   stages of Q and dO 68 KB at hd 128: one CTA of 8 warps per SM, the Q
//   tiles shared by all 8), for bf16 4 warps and 64 keys (68 KB at hd
//   128). A warp holds dK and dV (2 x 16 x hd fp32) and S^T, dP^T
//   (2 x 16 x 32) in registers: 252 of them at hd 128 in fp32, no
//   spills.
// - Products, both kernels: fp32 runs 3xTF32 (m16n8k8), mxu_bf16 and
//   bf16 inputs bf16 m16n8k16 (dS, and P for dV, rounded to bf16 once);
//   for bf16 inputs without mxu_bf16, P and dS run as two bf16 products
//   each (hi + lo), since the reference keeps them in fp32 and casts k
//   and dO to fp32 (:320-323).
// - Nothing is reduced across CTAs: no atomics, a fixed summation order,
//   so the gradients are bitwise equal run to run.

#include "attn_tiles.cuh"

namespace {

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

// ---- dQ: tensor cores, a ring of K/V tiles (attn_tiles.cuh) -------------

template <int D, typename T>
struct DqCfg {
  // fp32 at hd 128: 8 warps share each K/V stage (one CTA per SM, as
  // dK/dV); elsewhere 4 warps, two or more CTAs per SM
  static constexpr bool WIDE = D == 128 && sizeof(T) == 4;
  static constexpr int WARPS = WIDE ? 8 : 4;
  static constexpr int BQ = 16 * WARPS;  // query rows per CTA, 16 per warp
  static constexpr int NT = 32 * WARPS;
  static constexpr int BK = WIDE ? 32 : 64;  // keys per stage
  static constexpr int LD = attn::Tile<D, T>::LD;
  static constexpr size_t SMEM = sizeof(T) * LD * (2 * BQ + 4 * BK);
};

// One CTA per (batch*head, Q tile), the last (heaviest causal) Q tiles
// first. Q and dO stay in shared memory; the live K/V tiles stream
// through a two-stage ring filled by cp.async. Each warp owns 16 query
// rows: it recomputes S = Q K^T and dP = dO V^T in MMA registers, forms P
// and dS there, and accumulates dQ += dS K in MMA registers, the
// register-resident dS being the A operand (attn_tiles.cuh, mma_pv).
template <int D, typename T, int MODE>
__global__ void __launch_bounds__((DqCfg<D, T>::NT))
    flash_bwd_dq_kernel(const Params p) {
  using namespace attn;
  constexpr int BQ = DqCfg<D, T>::BQ, BK = DqCfg<D, T>::BK;
  constexpr int LD = DqCfg<D, T>::LD, DQ_NT = DqCfg<D, T>::NT;
  constexpr int NJ = BK / 8;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* Qs = reinterpret_cast<T*>(smem_raw);  // [BQ][LD]
  T* dOs = Qs + BQ * LD;                   // [BQ][LD]
  T* Ks = dOs + BQ * LD;                   // [2][BK][LD]
  T* Vs = Ks + 2 * BK * LD;                // [2][BK][LD]

  const int bh = blockIdx.x;
  const int b = bh / p.heads, h = bh % p.heads;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * BQ;  // heaviest first
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

  const int n_tiles = live_key_tiles(q0, BQ, BK, p.tk, shift, causal);
  load_rows_async<BQ, D, DQ_NT>(Qs, qg, p.sq[2], q0, p.tq);
  load_rows_async<BQ, D, DQ_NT>(dOs, dog, p.sdo[2], q0, p.tq);
  if (n_tiles > 0) {
    load_rows_async<BK, D, DQ_NT>(Ks, kg, p.sk[2], 0, p.tk);
    load_rows_async<BK, D, DQ_NT>(Vs, vg, p.sv[2], 0, p.tk);
  }
  cp_async_commit();

  const int qw = q0 + warp * 16;  // the warp's first row
  const int r0 = qw + g;          // this thread's rows: r0 and r0 + 8
  // lse (in base 2) and delta of the thread's two rows
  float lse2[2], dl[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int qi = r0 + 8 * r;
    const bool in = qi < p.tq;
    lse2[r] = in ? kLog2e * p.lse[b * p.sl[0] + h * p.sl[1] +
                                  (int64_t)qi * p.sl[2]]
                 : 0.f;
    dl[r] = in ? p.delta[b * p.sdl[0] + h * p.sdl[1] +
                         (int64_t)qi * p.sdl[2]]
               : 0.f;
  }
  float acc[D / 8][4];
#pragma unroll
  for (int n = 0; n < D / 8; ++n)
    acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;

  for (int t = 0; t < n_tiles; ++t) {
    const int st = t & 1;
    if (t + 1 < n_tiles) {  // the next tile's copy overlaps this one's math
      const int nx = (t + 1) & 1, k1 = (t + 1) * BK;
      load_rows_async<BK, D, DQ_NT>(Ks + nx * BK * LD, kg, p.sk[2], k1,
                                    p.tk);
      load_rows_async<BK, D, DQ_NT>(Vs + nx * BK * LD, vg, p.sv[2], k1,
                                    p.tk);
    }
    cp_async_commit();
    cp_async_wait<1>();  // everything but the newest group has landed
    __syncthreads();

    const int k0 = t * BK;
    // a warp whose rows are all past Tq or all before this tile's first
    // key (causal) has nothing to add
    if (qw < p.tq && (!causal || k0 <= qw + 15 + shift)) {
      const T* Kt = Ks + st * BK * LD;
      float s[NJ][4], dp[NJ][4];
#pragma unroll
      for (int j = 0; j < NJ; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[j][e] = dp[j][e] = 0.f;
      mma_abt<MODE, D, NJ>(s, Qs + warp * 16 * LD, Kt);
      mma_abt<MODE, D, NJ>(dp, dOs + warp * 16 * LD, Vs + st * BK * LD);

      // P and dS in place; masked pairs are an exact 0 (on a row with no
      // key exp(s - lse) is not small, so the mask is explicit)
      const bool edge =
          k0 + BK > p.tk || (causal && k0 + BK - 1 > qw + shift);
#pragma unroll
      for (int j = 0; j < NJ; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int kk = k0 + 8 * j + 2 * t4 + (e & 1);
          const int r = e >> 1, qi = r0 + 8 * r;
          const bool ok =
              !edge || (kk < p.tk && (!causal || kk <= qi + shift));
          // exp(s * scale - lse) in base 2
          const float pr =
              ok ? exp2_fast(fmaf(s[j][e], scale2, -lse2[r])) : 0.f;
          dp[j][e] = pr * (dp[j][e] - dl[r]) * p.scale;
        }

      mma_pv<MODE, D, NJ>(acc, dp, Kt, split);  // dQ += dS K
    }
    __syncthreads();  // every warp is done with stage st
  }
  cp_async_wait<0>();

  T* dqg = static_cast<T*>(p.dq) + b * p.sdq[0] + h * p.sdq[1];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int qi = r0 + 8 * r;
    if (qi >= p.tq) continue;
    T* dqrow = dqg + (int64_t)qi * p.sdq[2] + 2 * t4;
#pragma unroll
    for (int n = 0; n < D / 8; ++n)
      store2(dqrow + 8 * n, acc[n][2 * r], acc[n][2 * r + 1]);
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

template <int D, typename T, int MODE>
cudaError_t launch_dq(const Params& p, int bh, cudaStream_t stream) {
  const size_t smem = DqCfg<D, T>::SMEM;
  cudaError_t err = cudaFuncSetAttribute(
      flash_bwd_dq_kernel<D, T, MODE>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  // Q tiles on y, run last to first: the heaviest causal tiles start first
  constexpr int BQ = DqCfg<D, T>::BQ, THREADS = DqCfg<D, T>::NT;
  const dim3 grid(bh, (p.tq + BQ - 1) / BQ);
  flash_bwd_dq_kernel<D, T, MODE><<<grid, THREADS, smem, stream>>>(p);
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

template <int D, typename T, int MODE>
cudaError_t launch_mode(const Params& p, Which which, int bh,
                        cudaStream_t stream) {
  return which == DQ ? launch_dq<D, T, MODE>(p, bh, stream)
                     : launch_dkv<D, T, MODE>(p, bh, stream);
}

template <int D>
cudaError_t launch(const Params& p, Which which, int dtype, int bh,
                   cudaStream_t stream) {
  if (dtype == 1) {
    return launch_mode<D, __nv_bfloat16, attn::BF16>(p, which, bh, stream);
  }
  if (p.mxu_bf16) {
    return launch_mode<D, float, attn::BF16>(p, which, bh, stream);
  }
  return launch_mode<D, float, attn::TF32X3>(p, which, bh, stream);
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
