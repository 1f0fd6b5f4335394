// Flash-attention forward for Hopper (sm_90a), CUDA C++ with a plain C
// interface (loaded with ctypes by singa_tpu_torch/ops/flash_attention.py).
//
// Replaces both forward Pallas kernels of singa_tpu/ops/flash_attention.py:
//   _fwd_kernel / _make_fwd          (:164, pallas_call at :263), head-split
//                                    (B*H, T, D) layout;
//   _fwd_kernel_qkv / _make_fwd_qkv  (:590, pallas_call at :829), fused
//                                    (B, T, 3*H*hd) in, (B, T, H*hd) out.
// One kernel serves both: it takes element strides for (batch, head, time)
// of q, k, v, o and lse, so the fused layout is q/k/v at column offsets
// 0, d, 2d of one buffer with time stride 3d, and the head-split layout is
// contiguous (B, H, T, D). Neither is copied or transposed.
//
// The function is the TPU kernel's: scores q.k^T * scale in fp32; an online
// softmax with running max m and sum l per row; masked p is an exact 0
// (masked scores are -1e30); keys past Tk are masked; causal is
// k <= q + (Tk - Tq) (bottom-right); l is clamped at 1e-30, so a row with
// nothing to attend outputs 0; O is written in the input dtype and
// lse = m + log(l) as fp32. With mxu_bf16 the q, k, v and p operands are
// rounded to bf16 before each product, with fp32 accumulation (_op, :97).
//
// What bounds it on this card, at gpt_medium's shape (B 4, T 1024, H 8,
// hd 128, causal): the two products on the kept pairs are 8.6 GFLOP. In
// fp32 they run as three TF32 passes on the tensor cores, 495/3 = 165
// TFLOP/s, so 52 us, against 20 us for the 67 MB of q, k, v in and O out
// at 3.35 TB/s: operations. In bf16 (989 TFLOP/s, 8.7 us) the 34 MB take
// 10 us: bytes, nearly level. (Data-sheet figures, reckoned, not measured.)
//
// Design (attn_tiles.cuh holds the building blocks):
// - One CTA of 4 warps per (batch*head, 64-row Q tile); each warp owns 16
//   query rows (the FA2 arrangement). The grid runs the last, heaviest
//   causal Q tiles first.
// - Q and a two-stage ring of K/V tiles sit in dynamic shared memory,
//   filled by 16-byte cp.async; the copy of tile t+1 is issued before the
//   products of tile t. bf16 tiles stay bf16; fp32 tiles stay fp32 and
//   are split into TF32 hi/lo as fragments are read.
// - S = Q K^T accumulates in mma.sync registers; the online softmax runs
//   on the accumulator fragments with quad shuffles, and P goes from the
//   S accumulator straight into the A operand of P V (for TF32 by taking
//   the keys of each k-step in a permuted order, see attn_tiles.cuh), so
//   the score tile never touches shared memory. O accumulates in
//   registers.
// - Products: fp32 with mxu_bf16 off runs 3xTF32 (m16n8k8), the cross
//   terms of S summing in registers of their own so that three MMA
//   chains per tile are in flight; mxu_bf16 and bf16 inputs run bf16
//   m16n8k16. For bf16 inputs without mxu_bf16 the reference keeps p in
//   fp32, so P V runs as two bf16 products of p = p_hi + p_lo.
// - The softmax runs in base 2 on ex2.approx (scores scaled by
//   scale * log2(e)); lse goes back to natural units.
// - Tile sizes: 64 keys per stage, 32 at hd 128 in fp32, so that two CTAs
//   fit on an SM (about 100 KB of shared memory each in that case).

#include "attn_tiles.cuh"

namespace {

using namespace attn;

constexpr int BQ = 64;   // query rows per CTA, 16 per warp
constexpr int NT = 128;  // threads per CTA

struct Params {
  const void* q;
  const void* k;
  const void* v;
  void* o;
  float* lse;
  int heads, tq, tk;
  // element strides for (batch, head, time); the last dim is contiguous
  int64_t sq[3], sk[3], sv[3], so[3], sl[3];
  float scale;
  int causal, mxu_bf16;
};

template <int D, typename T>
struct Cfg {
  static constexpr int BK = (D == 128 && sizeof(T) == 4) ? 32 : 64;
  static constexpr int LD = Tile<D, T>::LD;
  static constexpr size_t SMEM = sizeof(T) * LD * (BQ + 4 * BK);
};

template <int D, typename T, int MODE>
__global__ void __launch_bounds__(NT) flash_fwd_kernel(const Params p) {
  constexpr int BK = Cfg<D, T>::BK, LD = Cfg<D, T>::LD, NJ = BK / 8;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* Qs = reinterpret_cast<T*>(smem_raw);
  T* Ks = Qs + BQ * LD;       // [2][BK][LD]
  T* Vs = Ks + 2 * BK * LD;   // [2][BK][LD]

  const int bh = blockIdx.x;
  const int b = bh / p.heads, h = bh % p.heads;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * BQ;  // heaviest first
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t4 = lane & 3;
  const int shift = p.tk - p.tq;  // bottom-right causal alignment
  const bool causal = p.causal != 0;
  const bool split = p.mxu_bf16 == 0;
  // the softmax runs in base 2: scores in units of log2(e)
  const float scale2 = p.scale * 1.4426950408889634f;

  const T* qg = static_cast<const T*>(p.q) + b * p.sq[0] + h * p.sq[1];
  const T* kg = static_cast<const T*>(p.k) + b * p.sk[0] + h * p.sk[1];
  const T* vg = static_cast<const T*>(p.v) + b * p.sv[0] + h * p.sv[1];

  const int n_tiles = live_key_tiles(q0, BQ, BK, p.tk, shift, causal);

  load_rows_async<BQ, D, NT>(Qs, qg, p.sq[2], q0, p.tq);
  if (n_tiles > 0) {
    load_rows_async<BK, D, NT>(Ks, kg, p.sk[2], 0, p.tk);
    load_rows_async<BK, D, NT>(Vs, vg, p.sv[2], 0, p.tk);
  }
  cp_async_commit();

  // this thread's two rows of the warp's 16: g and g + 8
  const int r0 = q0 + warp * 16 + g;
  float m[2] = {NEG, NEG}, l[2] = {0.f, 0.f};
  float acc[D / 8][4];
#pragma unroll
  for (int n = 0; n < D / 8; ++n)
    acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;

  for (int t = 0; t < n_tiles; ++t) {
    const int st = t & 1;
    if (t + 1 < n_tiles) {  // the next tile's copy overlaps this one's math
      const int nx = (t + 1) & 1, k1 = (t + 1) * BK;
      load_rows_async<BK, D, NT>(Ks + nx * BK * LD, kg, p.sk[2], k1, p.tk);
      load_rows_async<BK, D, NT>(Vs + nx * BK * LD, vg, p.sv[2], k1, p.tk);
    }
    cp_async_commit();
    cp_async_wait<1>();  // everything but the newest group has landed
    __syncthreads();

    const int k0 = t * BK;
    float s[NJ][4];
#pragma unroll
    for (int j = 0; j < NJ; ++j) s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
    mma_abt<MODE, D, NJ>(s, Qs + warp * 16 * LD, Ks + st * BK * LD);

    // scale, mask (only where a tile crosses the edge or the diagonal)
    const bool edge = k0 + BK > p.tk ||
                      (causal && k0 + BK - 1 > q0 + warp * 16 + shift);
#pragma unroll
    for (int j = 0; j < NJ; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int kk = k0 + 8 * j + 2 * t4 + (e & 1);
        const int qi = r0 + (e >> 1) * 8;
        const bool ok =
            !edge || (kk < p.tk && (!causal || kk <= qi + shift));
        s[j][e] = ok ? s[j][e] * scale2 : NEG;
      }

    // online softmax on the fragments: each row lives in one lane quad
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      float mx = NEG;
#pragma unroll
      for (int j = 0; j < NJ; ++j)
        mx = fmaxf(mx, fmaxf(s[j][2 * r], s[j][2 * r + 1]));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      const float m_new = fmaxf(m[r], mx);
      const float corr = exp2_fast(m[r] - m_new);
      float ls = 0.f;
#pragma unroll
      for (int j = 0; j < NJ; ++j)
#pragma unroll
        for (int e = 2 * r; e < 2 * r + 2; ++e) {
          // masked: an exact 0 (a row with no key has m_new = NEG too)
          const float x = s[j][e];
          const float pe = x == NEG ? 0.f : exp2_fast(x - m_new);
          ls += pe;
          s[j][e] = pe;
        }
      ls += __shfl_xor_sync(0xffffffffu, ls, 1);
      ls += __shfl_xor_sync(0xffffffffu, ls, 2);
      l[r] = l[r] * corr + ls;
      m[r] = m_new;
#pragma unroll
      for (int n = 0; n < D / 8; ++n) {
        acc[n][2 * r] *= corr;
        acc[n][2 * r + 1] *= corr;
      }
    }

    mma_pv<MODE, D, NJ>(acc, s, Vs + st * BK * LD, split);
    __syncthreads();  // every warp is done with stage st
  }
  cp_async_wait<0>();

  T* og = static_cast<T*>(p.o) + b * p.so[0] + h * p.so[1];
  float* lg = p.lse + b * p.sl[0] + h * p.sl[1];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int qi = r0 + 8 * r;
    if (qi >= p.tq) continue;
    const float lc = fmaxf(l[r], 1e-30f);
    T* orow = og + (int64_t)qi * p.so[2] + 2 * t4;
#pragma unroll
    for (int n = 0; n < D / 8; ++n)
      store2(orow + 8 * n, acc[n][2 * r] / lc, acc[n][2 * r + 1] / lc);
    // m back in natural units; a row with no key keeps m = -1e30
    const float mn = m[r] == NEG ? NEG : m[r] * 0.6931471805599453f;
    if (t4 == 0) lg[(int64_t)qi * p.sl[2]] = mn + logf(lc);
  }
}

template <int D, typename T, int MODE>
cudaError_t launch(const Params& p, int bh, cudaStream_t stream) {
  const size_t smem = Cfg<D, T>::SMEM;
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_kernel<D, T, MODE>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const dim3 grid(bh, (p.tq + BQ - 1) / BQ);
  flash_fwd_kernel<D, T, MODE><<<grid, NT, smem, stream>>>(p);
  return cudaGetLastError();
}

template <int D>
cudaError_t launch_t(const Params& p, int dtype, int bh,
                     cudaStream_t stream) {
  if (dtype == 1) return launch<D, __nv_bfloat16, BF16>(p, bh, stream);
  if (p.mxu_bf16) return launch<D, float, BF16>(p, bh, stream);
  return launch<D, float, TF32X3>(p, bh, stream);
}

}  // namespace

extern "C" {

// strides: 15 int64 element strides, (batch, head, time) for each of
// q, k, v, o, lse in that order. dtype: 0 = float32, 1 = bfloat16.
// Returns the CUDA error of the launch (0 on success); never synchronises.
int flash_fwd(const void* q, const void* k, const void* v, void* o,
              void* lse, int batch, int heads, int tq, int tk, int d,
              const int64_t* strides, float scale, int causal, int mxu_bf16,
              int dtype, void* stream) {
  Params p;
  p.q = q;
  p.k = k;
  p.v = v;
  p.o = o;
  p.lse = static_cast<float*>(lse);
  p.heads = heads;
  p.tq = tq;
  p.tk = tk;
  for (int i = 0; i < 3; ++i) {
    p.sq[i] = strides[i];
    p.sk[i] = strides[3 + i];
    p.sv[i] = strides[6 + i];
    p.so[i] = strides[9 + i];
    p.sl[i] = strides[12 + i];
  }
  p.scale = scale;
  p.causal = causal;
  p.mxu_bf16 = mxu_bf16;
  const int bh = batch * heads;
  if (tq == 0 || bh == 0) return 0;
  if (dtype != 0 && dtype != 1) return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  switch (d) {
    case 32: err = launch_t<32>(p, dtype, bh, s); break;
    case 64: err = launch_t<64>(p, dtype, bh, s); break;
    case 128: err = launch_t<128>(p, dtype, bh, s); break;
    default: err = cudaErrorInvalidValue;
  }
  return static_cast<int>(err);
}

const char* flash_fwd_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
