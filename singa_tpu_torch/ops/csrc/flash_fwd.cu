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
// Design (first, simple version): one CTA of 256 threads per (batch*head,
// 64-row Q tile); a loop over 64-row K/V tiles that stops at the causal
// bound, so tiles wholly above the diagonal are never loaded (_block_live,
// :106); Q, K^T, V and the score tile staged in dynamic shared memory as
// fp32; products by FMA. Q.K^T runs as 4x4 register micro-tiles per thread;
// each row's softmax and its O accumulator belong to 4 adjacent lanes.
//
// Bound at gpt_medium's shape (B=4, T=1024, H=8, hd=128, causal): the
// causal half of the two products is 2*B*H*T^2*hd = 8.6 GFLOP, ~8.7 us at
// the data-sheet 989 TFLOP/s (bf16 tensor cores) and ~128 us at 67 TFLOP/s
// (fp32 outside the tensor cores, the units this kernel uses); about 67 MB
// move in fp32 (qkv in, O out), ~20 us at 3.35 TB/s. So the bound is
// operations. These figures are reckoned from the data sheet, not measured;
// wgmma and TMA, which reach the tensor-core rate, are later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BQ = 64;    // query rows per CTA
constexpr int BK = 64;    // key rows per K/V tile
constexpr int NT = 256;   // threads per CTA
constexpr float NEG = -1e30f;

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

template <int D>
constexpr size_t smem_floats() {
  return BQ * (D + 1)      // Qs[r][d], padded rows
         + D * (BK + 1)    // Kt[d][c], K transposed, padded rows
         + BK * D          // Vs[c][d]
         + BQ * (BK + 1);  // Ps[r][c], scores then probabilities
}

template <int D, typename T>
__global__ void __launch_bounds__(NT) flash_fwd_kernel(const Params p) {
  extern __shared__ float smem[];
  float* Qs = smem;
  float* Kt = Qs + BQ * (D + 1);
  float* Vs = Kt + D * (BK + 1);
  float* Ps = Vs + BK * D;

  const int bh = blockIdx.y;
  const int b = bh / p.heads, h = bh % p.heads;
  const int q0 = blockIdx.x * BQ;
  const int tid = threadIdx.x;
  const bool rnd = p.mxu_bf16 != 0;
  const int shift = p.tk - p.tq;  // bottom-right causal alignment

  const T* qg = static_cast<const T*>(p.q) + b * p.sq[0] + h * p.sq[1];
  const T* kg = static_cast<const T*>(p.k) + b * p.sk[0] + h * p.sk[1];
  const T* vg = static_cast<const T*>(p.v) + b * p.sv[0] + h * p.sv[1];

  for (int i = tid; i < BQ * D; i += NT) {
    const int r = i / D, d = i % D;
    float x = 0.f;
    if (q0 + r < p.tq) x = to_f(qg[(int64_t)(q0 + r) * p.sq[2] + d]);
    Qs[r * (D + 1) + d] = rnd ? round_bf16(x) : x;
  }

  // softmax / PV ownership: row `row` of the tile, columns sub + 4*j
  const int row = tid >> 2, sub = tid & 3;
  const int qi = q0 + row;
  float m_i = NEG, l_i = 0.f;
  float acc[D / 4];
#pragma unroll
  for (int j = 0; j < D / 4; ++j) acc[j] = 0.f;

  // S = Q K^T ownership: rows ty*4 + i, columns tx + 16*j
  const int ty = tid >> 4, tx = tid & 15;

  int n_tiles = (p.tk + BK - 1) / BK;
  if (p.causal) {
    const int kmax = q0 + BQ - 1 + shift;  // last key any row here may see
    n_tiles = min(n_tiles, kmax < 0 ? 0 : kmax / BK + 1);
  }

  for (int t = 0; t < n_tiles; ++t) {
    const int k0 = t * BK;
    __syncthreads();  // the previous tile's readers are done
    for (int i = tid; i < BK * D; i += NT) {
      const int c = i / D, d = i % D;
      float kx = 0.f, vx = 0.f;
      if (k0 + c < p.tk) {
        kx = to_f(kg[(int64_t)(k0 + c) * p.sk[2] + d]);
        vx = to_f(vg[(int64_t)(k0 + c) * p.sv[2] + d]);
      }
      Kt[d * (BK + 1) + c] = rnd ? round_bf16(kx) : kx;
      Vs[c * D + d] = rnd ? round_bf16(vx) : vx;
    }
    __syncthreads();

    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
#pragma unroll 4
    for (int d = 0; d < D; ++d) {
      float a[4], bb[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = Qs[(ty * 4 + i) * (D + 1) + d];
#pragma unroll
      for (int j = 0; j < 4; ++j) bb[j] = Kt[d * (BK + 1) + tx + 16 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] = fmaf(a[i], bb[j], s[i][j]);
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = ty * 4 + i;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int c = tx + 16 * j;
        const int kk = k0 + c;
        const bool ok = kk < p.tk && (!p.causal || kk <= q0 + r + shift);
        Ps[r * (BK + 1) + c] = ok ? s[i][j] * p.scale : NEG;
      }
    }
    __syncthreads();

    // online softmax over this tile: 4 lanes per row, 16 columns each
    float* prow = Ps + row * (BK + 1);
    float mx = NEG;
#pragma unroll
    for (int j = 0; j < BK / 4; ++j) mx = fmaxf(mx, prow[sub + 4 * j]);
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
    const float m_new = fmaxf(m_i, mx);
    const float corr = expf(m_i - m_new);
    float ls = 0.f;
#pragma unroll
    for (int j = 0; j < BK / 4; ++j) {
      const int c = sub + 4 * j;
      const int kk = k0 + c;
      const bool ok = kk < p.tk && (!p.causal || kk <= qi + shift);
      const float e = ok ? expf(prow[c] - m_new) : 0.f;  // masked: exact 0
      ls += e;
      prow[c] = rnd ? round_bf16(e) : e;
    }
    ls += __shfl_xor_sync(0xffffffffu, ls, 1);
    ls += __shfl_xor_sync(0xffffffffu, ls, 2);
    l_i = l_i * corr + ls;
    m_i = m_new;
    __syncwarp();  // the row's 4 lanes see each other's p

    // O = O * corr + P V
#pragma unroll
    for (int j = 0; j < D / 4; ++j) acc[j] *= corr;
#pragma unroll 4
    for (int c = 0; c < BK; ++c) {
      const float pc = prow[c];
      const float* vrow = Vs + c * D + sub;
#pragma unroll
      for (int j = 0; j < D / 4; ++j) acc[j] = fmaf(pc, vrow[4 * j], acc[j]);
    }
  }

  if (qi < p.tq) {
    const float l = fmaxf(l_i, 1e-30f);
    T* og = static_cast<T*>(p.o) + b * p.so[0] + h * p.so[1] +
            (int64_t)qi * p.so[2];
#pragma unroll
    for (int j = 0; j < D / 4; ++j) store(og + sub + 4 * j, acc[j] / l);
    if (sub == 0) {
      p.lse[b * p.sl[0] + h * p.sl[1] + (int64_t)qi * p.sl[2]] =
          m_i + logf(l);
    }
  }
}

template <int D, typename T>
cudaError_t launch(const Params& p, int bh, cudaStream_t stream) {
  const size_t smem = smem_floats<D>() * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_kernel<D, T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const dim3 grid((p.tq + BQ - 1) / BQ, bh);
  flash_fwd_kernel<D, T><<<grid, NT, smem, stream>>>(p);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_d(const Params& p, int d, int bh, cudaStream_t stream) {
  switch (d) {
    case 32: return launch<32, T>(p, bh, stream);
    case 64: return launch<64, T>(p, bh, stream);
    case 128: return launch<128, T>(p, bh, stream);
    default: return cudaErrorInvalidValue;
  }
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
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (dtype == 0) {
    err = launch_d<float>(p, d, bh, s);
  } else if (dtype == 1) {
    err = launch_d<__nv_bfloat16>(p, d, bh, s);
  } else {
    err = cudaErrorInvalidValue;
  }
  return static_cast<int>(err);
}

const char* flash_fwd_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
