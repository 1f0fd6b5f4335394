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
//
// Design: a gather, not the TPU's rolled window-origin frame. One thread
// per dx element (n, h, w, c), c innermost, so that neighbouring threads
// touch neighbouring addresses of the channels-last layout; the grid is
// (W*C / 256, N*H). Each thread visits the <= ceil(kh/sh) * ceil(kw/sw)
// windows that cover (h, w); for a window whose y equals x[h, w] it reads
// the earlier in-bounds positions of that window and adds dy only if none
// of them also equals y (the reference's running `taken` claim). No
// atomics: every dx element is written once by one thread, so repeated
// runs are bitwise the same.
// Every tensor comes with its 4 element strides, so a channels-last view
// or a non-contiguous incoming gradient is read in place. Every shape is
// taken: the TPU's VMEM sizing (_pick_cblock) and its XLA fallback have no
// counterpart.
//
// Bound at the ResNet-50 stem shape (128,112,112,64) -> (128,56,56,64),
// fp32: x read and dx written, 411.0 MB each, y and dy read, 102.8 MB
// each: 1.028 GB, 0.307 ms at the data sheet's 3.35 TB/s (half in bf16).
// The work is a few comparisons and adds per byte, so bytes bound it.
// This simple kernel does not reach that bound: measured on an H100 it
// takes the same time in bf16 as in fp32, about 9x the fp32 bound
// (PERF.md), since each thread runs a short chain of dependent loads (x,
// y, the first-match scan, dy) and too few are in flight. Variants that
// took more registers (a scan without the early exit on a 3-D grid, and
// the window unrolled as compile-time constants) measured slower. Loading
// several channels per thread, or tiling x with its halo in shared
// memory, is later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int NT = 256;          // threads per block, over W*C of a row
constexpr int MAX_GRID = 65535;  // rows (n, h) beyond it are looped

struct Params {
  const void* x;
  const void* y;
  const void* dy;
  void* dx;
  int n, h, w, c, oh, ow;
  int kh, kw, sh, sw, ph, pw;
  // element strides for (n, h, w, c)
  int64_t sx[4], sy[4], sdy[4], sdx[4];
};

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16(x);  // round to nearest even, as astype does
}

template <typename T>
__global__ void __launch_bounds__(NT) max_pool_bwd_kernel(Params p) {
  const int i = blockIdx.x * NT + threadIdx.x;  // (w, c) within a row
  if (i >= p.w * p.c) return;
  const int w = i / p.c;
  const int ch = i - w * p.c;
  // the windows (a, b) that cover column w: b*sw - pw <= w < b*sw - pw + kw
  const int tw = w + p.pw - p.kw + 1;
  const int b0 = tw <= 0 ? 0 : (tw + p.sw - 1) / p.sw;
  const int b1 = min(p.ow - 1, (w + p.pw) / p.sw);
  const int64_t rows = (int64_t)p.n * p.h;
  for (int64_t row = blockIdx.y; row < rows; row += gridDim.y) {
    const int n = (int)(row / p.h);
    const int h = (int)(row - (int64_t)n * p.h);
    const T* x = static_cast<const T*>(p.x) + n * p.sx[0] + ch * p.sx[3];
    const T* y = static_cast<const T*>(p.y) + n * p.sy[0] + ch * p.sy[3];
    const T* dy = static_cast<const T*>(p.dy) + n * p.sdy[0] +
                  ch * p.sdy[3];
    const float xv = to_f(x[h * p.sx[1] + w * p.sx[2]]);
    const int th = h + p.ph - p.kh + 1;
    const int a0 = th <= 0 ? 0 : (th + p.sh - 1) / p.sh;
    const int a1 = min(p.oh - 1, (h + p.ph) / p.sh);
    float acc = 0.f;
    for (int a = a0; a <= a1; ++a) {
      for (int b = b0; b <= b1; ++b) {
        const float yv = to_f(y[a * p.sy[1] + b * p.sy[2]]);
        if (xv != yv) continue;
        // (h, w) takes this window's dy only if no in-bounds position
        // before it in row-major window order also equals y
        const int r0 = max(a * p.sh - p.ph, 0);
        const int q0 = max(b * p.sw - p.pw, 0);
        const int q1 = min(b * p.sw - p.pw + p.kw, p.w);
        bool first = true;
        for (int r = r0; r <= h && first; ++r) {
          const int q_end = r < h ? q1 : w;
          for (int q = q0; q < q_end; ++q) {
            if (to_f(x[r * p.sx[1] + q * p.sx[2]]) == yv) {
              first = false;
              break;
            }
          }
        }
        if (first) acc += to_f(dy[a * p.sdy[1] + b * p.sdy[2]]);
      }
    }
    T* dx = static_cast<T*>(p.dx) + n * p.sdx[0] + h * p.sdx[1] +
            w * p.sdx[2] + ch * p.sdx[3];
    store(dx, acc);
  }
}

}  // namespace

extern "C" {

// dtype: 0 float32, 1 bfloat16. strides: x, y, dy, dx, 4 each, in
// elements, for (n, h, w, c). Returns the cudaError_t of the launch (0 on
// success); launches nothing for an empty tensor.
int max_pool_bwd(const void* x, const void* y, const void* dy, void* dx,
                 int n, int h, int w, int c, int oh, int ow, int kh, int kw,
                 int sh, int sw, int ph, int pw, const int64_t* strides,
                 int dtype, void* stream) {
  Params p{x, y, dy, dx, n, h, w, c, oh, ow, kh, kw, sh, sw, ph, pw,
           {}, {}, {}, {}};
  for (int k = 0; k < 4; ++k) {
    p.sx[k] = strides[k];
    p.sy[k] = strides[4 + k];
    p.sdy[k] = strides[8 + k];
    p.sdx[k] = strides[12 + k];
  }
  const int64_t rows = (int64_t)n * h;
  if (rows == 0 || w == 0 || c == 0) return 0;
  dim3 grid((unsigned)(((int64_t)w * c + NT - 1) / NT),
            (unsigned)(rows < MAX_GRID ? rows : MAX_GRID));
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 1) {
    max_pool_bwd_kernel<__nv_bfloat16><<<grid, NT, 0, s>>>(p);
  } else {
    max_pool_bwd_kernel<float><<<grid, NT, 0, s>>>(p);
  }
  return (int)cudaGetLastError();
}

const char* max_pool_bwd_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
