// AdamW for Hopper (sm_90a): one elementwise pass per parameter tensor.
//
// Replaces no Pallas kernel: the JAX package leaves this update to XLA,
// which fuses optax's chain (picotron_tpu/optimizer.py make_optimizer)
// and, under optimizer_offload, the update of each streamed slice
// (offload_adam_update's `math`, optimizer.py:208-213) into one kernel.
// This kernel is the port's counterpart of that fusion, for both paths:
// the resident AdamW (optimizer.py AdamW.step) launches it once per
// parameter tensor, the host-offloaded one (OffloadAdamW) once per slice
// staged on the card.
//
// What bounds it: memory. Per parameter it reads fp32 p and g and the two
// moments (bf16 under adam_moments_dtype "bfloat16") and writes p and the
// moments back: (4 + 4 + 2 + 2) + (4 + 2 + 2) = 20 B, plus 2 B for the
// bf16 compute copy under offload (22 B), for ~30 FLOPs: far below the
// H100's FLOP/byte ridge. So one pass over the bytes is the whole design:
// each thread moves 8 elements per iteration of a grid-stride loop with
// 16-byte vector loads and stores (two float4 for an fp32 array, one
// uint4 of 8 bf16), and a scalar loop takes the ragged tail; every array
// must start 16-byte aligned (the wrapper checks). Tensor cores, wgmma and
// TMA have nothing to do here. CUDA C++ rather than Triton: an elementwise
// pass suits either, and this keeps the port's one build route
// (kernels/build.py, nvcc into a ctypes library).
//
// The scalars that change per step without the host knowing them are read
// from device memory, so nothing syncs the host:
//   gnorm   the grads' global norm; with clipping on (gnorm != null) the
//           clip is optax's clip_by_global_norm, a select per element;
//   gscale  a scale on g (offload folds the token-mean 1/count in here,
//           as offload_adam_update's grad_scale), and then the clip is a
//           factor on that scale, as offload_adam_update computes it;
//   ok      the divergence guard's "skip": when it holds 0, the kernel
//           writes nothing (no copies of the old state are needed).
// b1, b2, eps, wd, lr, c1 = 1 - b1^t, c2 = 1 - b2^t and the clip norm are
// host scalars, rounded to fp32 as PyTorch rounds a Python scalar.
//
// Arithmetic: the plain version's order of operations (optimizer.py
// adamw_update_plain), each operation rounded on its own with the
// __f*_rn intrinsics, so that nvcc cannot contract a*b+c into an FMA, and
// the moments rounded to bf16 with __float2bfloat16_rn. The kernel is held
// to the plain version bit for bit on the card (chip_smoke.py, and
// tests/test_torch_cuda.py).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kVec = 8;  // elements per thread per iteration

struct Hyper {
  float b1, omb1, b2, omb2, eps, wd, neg_lr, c1, c2, clip;
};

// g as the update sees it: optax's clip select, or the offload scale
struct GradIn {
  int mode;     // 0: g as is, 1: clip select on gn, 2: times scale
  float gn;     // mode 1
  float scale;  // mode 2
  float clip;
  __device__ __forceinline__ float operator()(float g) const {
    if (mode == 1) {
      return gn < clip ? g : __fmul_rn(__fdiv_rn(g, gn), clip);
    }
    if (mode == 2) return __fmul_rn(g, scale);
    return g;
  }
};

// one element, in place: p, and m and v in fp32 before their storage
// rounding
__device__ __forceinline__ void adamw_one(float& p, float g, float& m,
                                          float& v, const Hyper& h) {
  m = __fadd_rn(__fmul_rn(h.b1, m), __fmul_rn(h.omb1, g));
  v = __fadd_rn(__fmul_rn(h.b2, v), __fmul_rn(h.omb2, __fmul_rn(g, g)));
  float upd = __fdiv_rn(__fdiv_rn(m, h.c1),
                        __fadd_rn(__fsqrt_rn(__fdiv_rn(v, h.c2)), h.eps));
  upd = __fadd_rn(upd, __fmul_rn(h.wd, p));
  p = __fadd_rn(p, __fmul_rn(upd, h.neg_lr));
}

template <bool kBf16>
struct Moments;

template <>
struct Moments<true> {
  using T = __nv_bfloat16;
  static __device__ __forceinline__ void load8(const T* src, float* dst) {
    uint4 raw = *reinterpret_cast<const uint4*>(src);
    const __nv_bfloat162* h2 = reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      float2 f = __bfloat1622float2(h2[j]);
      dst[2 * j] = f.x;
      dst[2 * j + 1] = f.y;
    }
  }
  static __device__ __forceinline__ void store8(T* dst, const float* src) {
    uint4 raw;
    __nv_bfloat16* b = reinterpret_cast<__nv_bfloat16*>(&raw);
#pragma unroll
    for (int j = 0; j < 8; ++j) b[j] = __float2bfloat16_rn(src[j]);
    *reinterpret_cast<uint4*>(dst) = raw;
  }
  static __device__ __forceinline__ float load1(const T* src) {
    return __bfloat162float(*src);
  }
  static __device__ __forceinline__ void store1(T* dst, float x) {
    *dst = __float2bfloat16_rn(x);
  }
};

template <>
struct Moments<false> {
  using T = float;
  static __device__ __forceinline__ void load8(const T* src, float* dst) {
    float4 a = reinterpret_cast<const float4*>(src)[0];
    float4 b = reinterpret_cast<const float4*>(src)[1];
    dst[0] = a.x; dst[1] = a.y; dst[2] = a.z; dst[3] = a.w;
    dst[4] = b.x; dst[5] = b.y; dst[6] = b.z; dst[7] = b.w;
  }
  static __device__ __forceinline__ void store8(T* dst, const float* src) {
    reinterpret_cast<float4*>(dst)[0] =
        make_float4(src[0], src[1], src[2], src[3]);
    reinterpret_cast<float4*>(dst)[1] =
        make_float4(src[4], src[5], src[6], src[7]);
  }
  static __device__ __forceinline__ float load1(const T* src) { return *src; }
  static __device__ __forceinline__ void store1(T* dst, float x) { *dst = x; }
};

template <bool kBf16Moments, bool kOut>
__global__ void __launch_bounds__(kThreads)
    adamw_kernel(float* __restrict__ p, const float* __restrict__ g,
                 typename Moments<kBf16Moments>::T* __restrict__ mu,
                 typename Moments<kBf16Moments>::T* __restrict__ nu,
                 __nv_bfloat16* __restrict__ out, int64_t n,
                 const float* __restrict__ gnorm,
                 const float* __restrict__ gscale,
                 const bool* __restrict__ ok, Hyper h) {
  using M = Moments<kBf16Moments>;
  if (ok != nullptr && !*ok) return;  // the guard's skip: write nothing
  GradIn gin{0, 0.f, 1.f, h.clip};
  if (gscale != nullptr) {
    // offload_adam_update: scale = s * where(gn*s < clip, 1, clip/(gn*s))
    gin.mode = 2;
    gin.scale = *gscale;
    if (gnorm != nullptr) {
      float gns = __fmul_rn(*gnorm, gin.scale);
      if (!(gns < h.clip)) {
        gin.scale = __fmul_rn(gin.scale, __fdiv_rn(h.clip, gns));
      }
    }
  } else if (gnorm != nullptr) {
    gin.mode = 1;
    gin.gn = *gnorm;
  }
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  const int64_t tid = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  const int64_t nvec = n / kVec;
  for (int64_t i = tid; i < nvec; i += stride) {
    const int64_t base = i * kVec;
    float pv[kVec], gv[kVec], mv[kVec], vv[kVec];
    Moments<false>::load8(p + base, pv);
    Moments<false>::load8(g + base, gv);
    M::load8(mu + base, mv);
    M::load8(nu + base, vv);
#pragma unroll
    for (int j = 0; j < kVec; ++j) {
      adamw_one(pv[j], gin(gv[j]), mv[j], vv[j], h);
    }
    Moments<false>::store8(p + base, pv);
    M::store8(mu + base, mv);
    M::store8(nu + base, vv);
    if (kOut) Moments<true>::store8(out + base, pv);
  }
  for (int64_t i = nvec * kVec + tid; i < n; i += stride) {
    float pi = p[i], mi = M::load1(mu + i), vi = M::load1(nu + i);
    adamw_one(pi, gin(g[i]), mi, vi, h);
    p[i] = pi;
    M::store1(mu + i, mi);
    M::store1(nu + i, vi);
    if (kOut) out[i] = __float2bfloat16_rn(pi);
  }
}

template <bool kBf16Moments, bool kOut>
cudaError_t launch(void* p, const void* g, void* mu, void* nu, void* out,
                   int64_t n, const void* gnorm, const void* gscale,
                   const void* ok, const Hyper& h, cudaStream_t stream) {
  using T = typename Moments<kBf16Moments>::T;
  if (n <= 0) return cudaSuccess;
  // enough blocks to fill the card (132 SMs x 8 blocks of 256 threads),
  // fewer for a small tensor
  int64_t work = (n + kVec - 1) / kVec;
  int64_t blocks = (work + kThreads - 1) / kThreads;
  if (blocks > 132 * 8) blocks = 132 * 8;
  adamw_kernel<kBf16Moments, kOut><<<(unsigned)blocks, kThreads, 0, stream>>>(
      static_cast<float*>(p), static_cast<const float*>(g),
      static_cast<T*>(mu), static_cast<T*>(nu),
      static_cast<__nv_bfloat16*>(out), n,
      static_cast<const float*>(gnorm), static_cast<const float*>(gscale),
      static_cast<const bool*>(ok), h);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// p, g fp32; mu, nu bf16 (moments_bf16) or fp32; out (nullable) bf16;
// gnorm, gscale (nullable) fp32 scalars; ok (nullable) bool scalar. Every
// pointer 16-byte aligned (the wrapper checks).
int pt_adamw(void* p, const void* g, void* mu, void* nu, void* out,
             long long n, const void* gnorm, const void* gscale,
             const void* ok, int moments_bf16, float b1, float omb1, float b2,
             float omb2, float eps, float wd, float neg_lr, float c1, float c2,
             float clip, void* stream) {
  Hyper h{b1, omb1, b2, omb2, eps, wd, neg_lr, c1, c2, clip};
  cudaStream_t s = (cudaStream_t)stream;
#define PT_ADAMW_ARGS p, g, mu, nu, out, n, gnorm, gscale, ok, h, s
  cudaError_t err =
      moments_bf16 ? (out ? launch<true, true>(PT_ADAMW_ARGS)
                          : launch<true, false>(PT_ADAMW_ARGS))
                   : (out ? launch<false, true>(PT_ADAMW_ARGS)
                          : launch<false, false>(PT_ADAMW_ARGS));
#undef PT_ADAMW_ARGS
  return (int)err;
}

}  // extern "C"
