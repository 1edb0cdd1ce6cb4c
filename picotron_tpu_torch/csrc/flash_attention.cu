// Flash attention for Hopper (sm_90a): forward, dq and dk/dv kernels.
//
// Replaces the three Pallas TPU kernels of picotron_tpu/ops/flash_attention.py:
//   fwd_kernel     <- _fwd_kernel     (:139, pallas_call in _fwd :281)
//   bwd_dq_kernel  <- _bwd_dq_kernel  (:327, pallas_call in _bwd :543)
//   bwd_dkv_kernel <- _bwd_dkv_kernel (:412, pallas_call in _bwd :593)
//
// What bounds it on the card: causal attention at the training shapes
// (S = 2048, D = 64) does ~S/2 multiply-adds per loaded element, far above
// the H100's ~295 FLOP/byte ridge, so the work is bound by operations, not
// by device-memory bytes. This first version computes the products with
// fp32 FMAs on CUDA cores (67 TFLOP/s peak) rather than the tensor cores
// (989 TFLOP/s bf16); its design is about keeping every operand on chip:
// one block of 256 threads per (batch, head, 64-row tile), Q/K/V/dO tiles
// converted to fp32 in shared memory (rows padded by 4 floats so the
// float4 reads are free of bank conflicts), each thread owning a 4 x 4
// block of scores and a 4 x D/16 block of the accumulator, and the TPU's
// sequential grid axis replaced by a loop inside the block (over kv tiles
// for the forward and dq, over (group head, q tile) for dk/dv, so grouped
// heads accumulate in registers with no atomics). Moving the products to
// mma/wgmma is the next step.
//
// Features carried over from the TPU kernels: GQA by index (kv head =
// h / (Hq / Hkv), K/V never repeated), masking by position vectors
// (q_pos >= kv_pos), whole-tile skip of masked tiles with three tile
// classes (skipped / full / masked), the static-causal loop bounds when
// positions are plain 0..S-1 (_kv_eff / _q_eff), fused rotate-half RoPE
// on q and k tiles in fp32 with the result rounded to the input type, the
// inverse rotation of dq and dk, -inf LSE and zero output for fully
// masked rows, and the LSE cotangent folded into delta by the caller.
// Ragged sequence ends (S not a multiple of 64) are masked.
//
// Plain C interface for ctypes: pointers, ints and the stream; each entry
// returns cudaGetLastError() after its launch. Tensors are contiguous
// [B, H, S, D]; lse and delta are fp32 [B, Hq, Sq]; positions int32; RoPE
// tables fp32 [S, D/2] already gathered at the positions (null = no RoPE).

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <limits.h>
#include <math.h>
#include <stddef.h>

namespace {

constexpr int BQ = 64;
constexpr int BK = 64;
constexpr int NT = 256;
constexpr int LDP = BK + 4;
constexpr float NEG = -1e30f;

template <typename T> __device__ __forceinline__ float to_f(T x);
template <> __device__ __forceinline__ float to_f<float>(float x) { return x; }
template <> __device__ __forceinline__ float to_f<__nv_bfloat16>(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}
// round an fp32 value to T and back (the TPU kernels' .astype(input dtype))
template <typename T> __device__ __forceinline__ float round_t(float x) {
  return to_f<T>(from_f<T>(x));
}

// Load rows [row0, row0 + 64) of a [S, D] slab into shared memory as fp32
// (row stride D + 4), zero past S. With tables, apply rotate-half RoPE in
// fp32 and round to T: rot(x)[d] = x[d] c - x[d+D/2] s (d < D/2),
// x[d] c + x[d-D/2] s (d >= D/2).
template <typename T, int D>
__device__ __forceinline__ void load_tile(float* dst, const T* src, int row0,
                                          int S, const float* tc,
                                          const float* ts) {
  constexpr int LD = D + 4, H = D / 2;
  for (int idx = threadIdx.x; idx < 64 * D; idx += NT) {
    const int r = idx / D, d = idx % D, row = row0 + r;
    float val = 0.f;
    if (row < S) {
      const T* p = src + (size_t)row * D;
      val = to_f<T>(p[d]);
      if (tc != nullptr) {
        const int dd = d < H ? d : d - H;
        const float c = tc[(size_t)row * H + dd];
        const float s = ts[(size_t)row * H + dd];
        const float partner = to_f<T>(p[d < H ? d + H : d - H]);
        val = round_t<T>(d < H ? val * c - partner * s : val * c + partner * s);
      }
    }
    dst[r * LD + d] = val;
  }
}

// s[i][j] = sum_d A[ty*4+i][d] * B[tx+16j][d]
template <int D>
__device__ __forceinline__ void tile_abt(const float* A, const float* B,
                                         float s[4][4]) {
  constexpr int LD = D + 4;
  const int ty = threadIdx.x >> 4, tx = threadIdx.x & 15;
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
#pragma unroll 4
  for (int d = 0; d < D; d += 4) {
    float4 a[4], b[4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
      a[i] = *reinterpret_cast<const float4*>(A + (ty * 4 + i) * LD + d);
#pragma unroll
    for (int j = 0; j < 4; ++j)
      b[j] = *reinterpret_cast<const float4*>(B + (tx + 16 * j) * LD + d);
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        float t = s[i][j];
        t = fmaf(a[i].x, b[j].x, t);
        t = fmaf(a[i].y, b[j].y, t);
        t = fmaf(a[i].z, b[j].z, t);
        t = fmaf(a[i].w, b[j].w, t);
        s[i][j] = t;
      }
  }
}

// acc[i][j] += sum_c P[ty*4+i][c] * X[c][tx+16j]
template <int D>
__device__ __forceinline__ void tile_px(const float* P, const float* X,
                                        float acc[4][D / 16]) {
  constexpr int LD = D + 4, NJ = D / 16;
  const int ty = threadIdx.x >> 4, tx = threadIdx.x & 15;
#pragma unroll 2
  for (int c = 0; c < BK; c += 4) {
    float4 p[4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
      p[i] = *reinterpret_cast<const float4*>(P + (ty * 4 + i) * LDP + c);
#pragma unroll
    for (int cc = 0; cc < 4; ++cc) {
      float x[NJ];
#pragma unroll
      for (int j = 0; j < NJ; ++j) x[j] = X[(c + cc) * LD + tx + 16 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float pv = cc == 0 ? p[i].x : cc == 1 ? p[i].y
                       : cc == 2 ? p[i].z : p[i].w;
#pragma unroll
        for (int j = 0; j < NJ; ++j) acc[i][j] = fmaf(pv, x[j], acc[i][j]);
      }
    }
  }
}

// acc[i][j] += sum_r P[r][ty*4+i] * X[r][tx+16j]
template <int D>
__device__ __forceinline__ void tile_ptx(const float* P, const float* X,
                                         float acc[4][D / 16]) {
  constexpr int LD = D + 4, NJ = D / 16;
  const int ty = threadIdx.x >> 4, tx = threadIdx.x & 15;
#pragma unroll 4
  for (int r = 0; r < BQ; ++r) {
    const float4 p = *reinterpret_cast<const float4*>(P + r * LDP + ty * 4);
    float x[NJ];
#pragma unroll
    for (int j = 0; j < NJ; ++j) x[j] = X[r * LD + tx + 16 * j];
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
      acc[0][j] = fmaf(p.x, x[j], acc[0][j]);
      acc[1][j] = fmaf(p.y, x[j], acc[1][j]);
      acc[2][j] = fmaf(p.z, x[j], acc[2][j]);
      acc[3][j] = fmaf(p.w, x[j], acc[3][j]);
    }
  }
}

// reductions over the 16 lanes that share a row (one half of a warp)
__device__ __forceinline__ float rmax16(float v) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}
__device__ __forceinline__ float rsum16(float v) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// min and max of the first n entries of a 64-entry position tile, computed
// by every warp (no extra barrier needed)
__device__ __forceinline__ void tile_minmax(const int* pos, int n, int& mn,
                                            int& mx) {
  const int lane = threadIdx.x & 31;
  int lo = INT_MAX, hi = INT_MIN;
  if (lane < n) { lo = min(lo, pos[lane]); hi = max(hi, pos[lane]); }
  if (lane + 32 < n) { lo = min(lo, pos[lane + 32]); hi = max(hi, pos[lane + 32]); }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    lo = min(lo, __shfl_xor_sync(0xffffffffu, lo, o));
    hi = max(hi, __shfl_xor_sync(0xffffffffu, hi, o));
  }
  mn = lo;
  mx = hi;
}

// Tile classes shared by the three kernels (_static_block_classes and the
// position-based max/min tests of the TPU kernels). `full` also requires
// no ragged column, so the unmasked path never sees a column past S.
struct TileClass {
  bool visible, full;
};
__device__ __forceinline__ TileClass classify(bool causal, bool static_causal,
                                              int q0, int nq, int k0, int nk,
                                              int qmin, int qmax, int kmin,
                                              int kmax) {
  TileClass t;
  if (!causal) {
    t.visible = true;
    t.full = true;
  } else if (static_causal) {
    t.visible = q0 + nq - 1 >= k0;
    t.full = q0 >= k0 + nk - 1;
  } else {
    t.visible = qmax >= kmin;
    t.full = qmin >= kmax;
  }
  t.full = t.full && nk == BK && nq == BQ;
  return t;
}

// ---------------------------------------------------------------------------
// Forward: one block per (q tile, q head, batch); loop over kv tiles with the
// online softmax (m, l, acc) in registers.
// ---------------------------------------------------------------------------

template <typename T, int D>
__global__ void __launch_bounds__(NT) fwd_kernel(
    const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
    T* __restrict__ out, float* __restrict__ lse, const int* __restrict__ qpos,
    const int* __restrict__ kpos, const float* cq, const float* sq,
    const float* ck, const float* sk, int Hq, int Hkv, int Sq, int Sk,
    int causal, int static_causal) {
  constexpr int LD = D + 4, NJ = D / 16;
  extern __shared__ float4 smem4[];
  float* Qs = reinterpret_cast<float*>(smem4);
  float* Ks = Qs + 64 * LD;
  float* Vs = Ks + 64 * LD;
  float* Ps = Vs + 64 * LD;
  __shared__ int qp_s[BQ];
  __shared__ int kp_s[BK];

  const int qt = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int hk = h / (Hq / Hkv);
  const int q0 = qt * BQ, nq = min(BQ, Sq - q0);
  const int tid = threadIdx.x, ty = tid >> 4, tx = tid & 15;
  const T* qb = q + (size_t)(b * Hq + h) * Sq * D;
  const T* kb = k + (size_t)(b * Hkv + hk) * Sk * D;
  const T* vb = v + (size_t)(b * Hkv + hk) * Sk * D;

  // q is constant across the kv loop: rotate it once per block
  load_tile<T, D>(Qs, qb, q0, Sq, cq, sq);
  if (tid < BQ) qp_s[tid] = tid < nq ? qpos[q0 + tid] : 0;
  __syncthreads();
  int qmin, qmax;
  tile_minmax(qp_s, nq, qmin, qmax);

  float m[4], l[4], acc[4][NJ];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = NEG;
    l[i] = 0.f;
#pragma unroll
    for (int j = 0; j < NJ; ++j) acc[i][j] = 0.f;
  }

  const int num_kv = (Sk + BK - 1) / BK;
  // static-causal: no kv tile past the last one this q tile can see
  const int kv_end = static_causal ? min(num_kv, (q0 + nq - 1) / BK + 1) : num_kv;
  for (int kt = 0; kt < kv_end; ++kt) {
    const int k0 = kt * BK, nk = min(BK, Sk - k0);
    __syncthreads();  // the previous tile's readers are done
    if (tid < BK) kp_s[tid] = tid < nk ? kpos[k0 + tid] : 0;
    __syncthreads();
    int kmin = 0, kmax = 0;
    if (causal && !static_causal) tile_minmax(kp_s, nk, kmin, kmax);
    const TileClass tc = classify(causal, static_causal, q0, nq, k0, nk, qmin,
                                  qmax, kmin, kmax);
    if (!tc.visible) continue;  // whole-tile skip: no loads, no products
    load_tile<T, D>(Ks, kb, k0, Sk, ck, sk);
    load_tile<T, D>(Vs, vb, k0, Sk, nullptr, nullptr);
    __syncthreads();

    float s[4][4];
    tile_abt<D>(Qs, Ks, s);
    if (!tc.full) {
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int c = tx + 16 * j;
          const bool ok = c < nk && (!causal || qp_s[ty * 4 + i] >= kp_s[c]);
          if (!ok) s[i][j] = NEG;
        }
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      float mx = fmaxf(fmaxf(s[i][0], s[i][1]), fmaxf(s[i][2], s[i][3]));
      mx = rmax16(mx);
      const float m_new = fmaxf(m[i], mx);
      const float alpha = m[i] <= NEG ? 0.f : expf(m[i] - m_new);
      float rs = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        // a fully masked row has m_new = NEG: exp(NEG - NEG) must be 0
        const float p = m_new <= NEG ? 0.f : expf(s[i][j] - m_new);
        rs += p;
        Ps[(ty * 4 + i) * LDP + tx + 16 * j] = round_t<T>(p);
      }
      rs = rsum16(rs);
      l[i] = l[i] * alpha + rs;
      m[i] = m_new;
#pragma unroll
      for (int j = 0; j < NJ; ++j) acc[i][j] *= alpha;
    }
    __syncthreads();
    tile_px<D>(Ps, Vs, acc);
  }

  const size_t row_base = (size_t)(b * Hq + h) * Sq;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = ty * 4 + i;
    if (r >= nq) continue;
    const float l_safe = l[i] == 0.f ? 1.f : l[i];
    T* orow = out + (row_base + q0 + r) * D;
#pragma unroll
    for (int j = 0; j < NJ; ++j) orow[tx + 16 * j] = from_f<T>(acc[i][j] / l_safe);
    if (tx == 0)
      lse[row_base + q0 + r] = l[i] == 0.f ? -INFINITY : m[i] + logf(l_safe);
  }
}

// ---------------------------------------------------------------------------
// dq: one block per (q tile, q head, batch); loop over kv tiles, P
// recomputed from the saved LSE, ds = p * (dp - delta).
// ---------------------------------------------------------------------------

template <typename T, int D>
__global__ void __launch_bounds__(NT) bwd_dq_kernel(
    const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
    const T* __restrict__ dout, const float* __restrict__ lse,
    const float* __restrict__ delta, T* __restrict__ dq,
    const int* __restrict__ qpos, const int* __restrict__ kpos,
    const float* cq, const float* sq, const float* ck, const float* sk,
    int Hq, int Hkv, int Sq, int Sk, int causal, int static_causal) {
  constexpr int LD = D + 4, NJ = D / 16, H = D / 2;
  extern __shared__ float4 smem4[];
  float* Qs = reinterpret_cast<float*>(smem4);
  float* dOs = Qs + 64 * LD;
  float* Ks = dOs + 64 * LD;
  float* Vs = Ks + 64 * LD;
  float* DSs = Vs + 64 * LD;
  __shared__ int qp_s[BQ];
  __shared__ int kp_s[BK];
  __shared__ float lse_s[BQ];
  __shared__ float delta_s[BQ];

  const int qt = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int hk = h / (Hq / Hkv);
  const int q0 = qt * BQ, nq = min(BQ, Sq - q0);
  const int tid = threadIdx.x, ty = tid >> 4, tx = tid & 15;
  const size_t row_base = (size_t)(b * Hq + h) * Sq;
  const T* qb = q + row_base * D;
  const T* dob = dout + row_base * D;
  const T* kb = k + (size_t)(b * Hkv + hk) * Sk * D;
  const T* vb = v + (size_t)(b * Hkv + hk) * Sk * D;

  load_tile<T, D>(Qs, qb, q0, Sq, cq, sq);
  load_tile<T, D>(dOs, dob, q0, Sq, nullptr, nullptr);
  if (tid < BQ) {
    qp_s[tid] = tid < nq ? qpos[q0 + tid] : 0;
    lse_s[tid] = tid < nq ? lse[row_base + q0 + tid] : -INFINITY;
    delta_s[tid] = tid < nq ? delta[row_base + q0 + tid] : 0.f;
  }
  __syncthreads();
  int qmin, qmax;
  tile_minmax(qp_s, nq, qmin, qmax);

  float acc[4][NJ];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < NJ; ++j) acc[i][j] = 0.f;

  const int num_kv = (Sk + BK - 1) / BK;
  const int kv_end = static_causal ? min(num_kv, (q0 + nq - 1) / BK + 1) : num_kv;
  for (int kt = 0; kt < kv_end; ++kt) {
    const int k0 = kt * BK, nk = min(BK, Sk - k0);
    __syncthreads();
    if (tid < BK) kp_s[tid] = tid < nk ? kpos[k0 + tid] : 0;
    __syncthreads();
    int kmin = 0, kmax = 0;
    if (causal && !static_causal) tile_minmax(kp_s, nk, kmin, kmax);
    const TileClass tc = classify(causal, static_causal, q0, nq, k0, nk, qmin,
                                  qmax, kmin, kmax);
    if (!tc.visible) continue;
    load_tile<T, D>(Ks, kb, k0, Sk, ck, sk);
    load_tile<T, D>(Vs, vb, k0, Sk, nullptr, nullptr);
    __syncthreads();

    float s[4][4], dp[4][4];
    tile_abt<D>(Qs, Ks, s);
    tile_abt<D>(dOs, Vs, dp);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = ty * 4 + i;
      const float lr = lse_s[r], dr = delta_s[r];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int c = tx + 16 * j;
        float sv = s[i][j];
        if (!tc.full) {
          const bool ok = c < nk && (!causal || qp_s[r] >= kp_s[c]);
          if (!ok) sv = NEG;
        }
        // a row with no visible key (lse = -inf) contributes nothing
        const float p = lr <= NEG ? 0.f : expf(sv - lr);
        DSs[r * LDP + c] = round_t<T>(p * (dp[i][j] - dr));
      }
    }
    __syncthreads();
    tile_px<D>(DSs, Ks, acc);
  }

  // dq was accumulated against the rotated q: map it back through the
  // rotation's transpose, y c + y[d+D/2] s (d < D/2), y c - y[d-D/2] s.
  // Column tx + 16 j pairs with j +- NJ/2, held by the same thread.
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = ty * 4 + i;
    if (r >= nq) continue;
    T* drow = dq + (row_base + q0 + r) * D;
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
      const int d = tx + 16 * j;
      float val = acc[i][j];
      if (cq != nullptr) {
        const int dd = d < H ? d : d - H;
        const float c = cq[(size_t)(q0 + r) * H + dd];
        const float s = sq[(size_t)(q0 + r) * H + dd];
        val = j < NJ / 2 ? acc[i][j] * c + acc[i][j + NJ / 2] * s
                         : acc[i][j] * c - acc[i][j - NJ / 2] * s;
      }
      drow[d] = from_f<T>(val);
    }
  }
}

// ---------------------------------------------------------------------------
// dk/dv: one block per (kv tile, kv head, batch); the inner loop walks the
// GQA group's q heads x q tiles, so grouped heads accumulate in registers.
// ---------------------------------------------------------------------------

template <typename T, int D>
__global__ void __launch_bounds__(NT) bwd_dkv_kernel(
    const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
    const T* __restrict__ dout, const float* __restrict__ lse,
    const float* __restrict__ delta, T* __restrict__ dk, T* __restrict__ dv,
    const int* __restrict__ qpos, const int* __restrict__ kpos,
    const float* cq, const float* sq, const float* ck, const float* sk,
    int Hq, int Hkv, int Sq, int Sk, int causal, int static_causal) {
  constexpr int LD = D + 4, NJ = D / 16, H = D / 2;
  extern __shared__ float4 smem4[];
  float* Ks = reinterpret_cast<float*>(smem4);
  float* Vs = Ks + 64 * LD;
  float* Qs = Vs + 64 * LD;
  float* dOs = Qs + 64 * LD;
  float* Ps = dOs + 64 * LD;
  float* DSs = Ps + 64 * LDP;
  __shared__ int qp_s[BQ];
  __shared__ int kp_s[BK];
  __shared__ float lse_s[BQ];
  __shared__ float delta_s[BQ];

  const int kt = blockIdx.x, hk = blockIdx.y, b = blockIdx.z;
  const int n_rep = Hq / Hkv;
  const int k0 = kt * BK, nk = min(BK, Sk - k0);
  const int tid = threadIdx.x, ty = tid >> 4, tx = tid & 15;
  const size_t kv_base = (size_t)(b * Hkv + hk) * Sk;

  // k is constant across the inner loop: rotate it once per block
  load_tile<T, D>(Ks, k + kv_base * D, k0, Sk, ck, sk);
  load_tile<T, D>(Vs, v + kv_base * D, k0, Sk, nullptr, nullptr);
  if (tid < BK) kp_s[tid] = tid < nk ? kpos[k0 + tid] : 0;
  __syncthreads();
  int kmin, kmax;
  tile_minmax(kp_s, nk, kmin, kmax);

  float dk_acc[4][NJ], dv_acc[4][NJ];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
      dk_acc[i][j] = 0.f;
      dv_acc[i][j] = 0.f;
    }

  const int num_q = (Sq + BQ - 1) / BQ;
  // static-causal: q tiles before the first one that can see this kv tile
  // are never visited (_q_eff)
  const int qt_start = static_causal ? k0 / BQ : 0;
  for (int g = 0; g < n_rep; ++g) {
    const int h = hk * n_rep + g;
    const size_t row_base = (size_t)(b * Hq + h) * Sq;
    for (int qt = qt_start; qt < num_q; ++qt) {
      const int q0 = qt * BQ, nq = min(BQ, Sq - q0);
      __syncthreads();
      if (tid < BQ) {
        qp_s[tid] = tid < nq ? qpos[q0 + tid] : 0;
        lse_s[tid] = tid < nq ? lse[row_base + q0 + tid] : -INFINITY;
        delta_s[tid] = tid < nq ? delta[row_base + q0 + tid] : 0.f;
      }
      __syncthreads();
      int qmin = 0, qmax = 0;
      if (causal && !static_causal) tile_minmax(qp_s, nq, qmin, qmax);
      const TileClass tc = classify(causal, static_causal, q0, nq, k0, nk,
                                    qmin, qmax, kmin, kmax);
      if (!tc.visible) continue;
      load_tile<T, D>(Qs, q + row_base * D, q0, Sq, cq, sq);
      load_tile<T, D>(dOs, dout + row_base * D, q0, Sq, nullptr, nullptr);
      __syncthreads();

      float s[4][4], dp[4][4];
      tile_abt<D>(Qs, Ks, s);
      tile_abt<D>(dOs, Vs, dp);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int r = ty * 4 + i;
        const float lr = lse_s[r], dr = delta_s[r];
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int c = tx + 16 * j;
          float sv = s[i][j];
          if (!tc.full) {
            const bool ok = c < nk && (!causal || qp_s[r] >= kp_s[c]);
            if (!ok) sv = NEG;
          }
          const float p = lr <= NEG ? 0.f : expf(sv - lr);
          Ps[r * LDP + c] = round_t<T>(p);
          DSs[r * LDP + c] = round_t<T>(p * (dp[i][j] - dr));
        }
      }
      __syncthreads();
      tile_ptx<D>(Ps, dOs, dv_acc);
      tile_ptx<D>(DSs, Qs, dk_acc);
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = ty * 4 + i;
    if (r >= nk) continue;
    T* dkrow = dk + (kv_base + k0 + r) * D;
    T* dvrow = dv + (kv_base + k0 + r) * D;
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
      const int d = tx + 16 * j;
      float val = dk_acc[i][j];
      if (ck != nullptr) {  // back through the rotation's transpose
        const int dd = d < H ? d : d - H;
        const float c = ck[(size_t)(k0 + r) * H + dd];
        const float s = sk[(size_t)(k0 + r) * H + dd];
        val = j < NJ / 2 ? dk_acc[i][j] * c + dk_acc[i][j + NJ / 2] * s
                         : dk_acc[i][j] * c - dk_acc[i][j - NJ / 2] * s;
      }
      dkrow[d] = from_f<T>(val);
      dvrow[d] = from_f<T>(dv_acc[i][j]);
    }
  }
}

template <int D> constexpr size_t fwd_smem() { return (3 * 64 * (D + 4) + 64 * LDP) * sizeof(float); }
template <int D> constexpr size_t dq_smem() { return (4 * 64 * (D + 4) + 64 * LDP) * sizeof(float); }
template <int D> constexpr size_t dkv_smem() { return (4 * 64 * (D + 4) + 2 * 64 * LDP) * sizeof(float); }

template <typename T, int D>
cudaError_t launch_fwd(const void* q, const void* k, const void* v, void* out,
                       void* lse, const void* qpos, const void* kpos,
                       const void* cq, const void* sq, const void* ck,
                       const void* sk, int B, int Hq, int Hkv, int Sq, int Sk,
                       int causal, int static_causal, cudaStream_t stream) {
  constexpr size_t smem = fwd_smem<D>();
  cudaError_t err = cudaFuncSetAttribute(
      fwd_kernel<T, D>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  dim3 grid((Sq + BQ - 1) / BQ, Hq, B);
  fwd_kernel<T, D><<<grid, NT, smem, stream>>>(
      (const T*)q, (const T*)k, (const T*)v, (T*)out, (float*)lse,
      (const int*)qpos, (const int*)kpos, (const float*)cq, (const float*)sq,
      (const float*)ck, (const float*)sk, Hq, Hkv, Sq, Sk, causal,
      static_causal);
  return cudaGetLastError();
}

template <typename T, int D>
cudaError_t launch_dq(const void* q, const void* k, const void* v,
                      const void* dout, const void* lse, const void* delta,
                      void* dq, const void* qpos, const void* kpos,
                      const void* cq, const void* sq, const void* ck,
                      const void* sk, int B, int Hq, int Hkv, int Sq, int Sk,
                      int causal, int static_causal, cudaStream_t stream) {
  constexpr size_t smem = dq_smem<D>();
  cudaError_t err = cudaFuncSetAttribute(
      bwd_dq_kernel<T, D>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  dim3 grid((Sq + BQ - 1) / BQ, Hq, B);
  bwd_dq_kernel<T, D><<<grid, NT, smem, stream>>>(
      (const T*)q, (const T*)k, (const T*)v, (const T*)dout,
      (const float*)lse, (const float*)delta, (T*)dq, (const int*)qpos,
      (const int*)kpos, (const float*)cq, (const float*)sq, (const float*)ck,
      (const float*)sk, Hq, Hkv, Sq, Sk, causal, static_causal);
  return cudaGetLastError();
}

template <typename T, int D>
cudaError_t launch_dkv(const void* q, const void* k, const void* v,
                       const void* dout, const void* lse, const void* delta,
                       void* dk, void* dv, const void* qpos, const void* kpos,
                       const void* cq, const void* sq, const void* ck,
                       const void* sk, int B, int Hq, int Hkv, int Sq, int Sk,
                       int causal, int static_causal, cudaStream_t stream) {
  constexpr size_t smem = dkv_smem<D>();
  cudaError_t err = cudaFuncSetAttribute(
      bwd_dkv_kernel<T, D>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  dim3 grid((Sk + BK - 1) / BK, Hkv, B);
  bwd_dkv_kernel<T, D><<<grid, NT, smem, stream>>>(
      (const T*)q, (const T*)k, (const T*)v, (const T*)dout,
      (const float*)lse, (const float*)delta, (T*)dk, (T*)dv,
      (const int*)qpos, (const int*)kpos, (const float*)cq, (const float*)sq,
      (const float*)ck, (const float*)sk, Hq, Hkv, Sq, Sk, causal,
      static_causal);
  return cudaGetLastError();
}

}  // namespace

// dispatch on (input type, head dim); anything else is refused
#define PT_DISPATCH(FN, ...)                                              \
  if (is_bf16 && D == 64) return (int)FN<__nv_bfloat16, 64>(__VA_ARGS__);  \
  if (is_bf16 && D == 128) return (int)FN<__nv_bfloat16, 128>(__VA_ARGS__); \
  if (!is_bf16 && D == 64) return (int)FN<float, 64>(__VA_ARGS__);         \
  if (!is_bf16 && D == 128) return (int)FN<float, 128>(__VA_ARGS__);       \
  return (int)cudaErrorInvalidValue;

extern "C" {

int pt_flash_fwd(const void* q, const void* k, const void* v, void* out,
                 void* lse, const void* qpos, const void* kpos, const void* cq,
                 const void* sq, const void* ck, const void* sk, int B, int Hq,
                 int Hkv, int Sq, int Sk, int D, int causal, int static_causal,
                 int is_bf16, void* stream) {
  PT_DISPATCH(launch_fwd, q, k, v, out, lse, qpos, kpos, cq, sq, ck, sk, B,
              Hq, Hkv, Sq, Sk, causal, static_causal, (cudaStream_t)stream)
}

int pt_flash_bwd_dq(const void* q, const void* k, const void* v,
                    const void* dout, const void* lse, const void* delta,
                    void* dq, const void* qpos, const void* kpos,
                    const void* cq, const void* sq, const void* ck,
                    const void* sk, int B, int Hq, int Hkv, int Sq, int Sk,
                    int D, int causal, int static_causal, int is_bf16,
                    void* stream) {
  PT_DISPATCH(launch_dq, q, k, v, dout, lse, delta, dq, qpos, kpos, cq, sq,
              ck, sk, B, Hq, Hkv, Sq, Sk, causal, static_causal,
              (cudaStream_t)stream)
}

int pt_flash_bwd_dkv(const void* q, const void* k, const void* v,
                     const void* dout, const void* lse, const void* delta,
                     void* dk, void* dv, const void* qpos, const void* kpos,
                     const void* cq, const void* sq, const void* ck,
                     const void* sk, int B, int Hq, int Hkv, int Sq, int Sk,
                     int D, int causal, int static_causal, int is_bf16,
                     void* stream) {
  PT_DISPATCH(launch_dkv, q, k, v, dout, lse, delta, dk, dv, qpos, kpos, cq,
              sq, ck, sk, B, Hq, Hkv, Sq, Sk, causal, static_causal,
              (cudaStream_t)stream)
}

}  // extern "C"
