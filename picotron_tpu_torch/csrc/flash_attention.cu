// Flash attention for Hopper (sm_90a): forward, dq and dk/dv kernels.
//
// Replaces the three Pallas TPU kernels of picotron_tpu/ops/flash_attention.py:
//   fwd_mma_kernel     <- _fwd_kernel     (:139, pallas_call in _fwd :281), bf16
//   fwd_kernel         <- _fwd_kernel     (the same), fp32 inputs only
//   bwd_dq_mma_kernel  <- _bwd_dq_kernel  (:327, pallas_call in _bwd :543), bf16
//   bwd_dq_kernel      <- _bwd_dq_kernel  (the same), fp32 inputs only
//   bwd_dkv_mma_kernel <- _bwd_dkv_kernel (:412, pallas_call in _bwd :593), bf16
//   bwd_dkv_kernel     <- _bwd_dkv_kernel (the same), fp32 inputs only
//
// What bounds it on the card: causal attention at the training shapes
// (S = 2048, D = 64) does ~S/2 multiply-adds per loaded element, far above
// the H100's ~295 FLOP/byte ridge, so the work is bound by operations, not
// by device-memory bytes.
//
// The bf16 forward (fwd_mma_kernel, the main path's) therefore runs both
// products on the tensor cores: mma.sync m16n8k16 bf16 with fp32
// accumulation. One block of 4 warps per (64-row q tile, q head, batch),
// each warp owning 16 q rows, heaviest causal tiles launched first. Q is
// loaded once, rotated, and kept as ldmatrix A fragments in registers for
// the whole kv loop; K/V tiles stream through a two-stage shared-memory
// ring filled by 16-byte cp.async copies (rows padded by 16 bytes, so
// ldmatrix is free of bank conflicts), the copy of the next visible tile
// (with its RoPE table rows, in the region Q no longer needs) issued
// before the current tile's products and rotated in place once it lands;
// the online softmax runs on the S accumulator fragments, and P is rounded
// to bf16 and packed straight from them into the A fragments of O += P V
// (the m16n8 C layout of two neighbouring n-tiles is the m16k16 A layout),
// so P never touches shared memory. One barrier per tile, two with RoPE.
// The per-tile K rotation costs about a third of the kernel's time at the
// training shape (PERF.md); wgmma, TMA and warp specialisation are later
// steps.
//
// The bf16 dk/dv (bwd_dkv_mma_kernel) is bound by operations too (8 D
// FLOPs per visible (q, k) pair against the same bytes), and runs its four
// products on the tensor cores with the forward's building blocks, the
// roles turned round: one block of 4 warps per (64-row kv tile, kv head,
// batch), each warp owning 16 kv rows of dK and dV. K and V are copied
// once and stay resident (K rotated in place once per block); Q, dO and
// each q row's position, lse and delta stream through a two-stage cp.async
// ring over (GQA head x q tile), the next visible step's copy issued
// before the current one's products, invisible steps never copied, and
// the landed Q tile rotated in place once (S^T and dK share it). The
// products are taken transposed (S^T = K Q^T, dV += P^T dO, dP^T = V dO^T,
// dK += dS^T Q), so the kv rows are the mma rows and P^T and dS^T (from
// the fp32 P) go from the accumulator fragments straight into bf16 A
// fragments: neither touches shared memory, and nothing stands between
// the products. GQA heads accumulate in registers with no atomics. One
// barrier per step, two with RoPE.
//
// The bf16 dq (bwd_dq_mma_kernel) is bound by operations as well (6 D
// FLOPs per visible pair), and runs its three products on the tensor
// cores with the forward's data flow: one block of 4 warps per (64-row q
// tile, q head, batch), heaviest causal tiles first, each warp owning 16
// q rows of dQ. Q (rotated once) and dO are copied once and stay resident
// as A fragments in registers, each lane holding its two rows' lse and
// delta; K/V tiles stream through the forward's two-stage cp.async ring,
// the next visible tile's copy issued before the current tile's products
// and K rotated in place once it lands (rotated K is the B operand of
// both S = Q K^T and dQ += dS K). dP = dO V^T takes V's rows as K's are
// taken for S; dS = P (dP - delta), from the fp32 P, is rounded to bf16
// and packed from the accumulator fragments straight into A fragments,
// so dS never touches shared memory. One barrier per tile, two with
// RoPE; dq goes back through the rotation's transpose in registers.
//
// The fp32 kernels (fwd_kernel, bwd_dq_kernel, bwd_dkv_kernel) are the
// first version: fp32 FMAs on CUDA cores (67 TFLOP/s peak) rather than
// the tensor cores (989 TFLOP/s bf16), designed to keep every operand on
// chip: one block of
// 256 threads per (batch, head, 64-row tile), Q/K/V/dO tiles converted to
// fp32 in shared memory (rows padded by 4 floats so the float4 reads are
// free of bank conflicts), each thread owning a 4 x 4 block of scores and
// a 4 x D/16 block of the accumulator. In every kernel the TPU's
// sequential grid axis is a loop inside the block (over kv tiles for the
// forward and dq, over (group head, q tile) for dk/dv, so grouped heads
// accumulate in registers with no atomics).
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
// The bf16 forward also needs q, k, v, out and the tables 16-byte aligned,
// the bf16 dq q, k, v, dout, dq and the tables, the bf16 dk/dv q, k, v,
// dout, dk, dv and the tables.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <limits.h>
#include <math.h>
#include <stddef.h>
#include <stdint.h>

namespace {

constexpr int BQ = 64;
constexpr int BK = 64;
constexpr int NT = 256;
constexpr int LDP = BK + 4;
constexpr float NEG = -1e30f;

// the CUDA-core kernels are instantiated for fp32 inputs alone
template <typename T> __device__ __forceinline__ float to_f(T x);
template <> __device__ __forceinline__ float to_f<float>(float x) { return x; }
template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) { return x; }
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
// Forward on CUDA cores, for fp32 inputs (bf16 runs fwd_mma_kernel): one
// block per (q tile, q head, batch); loop over kv tiles with the online
// softmax (m, l, acc) in registers.
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
// Forward on the tensor cores (bf16): mma.sync m16n8k16, ldmatrix, and a
// two-stage cp.async ring of K/V tiles. Fragment layouts (PTX ISA, per
// lane: g = lane / 4, t = lane % 4): A 16x16 in a[0..3] = (row g, cols
// 2t..2t+1), (g + 8, 2t), (g, 2t + 8), (g + 8, 2t + 8); B 16x8 in b[0..1] =
// (rows 2t..2t+1, col g), (2t + 8, g); C 16x8 in c[0..3] = (row g, cols
// 2t, 2t + 1), (g + 8, 2t, 2t + 1).
// ---------------------------------------------------------------------------

constexpr int MMA_NT = 128;  // 4 warps, 16 q rows each
constexpr float LOG2E = 1.4426950408889634f;

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16-byte async copy global -> shared; with full = false it reads nothing
// and zero-fills the 16 bytes (rows past the end of a sequence)
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool full) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src), "r"(full ? 16 : 0)
               : "memory");
}
// the same for one 4-byte word (zero-filled with full = false)
__device__ __forceinline__ void cp_async4(void* dst, const void* src,
                                          bool full) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src), "r"(full ? 4 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
// wait until at most N of this thread's committed groups are in flight
template <int N> __device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// four 8x8 bf16 matrices from shared memory; lanes 8i..8i+7 give the row
// addresses of matrix i, and r[i] holds (row g, cols 2t, 2t + 1) of it
__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p)));
}
// the same, each matrix transposed: r[i] holds (rows 2t, 2t + 1, col g)
__device__ __forceinline__ void ldsm_x4_trans(uint32_t (&r)[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p)));
}

// c += a (16x16, row) * b (16x8, col), bf16 in, fp32 accumulate
__device__ __forceinline__ void mma_16816(float (&c)[4], const uint32_t (&a)[4],
                                          uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// 2^x on the special-function unit (2 ulp; results below 2^-126 flush to
// 0, and 2^-inf = 0)
__device__ __forceinline__ float fast_exp2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// two fp32 values rounded to bf16 (nearest even), lo in the low half
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}
__device__ __forceinline__ void unpack8(uint4 u, float (&f)[8]) {
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 p = __bfloat1622float2(h[i]);
    f[2 * i] = p.x;
    f[2 * i + 1] = p.y;
  }
}
__device__ __forceinline__ uint4 pack8(const float (&f)[8]) {
  return make_uint4(pack_bf16(f[0], f[1]), pack_bf16(f[2], f[3]),
                    pack_bf16(f[4], f[5]), pack_bf16(f[6], f[7]));
}

// Rotate-half RoPE in place on rows [0, n) of a bf16 tile in shared memory
// (row stride D + 8) with the tile's rows of the gathered fp32 tables (row
// stride ldt, in device or shared memory): fp32 math rounded to bf16, the
// same rounding point as load_tile (and as the TPU kernels' _rot). Rows
// past n stay zero.
template <int D>
__device__ __forceinline__ void rope_tile(__nv_bfloat16* t, int n,
                                          const float* tc, const float* ts,
                                          int ldt) {
  constexpr int H = D / 2, LDS = D + 8, CH = H / 8;
  // consecutive lanes take consecutive rows: with 16-byte row padding the
  // 16-byte accesses of 8 lanes fall in distinct banks
  for (int idx = threadIdx.x; idx < BK * CH; idx += MMA_NT) {
    const int r = idx % BK, d = (idx / BK) * 8;
    if (r >= n) continue;
    uint4* lo = reinterpret_cast<uint4*>(t + r * LDS + d);
    uint4* hi = reinterpret_cast<uint4*>(t + r * LDS + d + H);
    const float4* c4 = reinterpret_cast<const float4*>(tc + (size_t)r * ldt + d);
    const float4* s4 = reinterpret_cast<const float4*>(ts + (size_t)r * ldt + d);
    const float4 c0 = c4[0], c1 = c4[1], s0 = s4[0], s1 = s4[1];
    const float c[8] = {c0.x, c0.y, c0.z, c0.w, c1.x, c1.y, c1.z, c1.w};
    const float s[8] = {s0.x, s0.y, s0.z, s0.w, s1.x, s1.y, s1.z, s1.w};
    float x[8], y[8], xr[8], yr[8];
    unpack8(*lo, x);
    unpack8(*hi, y);
    // each product rounded on its own (no FMA contraction), as the plain
    // version's separate fp32 ops round them, so the bf16 results agree
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      xr[i] = __fsub_rn(__fmul_rn(x[i], c[i]), __fmul_rn(y[i], s[i]));
      yr[i] = __fadd_rn(__fmul_rn(y[i], c[i]), __fmul_rn(x[i], s[i]));
    }
    *lo = pack8(xr);
    *hi = pack8(yr);
  }
}

// Shared memory of fwd_mma_kernel: a first region that holds the Q tile
// and then, once Q's fragments are in registers, the next kv tile's RoPE
// table rows (cos then sin, fp32 rows of D/2 + 4); then two stages of K
// and two of V (bf16 rows of D + 8).
template <int D> __host__ __device__ constexpr int fwd_mma_head_bytes() {
  return BQ * (D + 8) * 2 > 2 * BK * (D / 2 + 4) * 4 ? BQ * (D + 8) * 2
                                                      : 2 * BK * (D / 2 + 4) * 4;
}
template <int D> constexpr size_t fwd_mma_smem() {
  return fwd_mma_head_bytes<D>() + 4 * BK * (D + 8) * 2;
}

// minimum blocks per SM: 3 at D 64 and 2 at D 128, the most that fit
// without register spills (ptxas: 152 and 200 registers)
template <int D>
__global__ void __launch_bounds__(MMA_NT, D == 64 ? 3 : 2) fwd_mma_kernel(
    const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
    const __nv_bfloat16* __restrict__ v, __nv_bfloat16* __restrict__ out,
    float* __restrict__ lse, const int* __restrict__ qpos,
    const int* __restrict__ kpos, const float* cq, const float* sq,
    const float* ck, const float* sk, int Hq, int Hkv, int Sq, int Sk,
    int causal, int static_causal) {
  using bf16 = __nv_bfloat16;
  // LDS: tile row stride, padded by 16 bytes; CH: 16-byte chunks per row;
  // KD: k-steps of S = Q K^T; ND: 8-column n-tiles of O; LDT: table row
  // stride, padded by 16 bytes
  constexpr int LDS = D + 8, CH = D / 8, KD = D / 16, ND = D / 8;
  constexpr int H = D / 2, LDT = H + 4;
  extern __shared__ float4 smem4[];
  bf16* Qs = reinterpret_cast<bf16*>(smem4);
  float* Tab = reinterpret_cast<float*>(smem4);  // after Q: BK cos, BK sin rows
  bf16* Ks = reinterpret_cast<bf16*>(reinterpret_cast<char*>(smem4) +
                                     fwd_mma_head_bytes<D>());  // two stages
  bf16* Vs = Ks + 2 * BK * LDS;  // two stages
  __shared__ int qp_s[BQ];
  __shared__ int kp_ring[2 * BK];

  const int num_q = (Sq + BQ - 1) / BQ;
  // static-causal: the heaviest q tiles (most kv tiles) launch first, so
  // the longest rows do not start last
  const int qt = static_causal ? num_q - 1 - (int)blockIdx.x : (int)blockIdx.x;
  const int h = blockIdx.y, b = blockIdx.z;
  const int hk = h / (Hq / Hkv);
  const int q0 = qt * BQ, nq = min(BQ, Sq - q0);
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, tig = lane & 3;
  const size_t row_base = (size_t)(b * Hq + h) * Sq;
  const bf16* qb = q + row_base * D;
  const bf16* kb = k + (size_t)(b * Hkv + hk) * Sk * D;
  const bf16* vb = v + (size_t)(b * Hkv + hk) * Sk * D;

  // the Q tile: one cp.async group, rows past Sq zero-filled
  for (int idx = tid; idx < BQ * CH; idx += MMA_NT) {
    const int r = idx / CH, c8 = (idx % CH) * 8;
    cp_async16(Qs + r * LDS + c8, qb + (size_t)(r < nq ? q0 + r : 0) * D + c8,
               r < nq);
  }
  cp_async_commit();
  if (tid < BQ) qp_s[tid] = tid < nq ? qpos[q0 + tid] : 0;
  __syncthreads();
  int qmin, qmax;
  tile_minmax(qp_s, nq, qmin, qmax);

  const int num_kv = (Sk + BK - 1) / BK;
  // static-causal: no kv tile past the last one this q tile can see
  const int kv_end = static_causal ? min(num_kv, (q0 + nq - 1) / BK + 1) : num_kv;
  auto tile_class = [&](int kt) {
    const int k0 = kt * BK, nk = min(BK, Sk - k0);
    int kmin = 0, kmax = 0;
    if (causal && !static_causal) tile_minmax(kpos + k0, nk, kmin, kmax);
    return classify(causal, static_causal, q0, nq, k0, nk, qmin, qmax, kmin,
                    kmax);
  };
  // the first visible kv tile at or after kt (kv_end if none) and its
  // class: invisible tiles are neither copied nor multiplied
  auto next_visible = [&](int kt, TileClass& cls) {
    for (; kt < kv_end; ++kt) {
      cls = tile_class(kt);
      if (cls.visible) return kt;
    }
    return kv_end;
  };
  // start the copies of kv tile kt into ring stage st (K, V and position
  // rows past Sk zero-filled)
  auto issue_kv = [&](int kt, int st) {
    const int k0 = kt * BK, nk = min(BK, Sk - k0);
    bf16* ks = Ks + st * BK * LDS;
    bf16* vs = Vs + st * BK * LDS;
    for (int idx = tid; idx < BK * CH; idx += MMA_NT) {
      const int r = idx / CH, c8 = (idx % CH) * 8;
      const size_t off = (size_t)(r < nk ? k0 + r : 0) * D + c8;
      cp_async16(ks + r * LDS + c8, kb + off, r < nk);
      cp_async16(vs + r * LDS + c8, vb + off, r < nk);
    }
    if (causal && tid < BK)
      cp_async4(kp_ring + st * BK + tid, kpos + (tid < nk ? k0 + tid : 0),
                tid < nk);
  };
  // start the copies of kv tile kt's RoPE table rows into Tab
  auto issue_tab = [&](int kt) {
    const int k0 = kt * BK, nk = min(BK, Sk - k0);
    constexpr int TC = H / 4;  // 16-byte chunks per table row
    for (int idx = tid; idx < 2 * BK * TC; idx += MMA_NT) {
      const int r = (idx / TC) % BK, c4 = (idx % TC) * 4;
      const float* src = idx < BK * TC ? ck : sk;
      cp_async16(Tab + (idx / TC) * LDT + c4,
                 src + (size_t)(r < nk ? k0 + r : 0) * H + c4, r < nk);
    }
  };

  TileClass cls_cur, cls_next;
  int kt = next_visible(0, cls_cur);
  if (kt < kv_end) issue_kv(kt, 0);
  cp_async_commit();
  cp_async_wait<1>();  // the Q group has landed (the first kv tile may not)
  __syncthreads();
  if (cq != nullptr) {  // q is constant across the kv loop: rotate it once
    rope_tile<D>(Qs, nq, cq + (size_t)q0 * H, sq + (size_t)q0 * H, H);
    __syncthreads();
  }
  // Q's A fragments for this warp's 16 rows, resident for the whole loop
  uint32_t qf[KD][4];
#pragma unroll
  for (int kk = 0; kk < KD; ++kk)
    ldsm_x4(qf[kk], Qs + (warp * 16 + (lane & 7) + ((lane >> 3) & 1) * 8) * LDS
                        + kk * 16 + (lane >> 4) * 8);
  if (ck != nullptr && kt < kv_end) {
    __syncthreads();  // every warp holds its Q fragments: Tab may take over
    issue_tab(kt);
    cp_async_commit();
  }
  cp_async_wait<0>();  // the first kv tile (and its tables) landed
  __syncthreads();
  if (ck != nullptr && kt < kv_end) {
    rope_tile<D>(Ks, min(BK, Sk - kt * BK), Tab, Tab + BK * LDT, LDT);
    __syncthreads();
  }

  float o[ND][4], m[2] = {NEG, NEG}, l[2] = {0.f, 0.f};
#pragma unroll
  for (int j = 0; j < ND; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[j][e] = 0.f;

  int st = 0;
  while (kt < kv_end) {
    // tile kt is in stage st, rotated; stage st ^ 1 and Tab are free (every
    // warp passed the barriers that closed the last tile): start tile kn
    const int kn = next_visible(kt + 1, cls_next);
    if (kn < kv_end) {
      issue_kv(kn, st ^ 1);
      if (ck != nullptr) issue_tab(kn);
    }
    cp_async_commit();
    const int nk = min(BK, Sk - kt * BK);
    const bf16* ks = Ks + st * BK * LDS;
    const bf16* vs = Vs + st * BK * LDS;
    const int* kp_s = kp_ring + st * BK;

    // S = Q K^T: this warp's 16 x 64 scores in 8 n-tiles of 4 registers
    float s[8][4];
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < KD; ++kk) {
#pragma unroll
      for (int j2 = 0; j2 < 4; ++j2) {
        // K rows j2*16.. as the B fragments of n-tiles 2 j2 and 2 j2 + 1
        uint32_t kf[4];
        ldsm_x4(kf, ks + (j2 * 16 + (lane & 7) + (lane >> 4) * 8) * LDS
                       + kk * 16 + ((lane >> 3) & 1) * 8);
        mma_16816(s[2 * j2], qf[kk], kf[0], kf[1]);
        mma_16816(s[2 * j2 + 1], qf[kk], kf[2], kf[3]);
      }
    }
    if (!cls_cur.full) {
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int r = warp * 16 + g + (e >> 1) * 8;
          const int c = j * 8 + tig * 2 + (e & 1);
          const bool ok = c < nk && (!causal || qp_s[r] >= kp_s[c]);
          if (!ok) s[j][e] = NEG;
        }
    }
    // online softmax on the fragments: this lane holds rows g (e = 0, 1)
    // and g + 8 (e = 2, 3); a row's 64 scores are spread over one quad
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      float mx = NEG;
#pragma unroll
      for (int j = 0; j < 8; ++j) mx = fmaxf(mx, fmaxf(s[j][2 * i], s[j][2 * i + 1]));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      const float m_new = fmaxf(m[i], mx);
      // exp(x) as exp2(x log2 e)
      const float alpha = m[i] <= NEG ? 0.f : fast_exp2((m[i] - m_new) * LOG2E);
      // a fully masked row has m_new = NEG: exp(NEG - NEG) must be 0, so
      // its shift is +inf
      const float mb = m_new <= NEG ? INFINITY : m_new * LOG2E;
      float rs = 0.f;
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int e = 2 * i; e < 2 * i + 2; ++e) {
          const float p = fast_exp2(fmaf(s[j][e], LOG2E, -mb));
          rs += p;  // l sums p before its bf16 rounding
          s[j][e] = p;
        }
      rs += __shfl_xor_sync(0xffffffffu, rs, 1);
      rs += __shfl_xor_sync(0xffffffffu, rs, 2);
      l[i] = l[i] * alpha + rs;
      m[i] = m_new;
#pragma unroll
      for (int j = 0; j < ND; ++j) {
        o[j][2 * i] *= alpha;
        o[j][2 * i + 1] *= alpha;
      }
    }
    // O += P V: P's A fragment for kv columns 16 kk.. is n-tiles 2 kk and
    // 2 kk + 1 of S, rounded to bf16; V's B fragments by ldmatrix.trans
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) {
      uint32_t pa[4];
      pa[0] = pack_bf16(s[2 * kk][0], s[2 * kk][1]);
      pa[1] = pack_bf16(s[2 * kk][2], s[2 * kk][3]);
      pa[2] = pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]);
      pa[3] = pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3]);
#pragma unroll
      for (int n2 = 0; n2 < ND / 2; ++n2) {
        uint32_t vf[4];
        ldsm_x4_trans(vf, vs + (kk * 16 + (lane & 7) + ((lane >> 3) & 1) * 8) * LDS
                            + n2 * 16 + (lane >> 4) * 8);
        mma_16816(o[2 * n2], pa, vf[0], vf[1]);
        mma_16816(o[2 * n2 + 1], pa, vf[2], vf[3]);
      }
    }
    cp_async_wait<0>();  // tile kn has landed
    __syncthreads();     // for every warp; and stage st is free for a refill
    if (ck != nullptr && kn < kv_end) {
      rope_tile<D>(Ks + (st ^ 1) * BK * LDS, min(BK, Sk - kn * BK), Tab,
                   Tab + BK * LDT, LDT);
      __syncthreads();  // tile kn is rotated, and Tab is free
    }
    kt = kn;
    cls_cur = cls_next;
    st ^= 1;
  }

  // O / l rounded to bf16, staged through this warp's own 16 rows of Qs
  // (no other warp reads them, and no table copy is in flight) for
  // 16-byte row stores
  bf16* stage = Qs + warp * 16 * LDS;
  __syncwarp();
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const float inv_l = 1.f / (l[i] == 0.f ? 1.f : l[i]);
#pragma unroll
    for (int j = 0; j < ND; ++j)
      *reinterpret_cast<uint32_t*>(stage + (g + 8 * i) * LDS + j * 8 + tig * 2) =
          pack_bf16(o[j][2 * i] * inv_l, o[j][2 * i + 1] * inv_l);
  }
  __syncwarp();
  for (int idx = lane; idx < 16 * CH; idx += 32) {
    const int r = idx / CH, c8 = (idx % CH) * 8, row = warp * 16 + r;
    if (row < nq)
      *reinterpret_cast<uint4*>(out + (row_base + q0 + row) * D + c8) =
          *reinterpret_cast<const uint4*>(stage + r * LDS + c8);
  }
  if (tig == 0) {
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int row = warp * 16 + g + 8 * i;
      if (row < nq)
        lse[row_base + q0 + row] = l[i] == 0.f ? -INFINITY : m[i] + logf(l[i]);
    }
  }
}

// ---------------------------------------------------------------------------
// dq on CUDA cores, for fp32 inputs (bf16 runs bwd_dq_mma_kernel): one
// block per (q tile, q head, batch); loop over kv tiles, P recomputed from
// the saved LSE, ds = p * (dp - delta).
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
// dq on the tensor cores (bf16), the design in the note at the top: per kv
// tile, with this warp's 16 q rows as the mma rows and the kv columns as
// the n-dimension,
//   S = Q K^T, P = exp(S - lse), dP = dO V^T, dS = P (dP - delta),
//   dQ += dS K.
// Fragment layouts as for fwd_mma_kernel.
// ---------------------------------------------------------------------------

// Shared memory of bwd_dq_mma_kernel: a first region that holds the Q and
// dO tiles and then, once their fragments are in registers, the next kv
// tile's RoPE table rows (cos then sin, fp32 rows of D/2 + 4; the two
// uses take the same bytes); then two stages of K and two of V (bf16 rows
// of D + 8): 55,296 bytes at D 64 and 104,448 at D 128, plus 768 static
// (positions), so shared memory allows 4 and 2 blocks per SM.
template <int D> __host__ __device__ constexpr int dq_mma_head_bytes() {
  return 2 * BQ * (D + 8) * 2 > 2 * BK * (D / 2 + 4) * 4
             ? 2 * BQ * (D + 8) * 2
             : 2 * BK * (D / 2 + 4) * 4;
}
template <int D> constexpr size_t dq_mma_smem() {
  return dq_mma_head_bytes<D>() + 4 * BK * (D + 8) * 2;
}

// Blocks per SM: 3 at D 64 and 2 at D 128 (the second set by shared
// memory). The live set is the dQ accumulators (D/2 registers), Q's and
// dO's resident A fragments (D/4 each), and S and dP for KC kv columns at
// a time (KC/2 each). The instructions are the same for any KC, so KC is
// chosen for registers, by measurement (kernels/variants.py on an H100 at
// the training shapes, PERF.md): at D 64, KC 64 takes 220 registers (2
// blocks per SM) and KC 16 159 (3 blocks, no spills), 16% faster, while
// KC 32 spills at the 168 registers that 3 blocks allow; at D 128, KC 32
// takes 246 registers and KC 64 255, neither spilling, and KC 32 is no
// slower. Reading dO's fragments from shared memory at each k-step instead
// would keep its tile beside the table rows: one block per SM at D 128.
template <int D>
__global__ void __launch_bounds__(MMA_NT, D == 64 ? 3 : 2) bwd_dq_mma_kernel(
    const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
    const __nv_bfloat16* __restrict__ v, const __nv_bfloat16* __restrict__ dout,
    const float* __restrict__ lse, const float* __restrict__ delta,
    __nv_bfloat16* __restrict__ dq, const int* __restrict__ qpos,
    const int* __restrict__ kpos, const float* cq, const float* sq,
    const float* ck, const float* sk, int Hq, int Hkv, int Sq, int Sk,
    int causal, int static_causal) {
  using bf16 = __nv_bfloat16;
  // LDS: tile row stride, padded by 16 bytes; CH: 16-byte chunks per row;
  // KD: k-steps of S and dP (over d); ND: 8-column n-tiles of dQ; LDT:
  // table row stride, padded by 16 bytes
  constexpr int LDS = D + 8, CH = D / 8, KD = D / 16, ND = D / 8;
  constexpr int H = D / 2, LDT = H + 4;
  // KC: kv columns per pass of S, dP and dQ += dS K (see above); NC:
  // n-tiles per pass
  constexpr int KC = D == 64 ? 16 : 32, NC = KC / 8;
  extern __shared__ float4 smem4[];
  bf16* Qs = reinterpret_cast<bf16*>(smem4);
  bf16* dOs = Qs + BQ * LDS;
  float* Tab = reinterpret_cast<float*>(smem4);  // after Q, dO: cos, sin rows
  bf16* Ks = reinterpret_cast<bf16*>(reinterpret_cast<char*>(smem4) +
                                     dq_mma_head_bytes<D>());  // two stages
  bf16* Vs = Ks + 2 * BK * LDS;  // two stages
  __shared__ int qp_s[BQ];
  __shared__ int kp_ring[2 * BK];

  const int num_q = (Sq + BQ - 1) / BQ;
  // static-causal: the heaviest q tiles (most kv tiles) launch first, so
  // the longest rows do not start last
  const int qt = static_causal ? num_q - 1 - (int)blockIdx.x : (int)blockIdx.x;
  const int h = blockIdx.y, b = blockIdx.z;
  const int hk = h / (Hq / Hkv);
  const int q0 = qt * BQ, nq = min(BQ, Sq - q0);
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, tig = lane & 3;
  const size_t row_base = (size_t)(b * Hq + h) * Sq;
  const bf16* kb = k + (size_t)(b * Hkv + hk) * Sk * D;
  const bf16* vb = v + (size_t)(b * Hkv + hk) * Sk * D;

  // the Q and dO tiles: one cp.async group, rows past Sq zero-filled
  for (int idx = tid; idx < BQ * CH; idx += MMA_NT) {
    const int r = idx / CH, c8 = (idx % CH) * 8;
    const size_t off = (row_base + (r < nq ? q0 + r : 0)) * D + c8;
    cp_async16(Qs + r * LDS + c8, q + off, r < nq);
    cp_async16(dOs + r * LDS + c8, dout + off, r < nq);
  }
  cp_async_commit();
  if (tid < BQ) qp_s[tid] = tid < nq ? qpos[q0 + tid] : 0;
  // lse and delta of this lane's rows g and g + 8 of the warp's 16 (i = 0,
  // 1): exp(x) as exp2(x log2 e), and a row with no visible key (lse =
  // -inf) or past Sq must give P = 0, so its shift is +inf
  float lb[2], dl[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int r = warp * 16 + g + 8 * i;
    const float lr = r < nq ? lse[row_base + q0 + r] : -INFINITY;
    lb[i] = lr <= NEG ? INFINITY : lr * LOG2E;
    dl[i] = r < nq ? delta[row_base + q0 + r] : 0.f;
  }
  __syncthreads();
  int qmin, qmax;
  tile_minmax(qp_s, nq, qmin, qmax);

  const int num_kv = (Sk + BK - 1) / BK;
  // static-causal: no kv tile past the last one this q tile can see
  const int kv_end = static_causal ? min(num_kv, (q0 + nq - 1) / BK + 1) : num_kv;
  auto tile_class = [&](int kt) {
    const int k0 = kt * BK, nk = min(BK, Sk - k0);
    int kmin = 0, kmax = 0;
    if (causal && !static_causal) tile_minmax(kpos + k0, nk, kmin, kmax);
    return classify(causal, static_causal, q0, nq, k0, nk, qmin, qmax, kmin,
                    kmax);
  };
  // the first visible kv tile at or after kt (kv_end if none) and its
  // class: invisible tiles are neither copied nor multiplied
  auto next_visible = [&](int kt, TileClass& cls) {
    for (; kt < kv_end; ++kt) {
      cls = tile_class(kt);
      if (cls.visible) return kt;
    }
    return kv_end;
  };
  // start the copies of kv tile kt into ring stage st (K, V and position
  // rows past Sk zero-filled)
  auto issue_kv = [&](int kt, int st) {
    const int k0 = kt * BK, nk = min(BK, Sk - k0);
    bf16* ks = Ks + st * BK * LDS;
    bf16* vs = Vs + st * BK * LDS;
    for (int idx = tid; idx < BK * CH; idx += MMA_NT) {
      const int r = idx / CH, c8 = (idx % CH) * 8;
      const size_t off = (size_t)(r < nk ? k0 + r : 0) * D + c8;
      cp_async16(ks + r * LDS + c8, kb + off, r < nk);
      cp_async16(vs + r * LDS + c8, vb + off, r < nk);
    }
    if (causal && tid < BK)
      cp_async4(kp_ring + st * BK + tid, kpos + (tid < nk ? k0 + tid : 0),
                tid < nk);
  };
  // start the copies of kv tile kt's RoPE table rows into Tab
  auto issue_tab = [&](int kt) {
    const int k0 = kt * BK, nk = min(BK, Sk - k0);
    constexpr int TC = H / 4;  // 16-byte chunks per table row
    for (int idx = tid; idx < 2 * BK * TC; idx += MMA_NT) {
      const int r = (idx / TC) % BK, c4 = (idx % TC) * 4;
      const float* src = idx < BK * TC ? ck : sk;
      cp_async16(Tab + (idx / TC) * LDT + c4,
                 src + (size_t)(r < nk ? k0 + r : 0) * H + c4, r < nk);
    }
  };

  TileClass cls_cur, cls_next;
  int kt = next_visible(0, cls_cur);
  if (kt < kv_end) issue_kv(kt, 0);
  cp_async_commit();
  cp_async_wait<1>();  // Q and dO have landed (the first kv tile may not)
  __syncthreads();
  if (cq != nullptr) {  // q is constant across the kv loop: rotate it once
    rope_tile<D>(Qs, nq, cq + (size_t)q0 * H, sq + (size_t)q0 * H, H);
    __syncthreads();
  }
  // Q's and dO's A fragments for this warp's 16 rows, resident for the
  // whole loop: lanes 8i..8i+7 address matrix i (rows 0-7 / 8-15, k
  // columns 0-7 / 8-15)
  const int a_off = (warp * 16 + (lane & 7) + ((lane >> 3) & 1) * 8) * LDS +
                    (lane >> 4) * 8;
  uint32_t qf[KD][4], of[KD][4];
#pragma unroll
  for (int kk = 0; kk < KD; ++kk) {
    ldsm_x4(qf[kk], Qs + a_off + kk * 16);
    ldsm_x4(of[kk], dOs + a_off + kk * 16);
  }
  if (ck != nullptr && kt < kv_end) {
    __syncthreads();  // every warp holds its fragments: Tab may take over
    issue_tab(kt);
    cp_async_commit();
  }
  cp_async_wait<0>();  // the first kv tile (and its tables) landed
  __syncthreads();
  if (ck != nullptr && kt < kv_end) {
    rope_tile<D>(Ks, min(BK, Sk - kt * BK), Tab, Tab + BK * LDT, LDT);
    __syncthreads();
  }

  float acc[ND][4];
#pragma unroll
  for (int j = 0; j < ND; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] = 0.f;

  int st = 0;
  while (kt < kv_end) {
    // tile kt is in stage st, rotated; stage st ^ 1 and Tab are free (every
    // warp passed the barriers that closed the last tile): start tile kn
    const int kn = next_visible(kt + 1, cls_next);
    if (kn < kv_end) {
      issue_kv(kn, st ^ 1);
      if (ck != nullptr) issue_tab(kn);
    }
    cp_async_commit();
    const int nk = min(BK, Sk - kt * BK);
    const bf16* ks = Ks + st * BK * LDS;
    const bf16* vs = Vs + st * BK * LDS;
    const int* kp_s = kp_ring + st * BK;

#pragma unroll
    for (int c0 = 0; c0 < BK; c0 += KC) {
      // S = Q K^T and dP = dO V^T for kv columns c0..c0+KC: this warp's 16
      // q rows x KC columns in NC n-tiles of 4 registers each
      float s[NC][4], dp[NC][4];
#pragma unroll
      for (int j = 0; j < NC; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          s[j][e] = 0.f;
          dp[j][e] = 0.f;
        }
#pragma unroll
      for (int kk = 0; kk < KD; ++kk) {
#pragma unroll
        for (int j2 = 0; j2 < NC / 2; ++j2) {
          // K and V rows c0 + j2*16.. as the B fragments of n-tiles 2 j2
          // and 2 j2 + 1
          const int off = (c0 + j2 * 16 + (lane & 7) + (lane >> 4) * 8) * LDS
                          + kk * 16 + ((lane >> 3) & 1) * 8;
          uint32_t kf[4], vf[4];
          ldsm_x4(kf, ks + off);
          mma_16816(s[2 * j2], qf[kk], kf[0], kf[1]);
          mma_16816(s[2 * j2 + 1], qf[kk], kf[2], kf[3]);
          ldsm_x4(vf, vs + off);
          mma_16816(dp[2 * j2], of[kk], vf[0], vf[1]);
          mma_16816(dp[2 * j2 + 1], of[kk], vf[2], vf[3]);
        }
      }
      // P = exp(S - lse) in fp32, then dS = P (dP - delta) from the fp32 P:
      // this lane holds rows g (e = 0, 1) and g + 8 (e = 2, 3) at kv
      // columns 2 tig, 2 tig + 1 of each n-tile
#pragma unroll
      for (int j = 0; j < NC; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          float sv = s[j][e];
          if (!cls_cur.full) {
            const int r = warp * 16 + g + (e >> 1) * 8;
            const int c = c0 + j * 8 + tig * 2 + (e & 1);
            const bool ok = c < nk && (!causal || qp_s[r] >= kp_s[c]);
            if (!ok) sv = NEG;
          }
          const float pv = fast_exp2(fmaf(sv, LOG2E, -lb[e >> 1]));
          dp[j][e] = pv * (dp[j][e] - dl[e >> 1]);
        }
      // dQ += dS K: dS's A fragment for kv columns c0 + 16 kk.. is n-tiles
      // 2 kk and 2 kk + 1 of dS, rounded to bf16; rotated K's B fragments
      // by ldmatrix.trans
#pragma unroll
      for (int kk = 0; kk < NC / 2; ++kk) {
        uint32_t da[4];
        da[0] = pack_bf16(dp[2 * kk][0], dp[2 * kk][1]);
        da[1] = pack_bf16(dp[2 * kk][2], dp[2 * kk][3]);
        da[2] = pack_bf16(dp[2 * kk + 1][0], dp[2 * kk + 1][1]);
        da[3] = pack_bf16(dp[2 * kk + 1][2], dp[2 * kk + 1][3]);
#pragma unroll
        for (int n2 = 0; n2 < ND / 2; ++n2) {
          uint32_t kf[4];
          ldsm_x4_trans(kf, ks + (c0 + kk * 16 + (lane & 7)
                                  + ((lane >> 3) & 1) * 8) * LDS
                                + n2 * 16 + (lane >> 4) * 8);
          mma_16816(acc[2 * n2], da, kf[0], kf[1]);
          mma_16816(acc[2 * n2 + 1], da, kf[2], kf[3]);
        }
      }
    }
    cp_async_wait<0>();  // tile kn has landed
    __syncthreads();     // for every warp; and stage st is free for a refill
    if (ck != nullptr && kn < kv_end) {
      rope_tile<D>(Ks + (st ^ 1) * BK * LDS, min(BK, Sk - kn * BK), Tab,
                   Tab + BK * LDT, LDT);
      __syncthreads();  // tile kn is rotated, and Tab is free
    }
    kt = kn;
    cls_cur = cls_next;
    st ^= 1;
  }

  // dq was accumulated against the rotated q: back through the rotation's
  // transpose, y c + y[d+D/2] s (d < D/2), y c - y[d-D/2] s, each product
  // rounded on its own as the plain version's separate fp32 ops round them.
  // Column d and d + D/2 are n-tiles j and j + ND/2 of the same lane and e.
  if (cq != nullptr) {
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int r = warp * 16 + g + 8 * i;
      if (r >= nq) continue;  // past Sq: no table row, never written
#pragma unroll
      for (int j = 0; j < ND / 2; ++j)
#pragma unroll
        for (int e = 2 * i; e < 2 * i + 2; ++e) {
          const size_t t = (size_t)(q0 + r) * H + j * 8 + tig * 2 + (e & 1);
          const float c = cq[t], s = sq[t];
          const float x = acc[j][e], y = acc[j + ND / 2][e];
          acc[j][e] = __fadd_rn(__fmul_rn(x, c), __fmul_rn(y, s));
          acc[j + ND / 2][e] = __fsub_rn(__fmul_rn(y, c), __fmul_rn(x, s));
        }
    }
  }
  // dQ rounded to bf16, staged through this warp's own 16 rows of Qs (no
  // other warp reads them, and no copy is in flight) for 16-byte row
  // stores; rows past Sq are not written
  bf16* stage = Qs + warp * 16 * LDS;
  __syncwarp();
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < ND; ++j)
      *reinterpret_cast<uint32_t*>(stage + (g + 8 * i) * LDS + j * 8 + tig * 2) =
          pack_bf16(acc[j][2 * i], acc[j][2 * i + 1]);
  __syncwarp();
  for (int idx = lane; idx < 16 * CH; idx += 32) {
    const int r = idx / CH, c8 = (idx % CH) * 8, row = warp * 16 + r;
    if (row < nq)
      *reinterpret_cast<uint4*>(dq + (row_base + q0 + row) * D + c8) =
          *reinterpret_cast<const uint4*>(stage + r * LDS + c8);
  }
}

// ---------------------------------------------------------------------------
// dk/dv on CUDA cores, for fp32 inputs (bf16 runs bwd_dkv_mma_kernel): one
// block per (kv tile, kv head, batch); the inner loop walks the GQA group's
// q heads x q tiles, so grouped heads accumulate in registers.
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

// ---------------------------------------------------------------------------
// dk/dv on the tensor cores (bf16), the design in the note at the top: per
// step (GQA head, q tile), with kv rows as the mma rows and the 64 q
// columns as the n-dimension,
//   S^T = K Q^T, P^T = exp(S^T - lse), dV += P^T dO,
//   dP^T = V dO^T, dS^T = P^T (dP^T - delta), dK += dS^T Q.
// Fragment layouts as for fwd_mma_kernel.
// ---------------------------------------------------------------------------

// Shared memory of bwd_dkv_mma_kernel: the resident K and V tiles, two ring
// stages of Q and two of dO (bf16 rows of D + 8), and the next q tile's
// RoPE table rows (cos then sin, fp32 rows of D/2 + 4): 73,728 bytes at
// D 64 and 139,264 at D 128, plus 1,792 static (positions, lse, delta).
template <int D> constexpr size_t dkv_mma_smem() {
  return 6 * BK * (D + 8) * 2 + 2 * BQ * (D / 2 + 4) * 4;
}

// Blocks per SM: 2 at D 64, set by registers (ptxas: 241, no spills; the
// live set is the dK and dV accumulators, S^T and dP^T, and the K and V A
// fragments, 32 registers each), and 1 at D 128, set by shared memory
// (252 registers, no spills). Staging the q tiles' table rows costs D 128
// its second block, and still wins with RoPE over reading them from L2
// between the step's two barriers.
template <int D>
__global__ void __launch_bounds__(MMA_NT, D == 64 ? 2 : 1) bwd_dkv_mma_kernel(
    const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
    const __nv_bfloat16* __restrict__ v, const __nv_bfloat16* __restrict__ dout,
    const float* __restrict__ lse, const float* __restrict__ delta,
    __nv_bfloat16* __restrict__ dk, __nv_bfloat16* __restrict__ dv,
    const int* __restrict__ qpos, const int* __restrict__ kpos,
    const float* cq, const float* sq, const float* ck, const float* sk,
    int Hq, int Hkv, int Sq, int Sk, int causal, int static_causal) {
  using bf16 = __nv_bfloat16;
  // LDS: tile row stride, padded by 16 bytes; CH: 16-byte chunks per row;
  // KD: k-steps of S^T and dP^T (over d); ND: 8-column n-tiles of dK, dV;
  // LDT: table row stride, padded by 16 bytes
  constexpr int LDS = D + 8, CH = D / 8, KD = D / 16, ND = D / 8;
  constexpr int H = D / 2, LDT = H + 4;
  // q columns per pass: at D 128 the accumulators take 128 registers, so
  // S^T and dP^T cover 32 q columns at a time; NC: n-tiles per pass
  constexpr int QC = D == 64 ? BQ : BQ / 2, NC = QC / 8;
  // at D 64 the K and V A fragments stay in registers; at D 128 they are
  // read from the resident tiles at each k-step (64 more registers would
  // spill)
  constexpr bool KV_REGS = D == 64;
  extern __shared__ float4 smem4[];
  bf16* Ks = reinterpret_cast<bf16*>(smem4);
  bf16* Vs = Ks + BK * LDS;
  bf16* Qs = Vs + BK * LDS;        // two stages
  bf16* dOs = Qs + 2 * BQ * LDS;   // two stages
  float* Tab = reinterpret_cast<float*>(dOs + 2 * BQ * LDS);  // BQ cos, BQ sin
  __shared__ int kp_s[BK];
  __shared__ int qp_ring[2 * BQ];
  __shared__ __align__(8) float lse_ring[2 * BQ];
  __shared__ __align__(8) float dl_ring[2 * BQ];

  // static-causal: kv tile 0 sees the most q tiles, so ascending blockIdx.x
  // already launches the heaviest blocks first
  const int kt = blockIdx.x, hk = blockIdx.y, b = blockIdx.z;
  const int n_rep = Hq / Hkv;
  const int k0 = kt * BK, nk = min(BK, Sk - k0);
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, tig = lane & 3;
  const size_t kv_base = (size_t)(b * Hkv + hk) * Sk;

  // the K and V tiles (and the kv positions): one cp.async group, rows
  // past Sk zero-filled
  for (int idx = tid; idx < BK * CH; idx += MMA_NT) {
    const int r = idx / CH, c8 = (idx % CH) * 8;
    const size_t off = (kv_base + (r < nk ? k0 + r : 0)) * D + c8;
    cp_async16(Ks + r * LDS + c8, k + off, r < nk);
    cp_async16(Vs + r * LDS + c8, v + off, r < nk);
  }
  if (causal && tid < BK)
    cp_async4(kp_s + tid, kpos + (tid < nk ? k0 + tid : 0), tid < nk);
  cp_async_commit();
  int kmin = 0, kmax = 0;
  if (causal && !static_causal) tile_minmax(kpos + k0, nk, kmin, kmax);

  // the inner loop walks (GQA head gh < n_rep) x (q tile >= qt_start) as
  // one sequence it = gh * nqt + (qt - qt_start); static-causal: q tiles
  // before the first one that can see this kv tile are never visited
  // (_q_eff)
  const int num_q = (Sq + BQ - 1) / BQ;
  const int qt_start = static_causal ? k0 / BQ : 0;
  const int nqt = max(0, num_q - qt_start);
  const int it_end = n_rep * nqt;
  auto q_start = [&](int it) { return (qt_start + it % nqt) * BQ; };
  auto tile_class = [&](int it) {
    const int q0 = q_start(it), nq = min(BQ, Sq - q0);
    int qmin = 0, qmax = 0;
    if (causal && !static_causal) tile_minmax(qpos + q0, nq, qmin, qmax);
    return classify(causal, static_causal, q0, nq, k0, nk, qmin, qmax, kmin,
                    kmax);
  };
  // the first visible (head, q tile) at or after it (it_end if none) and
  // its class: invisible tiles are neither copied nor multiplied
  auto next_visible = [&](int it, TileClass& cls) {
    for (; it < it_end; ++it) {
      cls = tile_class(it);
      if (cls.visible) return it;
    }
    return it_end;
  };
  // start the copies of step it into ring stage st: Q and dO (16-byte
  // copies), the q positions, lse and delta rows (4-byte copies), rows past
  // Sq zero-filled; and the q tile's RoPE table rows into Tab
  auto issue_q = [&](int it, int st) {
    const int q0 = q_start(it), nq = min(BQ, Sq - q0);
    const size_t row_base = (size_t)(b * Hq + hk * n_rep + it / nqt) * Sq;
    bf16* qs = Qs + st * BQ * LDS;
    bf16* dos = dOs + st * BQ * LDS;
    for (int idx = tid; idx < BQ * CH; idx += MMA_NT) {
      const int r = idx / CH, c8 = (idx % CH) * 8;
      const size_t off = (row_base + (r < nq ? q0 + r : 0)) * D + c8;
      cp_async16(qs + r * LDS + c8, q + off, r < nq);
      cp_async16(dos + r * LDS + c8, dout + off, r < nq);
    }
    if (tid < BQ) {
      const int row = tid < nq ? q0 + tid : 0;
      if (causal) cp_async4(qp_ring + st * BQ + tid, qpos + row, tid < nq);
      cp_async4(lse_ring + st * BQ + tid, lse + row_base + row, tid < nq);
      cp_async4(dl_ring + st * BQ + tid, delta + row_base + row, tid < nq);
    }
    if (cq != nullptr) {
      constexpr int TC = H / 4;  // 16-byte chunks per table row
      for (int idx = tid; idx < 2 * BQ * TC; idx += MMA_NT) {
        const int r = (idx / TC) % BQ, c4 = (idx % TC) * 4;
        const float* src = idx < BQ * TC ? cq : sq;
        cp_async16(Tab + (idx / TC) * LDT + c4,
                   src + (size_t)(r < nq ? q0 + r : 0) * H + c4, r < nq);
      }
    }
  };
  // rotate the landed Q tile of step it in ring stage st in place: rotated
  // Q is both S^T's and dK's B operand, so one rotation serves both
  auto rope_q = [&](int it, int st) {
    rope_tile<D>(Qs + st * BQ * LDS, min(BQ, Sq - q_start(it)), Tab,
                 Tab + BQ * LDT, LDT);
  };

  TileClass cls_cur, cls_next;
  int it = next_visible(0, cls_cur);
  if (it < it_end) issue_q(it, 0);
  cp_async_commit();
  cp_async_wait<0>();  // K, V and the first q tile have landed
  __syncthreads();
  if (ck != nullptr) {
    // k is constant across the inner loop: rotate it once per block (TPU
    // :430-433), and the first Q tile beside it
    rope_tile<D>(Ks, nk, ck + (size_t)k0 * H, sk + (size_t)k0 * H, H);
    if (it < it_end) rope_q(it, 0);
    __syncthreads();
  }
  // this warp's 16 kv rows as A fragments: lanes 8i..8i+7 address matrix i
  // (rows 0-7 / 8-15, k columns 0-7 / 8-15)
  const int a_off = (warp * 16 + (lane & 7) + ((lane >> 3) & 1) * 8) * LDS +
                    (lane >> 4) * 8;
  uint32_t kf[KV_REGS ? KD : 1][4], vf[KV_REGS ? KD : 1][4];
  if constexpr (KV_REGS) {
#pragma unroll
    for (int kk = 0; kk < KD; ++kk) {
      ldsm_x4(kf[kk], Ks + a_off + kk * 16);
      ldsm_x4(vf[kk], Vs + a_off + kk * 16);
    }
  }

  float dk_acc[ND][4], dv_acc[ND][4];
#pragma unroll
  for (int j = 0; j < ND; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      dk_acc[j][e] = 0.f;
      dv_acc[j][e] = 0.f;
    }

  int st = 0;
  while (it < it_end) {
    // step it is in stage st, rotated; stage st ^ 1 and Tab are free
    // (every warp passed the barriers that closed the last step): start
    // step in
    const int in = next_visible(it + 1, cls_next);
    if (in < it_end) issue_q(in, st ^ 1);
    cp_async_commit();
    const int nq = min(BQ, Sq - q_start(it));
    const bf16* qs = Qs + st * BQ * LDS;
    const bf16* dos = dOs + st * BQ * LDS;
    const int* qp_s = qp_ring + st * BQ;
    const float* lse_s = lse_ring + st * BQ;
    const float* dl_s = dl_ring + st * BQ;

#pragma unroll
    for (int c0 = 0; c0 < BQ; c0 += QC) {
      // S^T = K Q^T and dP^T = V dO^T for q columns c0..c0+QC: this warp's
      // 16 kv rows x QC columns in NC n-tiles of 4 registers each
      float p[NC][4], dp[NC][4];
#pragma unroll
      for (int j = 0; j < NC; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          p[j][e] = 0.f;
          dp[j][e] = 0.f;
        }
#pragma unroll
      for (int kk = 0; kk < KD; ++kk) {
        uint32_t ka[4], va[4];
        if constexpr (KV_REGS) {
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            ka[i] = kf[kk][i];
            va[i] = vf[kk][i];
          }
        } else {
          ldsm_x4(ka, Ks + a_off + kk * 16);
          ldsm_x4(va, Vs + a_off + kk * 16);
        }
#pragma unroll
        for (int j2 = 0; j2 < NC / 2; ++j2) {
          // Q and dO rows c0 + j2*16.. as the B fragments of n-tiles 2 j2
          // and 2 j2 + 1
          const int off = (c0 + j2 * 16 + (lane & 7) + (lane >> 4) * 8) * LDS
                          + kk * 16 + ((lane >> 3) & 1) * 8;
          uint32_t qb[4], ob[4];
          ldsm_x4(qb, qs + off);
          mma_16816(p[2 * j2], ka, qb[0], qb[1]);
          mma_16816(p[2 * j2 + 1], ka, qb[2], qb[3]);
          ldsm_x4(ob, dos + off);
          mma_16816(dp[2 * j2], va, ob[0], ob[1]);
          mma_16816(dp[2 * j2 + 1], va, ob[2], ob[3]);
        }
      }
      // P^T = exp(S^T - lse[c]) in fp32, then dS^T = P^T (dP^T - delta[c])
      // from the fp32 P: this lane holds kv rows g (e = 0, 1) and g + 8
      // (e = 2, 3) at q columns cb, cb + 1 of each n-tile
#pragma unroll
      for (int j = 0; j < NC; ++j) {
        const int cb = c0 + j * 8 + tig * 2;
        const float2 l2 = *reinterpret_cast<const float2*>(lse_s + cb);
        const float2 d2 = *reinterpret_cast<const float2*>(dl_s + cb);
        // exp(x) as exp2(x log2 e); a column with no visible key (lse =
        // -inf) must give P = 0, so its shift is +inf
        const float lb[2] = {l2.x <= NEG ? INFINITY : l2.x * LOG2E,
                             l2.y <= NEG ? INFINITY : l2.y * LOG2E};
        const float dl[2] = {d2.x, d2.y};
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int r = warp * 16 + g + (e >> 1) * 8, c = cb + (e & 1);
          float sv = p[j][e];
          if (!cls_cur.full) {
            const bool ok = c < nq && (!causal || qp_s[c] >= kp_s[r]);
            if (!ok) sv = NEG;
          }
          const float pv = fast_exp2(fmaf(sv, LOG2E, -lb[e & 1]));
          p[j][e] = pv;
          dp[j][e] = pv * (dp[j][e] - dl[e & 1]);
        }
      }
      // dV += P^T dO and dK += dS^T Q: the A fragment for q rows 16 kk..
      // of the pass is n-tiles 2 kk and 2 kk + 1 of P^T (of dS^T), rounded
      // to bf16; dO's and Q's B fragments by ldmatrix.trans
#pragma unroll
      for (int kk = 0; kk < NC / 2; ++kk) {
        uint32_t pa[4], sa[4];
        pa[0] = pack_bf16(p[2 * kk][0], p[2 * kk][1]);
        pa[1] = pack_bf16(p[2 * kk][2], p[2 * kk][3]);
        pa[2] = pack_bf16(p[2 * kk + 1][0], p[2 * kk + 1][1]);
        pa[3] = pack_bf16(p[2 * kk + 1][2], p[2 * kk + 1][3]);
        sa[0] = pack_bf16(dp[2 * kk][0], dp[2 * kk][1]);
        sa[1] = pack_bf16(dp[2 * kk][2], dp[2 * kk][3]);
        sa[2] = pack_bf16(dp[2 * kk + 1][0], dp[2 * kk + 1][1]);
        sa[3] = pack_bf16(dp[2 * kk + 1][2], dp[2 * kk + 1][3]);
#pragma unroll
        for (int n2 = 0; n2 < ND / 2; ++n2) {
          const int off = (c0 + kk * 16 + (lane & 7) + ((lane >> 3) & 1) * 8)
                          * LDS + n2 * 16 + (lane >> 4) * 8;
          uint32_t ob[4], qb[4];
          ldsm_x4_trans(ob, dos + off);
          mma_16816(dv_acc[2 * n2], pa, ob[0], ob[1]);
          mma_16816(dv_acc[2 * n2 + 1], pa, ob[2], ob[3]);
          ldsm_x4_trans(qb, qs + off);
          mma_16816(dk_acc[2 * n2], sa, qb[0], qb[1]);
          mma_16816(dk_acc[2 * n2 + 1], sa, qb[2], qb[3]);
        }
      }
    }
    cp_async_wait<0>();  // step in has landed
    __syncthreads();     // for every warp; and stage st is free for a refill
    if (cq != nullptr && in < it_end) {
      rope_q(in, st ^ 1);
      __syncthreads();  // step in is rotated, and Tab is free
    }
    it = in;
    cls_cur = cls_next;
    st ^= 1;
  }

  // dk was accumulated against the rotated k: back through the rotation's
  // transpose, y c + y[d+D/2] s (d < D/2), y c - y[d-D/2] s, each product
  // rounded on its own as the plain version's separate fp32 ops round them.
  // Column d and d + D/2 are n-tiles j and j + ND/2 of the same lane and e.
  if (ck != nullptr) {
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int r = warp * 16 + g + 8 * i;
      if (r >= nk) continue;  // past Sk: no table row, never written
#pragma unroll
      for (int j = 0; j < ND / 2; ++j)
#pragma unroll
        for (int e = 2 * i; e < 2 * i + 2; ++e) {
          const size_t t = (size_t)(k0 + r) * H + j * 8 + tig * 2 + (e & 1);
          const float c = ck[t], s = sk[t];
          const float x = dk_acc[j][e], y = dk_acc[j + ND / 2][e];
          dk_acc[j][e] = __fadd_rn(__fmul_rn(x, c), __fmul_rn(y, s));
          dk_acc[j + ND / 2][e] = __fsub_rn(__fmul_rn(y, c), __fmul_rn(x, s));
        }
    }
  }
  // dK and dV rounded to bf16, staged through this warp's own 16 rows of Ks
  // and Vs (no other warp reads them, and no copy is in flight) for
  // 16-byte row stores; rows past Sk are not written
  bf16* kst = Ks + warp * 16 * LDS;
  bf16* vst = Vs + warp * 16 * LDS;
  __syncwarp();
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < ND; ++j) {
      const int o = (g + 8 * i) * LDS + j * 8 + tig * 2;
      *reinterpret_cast<uint32_t*>(kst + o) =
          pack_bf16(dk_acc[j][2 * i], dk_acc[j][2 * i + 1]);
      *reinterpret_cast<uint32_t*>(vst + o) =
          pack_bf16(dv_acc[j][2 * i], dv_acc[j][2 * i + 1]);
    }
  __syncwarp();
  for (int idx = lane; idx < 16 * CH; idx += 32) {
    const int r = idx / CH, c8 = (idx % CH) * 8, row = warp * 16 + r;
    if (row < nk) {
      const size_t o = (kv_base + k0 + row) * D + c8;
      *reinterpret_cast<uint4*>(dk + o) =
          *reinterpret_cast<const uint4*>(kst + r * LDS + c8);
      *reinterpret_cast<uint4*>(dv + o) =
          *reinterpret_cast<const uint4*>(vst + r * LDS + c8);
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

template <int D>
cudaError_t launch_fwd_mma(const void* q, const void* k, const void* v,
                           void* out, void* lse, const void* qpos,
                           const void* kpos, const void* cq, const void* sq,
                           const void* ck, const void* sk, int B, int Hq,
                           int Hkv, int Sq, int Sk, int causal,
                           int static_causal, cudaStream_t stream) {
  using bf16 = __nv_bfloat16;
  // cp.async and the vector loads move 16 bytes at a time
  const uintptr_t addr = (uintptr_t)q | (uintptr_t)k | (uintptr_t)v |
                         (uintptr_t)out | (uintptr_t)cq | (uintptr_t)sq |
                         (uintptr_t)ck | (uintptr_t)sk;
  if (addr & 15) return cudaErrorMisalignedAddress;
  constexpr size_t smem = fwd_mma_smem<D>();
  cudaError_t err = cudaFuncSetAttribute(
      fwd_mma_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  dim3 grid((Sq + BQ - 1) / BQ, Hq, B);
  fwd_mma_kernel<D><<<grid, MMA_NT, smem, stream>>>(
      (const bf16*)q, (const bf16*)k, (const bf16*)v, (bf16*)out,
      (float*)lse, (const int*)qpos, (const int*)kpos, (const float*)cq,
      (const float*)sq, (const float*)ck, (const float*)sk, Hq, Hkv, Sq, Sk,
      causal, static_causal);
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

template <int D>
cudaError_t launch_dq_mma(const void* q, const void* k, const void* v,
                          const void* dout, const void* lse,
                          const void* delta, void* dq, const void* qpos,
                          const void* kpos, const void* cq, const void* sq,
                          const void* ck, const void* sk, int B, int Hq,
                          int Hkv, int Sq, int Sk, int causal,
                          int static_causal, cudaStream_t stream) {
  using bf16 = __nv_bfloat16;
  // cp.async and the vector loads and stores move 16 bytes at a time
  const uintptr_t addr = (uintptr_t)q | (uintptr_t)k | (uintptr_t)v |
                         (uintptr_t)dout | (uintptr_t)dq | (uintptr_t)cq |
                         (uintptr_t)sq | (uintptr_t)ck | (uintptr_t)sk;
  if (addr & 15) return cudaErrorMisalignedAddress;
  constexpr size_t smem = dq_mma_smem<D>();
  cudaError_t err = cudaFuncSetAttribute(
      bwd_dq_mma_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return err;
  dim3 grid((Sq + BQ - 1) / BQ, Hq, B);
  bwd_dq_mma_kernel<D><<<grid, MMA_NT, smem, stream>>>(
      (const bf16*)q, (const bf16*)k, (const bf16*)v, (const bf16*)dout,
      (const float*)lse, (const float*)delta, (bf16*)dq, (const int*)qpos,
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

template <int D>
cudaError_t launch_dkv_mma(const void* q, const void* k, const void* v,
                           const void* dout, const void* lse,
                           const void* delta, void* dk, void* dv,
                           const void* qpos, const void* kpos, const void* cq,
                           const void* sq, const void* ck, const void* sk,
                           int B, int Hq, int Hkv, int Sq, int Sk, int causal,
                           int static_causal, cudaStream_t stream) {
  using bf16 = __nv_bfloat16;
  // cp.async and the vector loads and stores move 16 bytes at a time
  const uintptr_t addr = (uintptr_t)q | (uintptr_t)k | (uintptr_t)v |
                         (uintptr_t)dout | (uintptr_t)dk | (uintptr_t)dv |
                         (uintptr_t)cq | (uintptr_t)sq | (uintptr_t)ck |
                         (uintptr_t)sk;
  if (addr & 15) return cudaErrorMisalignedAddress;
  constexpr size_t smem = dkv_mma_smem<D>();
  cudaError_t err = cudaFuncSetAttribute(
      bwd_dkv_mma_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return err;
  dim3 grid((Sk + BK - 1) / BK, Hkv, B);
  bwd_dkv_mma_kernel<D><<<grid, MMA_NT, smem, stream>>>(
      (const bf16*)q, (const bf16*)k, (const bf16*)v, (const bf16*)dout,
      (const float*)lse, (const float*)delta, (bf16*)dk, (bf16*)dv,
      (const int*)qpos, (const int*)kpos, (const float*)cq, (const float*)sq,
      (const float*)ck, (const float*)sk, Hq, Hkv, Sq, Sk, causal,
      static_causal);
  return cudaGetLastError();
}

}  // namespace

// Each entry dispatches on (input type, head dim); anything else is refused.
extern "C" {

// bf16 inputs run the tensor-core forward, fp32 inputs the CUDA-core one
int pt_flash_fwd(const void* q, const void* k, const void* v, void* out,
                 void* lse, const void* qpos, const void* kpos, const void* cq,
                 const void* sq, const void* ck, const void* sk, int B, int Hq,
                 int Hkv, int Sq, int Sk, int D, int causal, int static_causal,
                 int is_bf16, void* stream) {
#define PT_FWD_ARGS                                                        \
  q, k, v, out, lse, qpos, kpos, cq, sq, ck, sk, B, Hq, Hkv, Sq, Sk, causal, \
      static_causal, (cudaStream_t)stream
  if (is_bf16 && D == 64) return (int)launch_fwd_mma<64>(PT_FWD_ARGS);
  if (is_bf16 && D == 128) return (int)launch_fwd_mma<128>(PT_FWD_ARGS);
  if (!is_bf16 && D == 64) return (int)launch_fwd<float, 64>(PT_FWD_ARGS);
  if (!is_bf16 && D == 128) return (int)launch_fwd<float, 128>(PT_FWD_ARGS);
#undef PT_FWD_ARGS
  return (int)cudaErrorInvalidValue;
}

int pt_flash_bwd_dq(const void* q, const void* k, const void* v,
                    const void* dout, const void* lse, const void* delta,
                    void* dq, const void* qpos, const void* kpos,
                    const void* cq, const void* sq, const void* ck,
                    const void* sk, int B, int Hq, int Hkv, int Sq, int Sk,
                    int D, int causal, int static_causal, int is_bf16,
                    void* stream) {
  // bf16 inputs run the tensor-core dq, fp32 inputs the CUDA-core one
#define PT_DQ_ARGS                                                          \
  q, k, v, dout, lse, delta, dq, qpos, kpos, cq, sq, ck, sk, B, Hq, Hkv, Sq, \
      Sk, causal, static_causal, (cudaStream_t)stream
  if (is_bf16 && D == 64) return (int)launch_dq_mma<64>(PT_DQ_ARGS);
  if (is_bf16 && D == 128) return (int)launch_dq_mma<128>(PT_DQ_ARGS);
  if (!is_bf16 && D == 64) return (int)launch_dq<float, 64>(PT_DQ_ARGS);
  if (!is_bf16 && D == 128) return (int)launch_dq<float, 128>(PT_DQ_ARGS);
#undef PT_DQ_ARGS
  return (int)cudaErrorInvalidValue;
}

int pt_flash_bwd_dkv(const void* q, const void* k, const void* v,
                     const void* dout, const void* lse, const void* delta,
                     void* dk, void* dv, const void* qpos, const void* kpos,
                     const void* cq, const void* sq, const void* ck,
                     const void* sk, int B, int Hq, int Hkv, int Sq, int Sk,
                     int D, int causal, int static_causal, int is_bf16,
                     void* stream) {
  // bf16 inputs run the tensor-core dk/dv, fp32 inputs the CUDA-core one
#define PT_DKV_ARGS                                                         \
  q, k, v, dout, lse, delta, dk, dv, qpos, kpos, cq, sq, ck, sk, B, Hq, Hkv, \
      Sq, Sk, causal, static_causal, (cudaStream_t)stream
  if (is_bf16 && D == 64) return (int)launch_dkv_mma<64>(PT_DKV_ARGS);
  if (is_bf16 && D == 128) return (int)launch_dkv_mma<128>(PT_DKV_ARGS);
  if (!is_bf16 && D == 64) return (int)launch_dkv<float, 64>(PT_DKV_ARGS);
  if (!is_bf16 && D == 128) return (int)launch_dkv<float, 128>(PT_DKV_ARGS);
#undef PT_DKV_ARGS
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
