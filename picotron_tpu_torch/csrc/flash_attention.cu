// Flash attention for Hopper (sm_90a): forward, dq and dk/dv kernels.
//
// Replaces the three Pallas TPU kernels of picotron_tpu/ops/flash_attention.py:
//   fwd_wgmma_kernel   <- _fwd_kernel     (:139, pallas_call in _fwd :281),
//                         bf16 at D 64, after rope_rows_kernel
//   fwd_mma_kernel     <- _fwd_kernel     (the same), bf16 at D 128
//   fwd_kernel         <- _fwd_kernel     (the same), fp32 inputs only
//   bwd_dq_wgmma_kernel <- _bwd_dq_kernel (:327, pallas_call in _bwd :543),
//                          bf16 at D 64, after rope_rows_kernel
//   bwd_dq_mma_kernel  <- _bwd_dq_kernel  (the same), bf16 at D 128
//   bwd_dq_kernel      <- _bwd_dq_kernel  (the same), fp32 inputs only
//   bwd_dkv_wgmma_kernel <- _bwd_dkv_kernel (:412, pallas_call in _bwd :593),
//                           bf16 at D 64, after rope_rows_kernel
//   bwd_dkv_mma_kernel <- _bwd_dkv_kernel (the same), bf16 at D 128
//   bwd_dkv_kernel     <- _bwd_dkv_kernel (the same), fp32 inputs only
//   rope_rows_kernel   <- no TPU kernel: the rotations of q and k in
//                         _fwd_kernel (q :160 once, k :193 at each kv
//                         visit), _bwd_dq_kernel (q :343, k :367 at each
//                         kv visit) and _bwd_dkv_kernel (k :433, q :456
//                         at each q visit), done once per forward call
//                         for the D-64 forward and once per backward call
//                         for both D-64 backward kernels
//
// What bounds it on the card: causal attention at the training shapes
// (S = 2048, D = 64) does ~S/2 multiply-adds per loaded element, far above
// the H100's ~295 FLOP/byte ridge, so the work is bound by operations, not
// by device-memory bytes.
//
// The bf16 forward at D 64 (the main path's head dim) therefore runs
// fwd_wgmma_kernel, built from the Hopper dq's parts: one warpgroup per
// (64-row q tile, q head, batch), heaviest causal tiles first, q rows as
// wgmma's M. S = Q K^T takes both operands from shared memory (wgmma
// m64n64k16, fp32 accumulators in registers); the online softmax runs on
// S's accumulator (a row's 64 scores lie across one quad: two shuffles
// for its max, two for its sum), and P is rounded to bf16 straight from
// it into A fragments in registers for O += P V, with V read MN-major, so
// P never touches shared memory. Q arrives once per block by TMA; K, V
// and the tile's kv positions stream by TMA through a two-stage ring over
// the visible kv tiles, in the 128-byte swizzle, each stage with a full
// and an empty mbarrier (no block-wide barrier in the loop). Each tile is
// one chain: S's product, the mask and the softmax on the CUDA cores (O
// rescaled by alpha in registers), P V's product, and each warp's release
// of the stage once P V has read it; lane 0 of warp 0 refills the stage
// the previous tile released while the tile's S product runs. (P V left in
// flight under the next tile's S product measured slower: ptxas then
// waited after every wgmma.) Q and K come rotated by rope_rows_kernel, a
// memory-bound pre-pass once per forward call (the mma.sync forward
// rotated each K tile at each of its visits, 16.5x per call at the
// training shape, about a third of its time). Five blocks fit an SM (96
// registers, 42,536 bytes of shared memory); what bounds it at the
// training shape is that serial chain, which the five blocks hide only in
// part (PERF.md).
//
// At D 128 the forward stays on fwd_mma_kernel (a 256-byte row would span
// two 128-byte swizzle atoms): mma.sync m16n8k16 bf16 with fp32
// accumulation, one block of 4 warps per (64-row q tile, q head, batch),
// each warp owning 16 q rows, heaviest causal tiles launched first. Q is
// loaded once, rotated, and kept as ldmatrix A fragments in registers for
// the whole kv loop; K/V tiles stream through a two-stage shared-memory
// ring filled by 16-byte cp.async copies (rows padded by 16 bytes, so
// ldmatrix is free of bank conflicts), the copy of the next visible tile
// (with its RoPE table rows, in the region Q no longer needs) issued
// before the current tile's products and rotated in place once it lands;
// P is packed from the S accumulator fragments into the A fragments of
// O += P V (the m16n8 C layout of two neighbouring n-tiles is the m16k16
// A layout). One barrier per tile, two with RoPE. pt_flash_fwd dispatches
// on D alone.
//
// The bf16 dk/dv is bound by operations too (8 D FLOPs per visible
// (q, k) pair against the same bytes), and per pair it also pays one
// exponential and two bf16 roundings (P and dS) on the CUDA cores. At
// D 64 (the main path's head dim) it runs bwd_dkv_wgmma_kernel, built
// from Hopper's own parts: one warpgroup per (64-row kv tile, kv head,
// batch), heaviest causal tiles first, its four products on wgmma
// m64n64k16 with fp32 accumulators in registers, taken transposed so that
// the kv rows are wgmma's M: S^T = K Q^T and dP^T = V dO^T with both
// operands in shared memory, dV += P^T dO and dK += dS^T Q with P^T and
// dS^T rounded to bf16 straight from the accumulators into A fragments in
// registers (neither touches shared memory) and dO and Q read MN-major.
// K and V arrive once per block by TMA; Q, dO and the step's lse, delta
// and q positions stream by TMA through a three-stage ring over (GQA head
// x q tile), in the 128-byte swizzle that wgmma reads, each stage with a
// full mbarrier (TMA's transaction count) and an empty one (one arrive
// per warp): no block-wide barrier in the loop. Lane 0 of warp 0 issues
// the copies, refilling the stage the previous step released while the
// step's first products run; a separate producer warp would cost the SM
// its third block (registers, PERF.md). Invisible steps are never copied;
// GQA heads accumulate in registers with no atomics. Q and K come rotated
// by rope_rows_kernel, a memory-bound pre-pass over q and k once per
// backward call, shared with dq (the mma.sync kernel rotated each Q tile
// at each of its S/64 visits per head), so only dk's inverse rotation, in
// fp32 in the epilogue, stays in the kernel. Three blocks fit an SM (168
// registers, no spills, 70,456 bytes of shared memory); what still bounds
// it (the per-step chain of products and the CUDA-core work between
// them) is in PERF.md.
//
// At D 128 the wgmma kernel's four accumulators would take 192 registers
// a thread, so bf16 D 128 stays on bwd_dkv_mma_kernel: the forward's
// mma.sync building blocks with the roles turned round, one block of 4
// warps per (64-row kv tile, kv head, batch), each warp owning 16 kv rows
// of dK and dV, K and V resident (K rotated once per block), Q, dO and
// the step's rows through a two-stage cp.async ring with the landed Q tile
// rotated in place (S^T and dK share it), P^T and dS^T packed from the
// accumulator fragments into A fragments; one barrier per step, two with
// RoPE. pt_flash_bwd_dkv dispatches on D alone.
//
// The bf16 dq is bound by operations as well (6 D FLOPs per visible
// pair), and pays one exponential and one bf16 rounding per pair on the
// CUDA cores. At D 64 it runs bwd_dq_wgmma_kernel, built from the dk/dv's
// Hopper parts with the roles turned back: one warpgroup per (64-row q
// tile, q head, batch), heaviest causal tiles first, q rows as wgmma's M.
// S = Q K^T and dP = dO V^T take both operands from shared memory; dQ +=
// dS K takes dS rounded to bf16 straight from dP's accumulator into A
// fragments in registers (it never touches shared memory) and K read
// MN-major. Q and dO arrive once per block by TMA; K, V and the tile's kv
// positions stream by TMA through a two-stage ring over the visible kv
// tiles, in the 128-byte swizzle, each stage with a full and an empty
// mbarrier (no block-wide barrier in the loop), lane 0 of warp 0 refilling
// the stage the previous tile released while the tile's first products
// run. Each lane reads its two rows' lse, delta and q position once with
// plain loads. It reads the q and k that rope_rows_kernel rotated for the
// dk/dv of the same backward call (the mma.sync dq rotated each K tile at
// each of its visits, 16.5x per call at the training shape), so only dq's
// inverse rotation, in fp32 in the epilogue, stays in the kernel. Four
// blocks fit an SM (128 registers, 50,728 bytes of shared memory); as
// for the dk/dv, what bounds it is each tile's serial chain (products,
// wait, CUDA-core work, product, wait), which more blocks an SM hide
// better (PERF.md).
//
// At D 128 dq stays on bwd_dq_mma_kernel (a 256-byte row would span two
// 128-byte swizzle atoms, and the dQ accumulator alone would take 64
// registers a thread): the forward's mma.sync data flow, one block of 4
// warps per (64-row q tile, q head, batch), each warp owning 16 q rows of
// dQ, Q (rotated once) and dO resident as A fragments in registers, K/V
// tiles through the forward's two-stage cp.async ring with K rotated in
// place once it lands, dP = dO V^T taking V's rows as K's are taken for S,
// dS packed from the accumulator fragments into A fragments; one barrier
// per tile, two with RoPE. pt_flash_bwd_dq dispatches on D alone.
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
// At D 128 the bf16 forward also needs q, k, v, out and the tables 16-byte
// aligned, the bf16 dq q, k, v, dout, dq and the tables, and the bf16
// dk/dv q, k, v, dout, dk, dv and the tables; at D 64, whose q and k come
// rotated (no forward tables, the dq's k tables and the dk/dv's q tables
// null), the forward q, k, v and the kv positions, the dq q, k, v, dout
// and the kv positions, and the dk/dv q, k, v, dout, dk, dv, lse, delta
// and the q positions. The Hopper kernels get their tensor maps from
// cuTensorMapEncodeTiled, found through cudaGetDriverEntryPoint, so the
// library still links only the runtime.

#include <cuda.h>  // CUtensorMap and its enums (types only: no -lcuda)
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
// Forward on CUDA cores, for fp32 inputs (bf16 runs fwd_wgmma_kernel at
// D 64 and fwd_mma_kernel at D 128): one block per (q tile, q head,
// batch); loop over kv tiles with the online softmax (m, l, acc) in
// registers.
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

// minimum blocks per SM: 2 at D 128 (its one instantiation), the most
// that fit without register spills (ptxas: 200 registers)
template <int D>
__global__ void __launch_bounds__(MMA_NT, 2) fwd_mma_kernel(
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
// dq on CUDA cores, for fp32 inputs (bf16 runs bwd_dq_wgmma_kernel or
// bwd_dq_mma_kernel): one block per (q tile, q head, batch); loop over kv
// tiles, P recomputed from the saved LSE, ds = p * (dp - delta).
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
// of D + 8): 104,448 bytes at D 128, plus 768 static (positions), so
// shared memory allows 2 blocks per SM.
template <int D> __host__ __device__ constexpr int dq_mma_head_bytes() {
  return 2 * BQ * (D + 8) * 2 > 2 * BK * (D / 2 + 4) * 4
             ? 2 * BQ * (D + 8) * 2
             : 2 * BK * (D / 2 + 4) * 4;
}
template <int D> constexpr size_t dq_mma_smem() {
  return dq_mma_head_bytes<D>() + 4 * BK * (D + 8) * 2;
}

// pt_flash_bwd_dq instantiates it at D 128 alone (bf16 D 64 runs
// bwd_dq_wgmma_kernel). Two blocks per SM, set by shared memory. The live
// set is the dQ accumulators (D/2 registers), Q's and dO's resident A
// fragments (D/4 each), and S and dP for KC kv columns at a time (KC/2
// each). The instructions are the same for any KC, so KC is chosen for
// registers, by measurement (kernels/variants.py on an H100 at the
// training shapes, PERF.md): KC 32 takes 246 registers and KC 64 255,
// neither spilling, and KC 32 is no slower. Reading dO's fragments from
// shared memory at each k-step instead would keep its tile beside the
// table rows: one block per SM.
template <int D>
__global__ void __launch_bounds__(MMA_NT, 2) bwd_dq_mma_kernel(
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
  constexpr int KC = 32, NC = KC / 8;
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
// dk/dv on CUDA cores, for fp32 inputs (bf16 runs bwd_dkv_wgmma_kernel or
// bwd_dkv_mma_kernel): one block per (kv tile, kv head, batch); the inner loop walks the GQA group's
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
// dk/dv on the tensor cores by mma.sync (bf16, D 128), the design in the
// note at the top: per step (GQA head, q tile), with kv rows as the mma rows and the 64 q
// columns as the n-dimension,
//   S^T = K Q^T, P^T = exp(S^T - lse), dV += P^T dO,
//   dP^T = V dO^T, dS^T = P^T (dP^T - delta), dK += dS^T Q.
// Fragment layouts as for fwd_mma_kernel.
// ---------------------------------------------------------------------------

// Shared memory of bwd_dkv_mma_kernel (D 128; D 64 runs
// bwd_dkv_wgmma_kernel): the resident K and V tiles, two ring stages of Q
// and two of dO (bf16 rows of D + 8), and the next q tile's RoPE table
// rows (cos then sin, fp32 rows of D/2 + 4): 139,264 bytes, plus 1,792
// static (positions, lse, delta).
template <int D> constexpr size_t dkv_mma_smem() {
  return 6 * BK * (D + 8) * 2 + 2 * BQ * (D / 2 + 4) * 4;
}

// One block per SM, set by shared memory (252 registers, no spills).
// Staging the q tiles' table rows costs it a second block, and still wins
// with RoPE over reading them from L2 between the step's two barriers.
template <int D>
__global__ void __launch_bounds__(MMA_NT, 1) bwd_dkv_mma_kernel(
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
  // q columns per pass: the accumulators take 128 registers, so S^T and
  // dP^T cover 32 q columns at a time; NC: n-tiles per pass. The K and V
  // A fragments are read from the resident tiles at each k-step (64 more
  // registers would spill).
  constexpr int QC = BQ / 2, NC = QC / 8;
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
        ldsm_x4(ka, Ks + a_off + kk * 16);
        ldsm_x4(va, Vs + a_off + kk * 16);
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

// ---------------------------------------------------------------------------
// dk/dv on Hopper (bf16, D 64), the design in the note at the top: one
// warpgroup per (64-row kv tile, kv head, batch); per visible step (GQA
// head, q tile), with the kv rows as wgmma's M and the 64 q columns as N,
//   S^T = K Q^T, P^T = exp(S^T - lse), dV += P^T dO,
//   dP^T = V dO^T, dS^T = P^T (dP^T - delta), dK += dS^T Q,
// Q and K rotated beforehand by rope_rows_kernel. wgmma's accumulator
// holds, per warp w of the warpgroup and lane (g = lane / 4, t = lane % 4),
// rows 16 w + g and 16 w + g + 8 at columns 8 j + 2 t, 8 j + 2 t + 1 of
// each 8-column chunk j, in d[4 j .. 4 j + 3] (PTX ISA, wgmma D fragments).
// ---------------------------------------------------------------------------

constexpr int WG_NT = 128;             // one warpgroup
constexpr int WG_D = 64;               // the head dim this kernel serves
constexpr int WG_NS = 3;               // ring stages
constexpr int WG_TILE = BQ * WG_D * 2;  // a 64 x 64 bf16 tile: 8 KB
// a stage's lse or delta row: TMA reads from 16-byte aligned addresses,
// so a box of WG_BOX entries starts at the aligned entry at or before the
// tile's first q row (up to 3 early: o = (bh Sq + q0) % 4)
constexpr int WG_BOX = BQ + 4;
constexpr int WG_ROW = 384;            // WG_BOX fp32, padded to 128 bytes
// shared memory, in bytes from a 1024-aligned base (the 128-byte swizzle
// repeats every 1024 bytes, and wgmma's descriptors assume tiles start on
// it): K and V, then NS stages of Q, NS of dO, NS rows each of lse, delta
// and q positions, the kv positions, and the barriers (full[NS],
// empty[NS], kv)
constexpr int WG_K = 0;
constexpr int WG_V = WG_TILE;
constexpr int WG_Q = 2 * WG_TILE;
constexpr int WG_DO = WG_Q + WG_NS * WG_TILE;
constexpr int WG_LSE = WG_DO + WG_NS * WG_TILE;
constexpr int WG_DL = WG_LSE + WG_NS * WG_ROW;
constexpr int WG_QP = WG_DL + WG_NS * WG_ROW;
constexpr int WG_KP = WG_QP + WG_NS * WG_ROW;
constexpr int WG_BAR = WG_KP + WG_ROW;
constexpr int WG_SMEM = WG_BAR + (2 * WG_NS + 1) * 8 + 1024;  // + alignment

__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar),
               "r"(count)
               : "memory");
}
// arrive, and expect `bytes` more from the copies that complete on bar
__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar),
      "r"(bytes)
      : "memory");
}
__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile(
      "{\n.reg .b64 state;\nmbarrier.arrive.shared::cta.b64 state, [%0];\n}\n"
      ::"r"(bar)
      : "memory");
}
// wait until the barrier's phase of this parity has completed
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  } while (!done);
}
// TMA: one box of a tensor map into shared memory, completing on bar
__device__ __forceinline__ void tma_load_3d(uint32_t dst, const CUtensorMap* map,
                                            uint32_t bar, int c0, int c1,
                                            int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1),
      "r"(c2)
      : "memory");
}
__device__ __forceinline__ void tma_load_1d(uint32_t dst, const CUtensorMap* map,
                                            uint32_t bar, int c0) {
  asm volatile(
      "cp.async.bulk.tensor.1d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0)
      : "memory");
}

// wgmma descriptor of a 64-row tile of 128-byte rows in the 128-byte
// swizzle, as TMA writes it: start address >> 4, leading byte offset 16
// (unused: one swizzle atom spans the operand's 64 columns), stride byte
// offset 1024 (from one 8-row group to the next), layout 1 = 128-byte
// swizzle. Read K-major (rows = M or N, k along the row), a k-step of 16
// starts 32 bytes further (+2); read MN-major (rows = k), 16 rows further
// (+2048 bytes, +128).
__device__ __forceinline__ uint64_t sw128_desc(uint32_t addr) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)1 << 16) |
         ((uint64_t)(1024 >> 4) << 32) | ((uint64_t)1 << 62);
}
__device__ __forceinline__ void wg_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wg_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
// wait until at most N committed groups of wgmma are in flight
template <int N> __device__ __forceinline__ void wg_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}
// keep the compiler from moving accesses of an accumulator across the
// asynchronous products that write it
__device__ __forceinline__ void acc_fence(float (&d)[32]) {
#pragma unroll
  for (int i = 0; i < 32; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// d (+)= A B over one k-step of 16, m64n64k16: A (64 x 16) and B (16 x 64,
// K-major) in shared memory by descriptor; scale_d = 0 overwrites d
__device__ __forceinline__ void wgmma_ss(float (&d)[32], uint64_t da,
                                         uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(scale_d));
}
// d += A B over one k-step of 16, m64n64k16: A (64 x 16) from registers in
// the m16n8k16 A-fragment layout of each warp's 16 rows, B (16 x 64) in
// shared memory by descriptor, MN-major (the transpose bit set)
__device__ __forceinline__ void wgmma_rs_t(float (&d)[32],
                                           const uint32_t (&a)[4],
                                           uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// The rotation pre-pass: a [B, H, S, D] bf16 tensor rotated by the
// gathered fp32 tables c, s [S, D/2] (its position index along S) into y,
// with rope_tile's arithmetic (fp32 rotate-half, each product rounded on
// its own, rounded to bf16), so that the wgmma forward's, dq's and dk/dv's
// products see the operands a per-tile rotation gave. One thread per 8
// columns of a row position, batch and group of ROPE_HEADS heads, which
// loads its table entries once and walks the group. Bound by bytes: each
// element read and written once.
constexpr int ROPE_HEADS = 4;
template <int D>
__global__ void __launch_bounds__(256) rope_rows_kernel(
    const __nv_bfloat16* __restrict__ x, const float* __restrict__ c,
    const float* __restrict__ s, __nv_bfloat16* __restrict__ y, int H,
    int S) {
  constexpr int HD = D / 2, CH = HD / 8;
  const int idx = blockIdx.x * 256 + threadIdx.x;
  if (idx >= S * CH) return;
  const int row = idx / CH, d = (idx % CH) * 8;
  const float4 c0 = *reinterpret_cast<const float4*>(c + row * HD + d);
  const float4 c1 = *reinterpret_cast<const float4*>(c + row * HD + d + 4);
  const float4 s0 = *reinterpret_cast<const float4*>(s + row * HD + d);
  const float4 s1 = *reinterpret_cast<const float4*>(s + row * HD + d + 4);
  const float cc[8] = {c0.x, c0.y, c0.z, c0.w, c1.x, c1.y, c1.z, c1.w};
  const float ss[8] = {s0.x, s0.y, s0.z, s0.w, s1.x, s1.y, s1.z, s1.w};
  const int h_end = min(H, (int)(blockIdx.z + 1) * ROPE_HEADS);
#pragma unroll
  for (int h = blockIdx.z * ROPE_HEADS; h < h_end; ++h) {
    const size_t o = (((size_t)blockIdx.y * H + h) * S + row) * D + d;
    float a[8], b[8], ar[8], br[8];
    unpack8(*reinterpret_cast<const uint4*>(x + o), a);
    unpack8(*reinterpret_cast<const uint4*>(x + o + HD), b);
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      ar[i] = __fsub_rn(__fmul_rn(a[i], cc[i]), __fmul_rn(b[i], ss[i]));
      br[i] = __fadd_rn(__fmul_rn(b[i], cc[i]), __fmul_rn(a[i], ss[i]));
    }
    *reinterpret_cast<uint4*>(y + o) = pack8(ar);
    *reinterpret_cast<uint4*>(y + o + HD) = pack8(br);
  }
}

// Three blocks per SM: 168 registers (ptxas: no spills), and 3 x 70,456
// bytes of shared memory. Two blocks of 191 registers were 11% slower
// (PERF.md): the more warps an SM holds, the more of one block's
// exponentials run under another's products.
__global__ void __launch_bounds__(WG_NT, 3) bwd_dkv_wgmma_kernel(
    const __grid_constant__ CUtensorMap tm_q,
    const __grid_constant__ CUtensorMap tm_k,
    const __grid_constant__ CUtensorMap tm_v,
    const __grid_constant__ CUtensorMap tm_do,
    const __grid_constant__ CUtensorMap tm_lse,
    const __grid_constant__ CUtensorMap tm_dl,
    const __grid_constant__ CUtensorMap tm_qp,
    __nv_bfloat16* __restrict__ dk, __nv_bfloat16* __restrict__ dv,
    const int* __restrict__ qpos, const int* __restrict__ kpos,
    const float* ck, const float* sk, int Hq, int Hkv, int Sq, int Sk,
    int causal, int static_causal) {
  constexpr int D = WG_D, H = D / 2;
  extern __shared__ uint8_t wg_smem[];
  const uint32_t raw = smem_u32(wg_smem);
  const uint32_t base = (raw + 1023) & ~1023u;
  uint8_t* gbase = wg_smem + (base - raw);
  int* kp_s = reinterpret_cast<int*>(gbase + WG_KP);
  const uint32_t full0 = base + WG_BAR, empty0 = full0 + 8 * WG_NS;
  const uint32_t kv_bar = empty0 + 8 * WG_NS;

  // static-causal: kv tile 0 sees the most q tiles, so ascending blockIdx.x
  // already launches the heaviest blocks first
  const int kt = blockIdx.x, hk = blockIdx.y, b = blockIdx.z;
  const int n_rep = Hq / Hkv;
  const int k0 = kt * BK, nk = min(BK, Sk - k0);
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, tig = lane & 3;

  if (tid < BK) kp_s[tid] = causal && tid < nk ? kpos[k0 + tid] : 0;
  if (tid == 0) {
    for (int s = 0; s < WG_NS; ++s) {
      mbar_init(full0 + 8 * s, 1);   // the copier's arrive.expect_tx
      mbar_init(empty0 + 8 * s, 4);  // one arrive per warp
    }
    mbar_init(kv_bar, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();  // the barriers and kv positions, once, before the loop
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
  // its class: invisible tiles are neither copied nor multiplied. Every
  // lane of a warp calls it (tile_minmax is warp-wide).
  auto next_visible = [&](int it, TileClass& cls) {
    for (; it < it_end; ++it) {
      cls = tile_class(it);
      if (cls.visible) return it;
    }
    return it_end;
  };
  // lane 0 of warp 0 copies step it into ring stage st by TMA: the Q and
  // dO tiles (rows past Sq zero-filled), the lse and delta rows from the
  // aligned entry before the tile and, when causal, the q positions
  // (entries past the tile's end are masked)
  const uint32_t step_bytes =
      2 * WG_TILE + 2 * WG_BOX * 4 + (causal ? BQ * 4 : 0);
  auto row0 = [&](int it) {  // the tile's first lse entry
    return (b * Hq + hk * n_rep + it / nqt) * Sq + q_start(it);
  };
  auto issue = [&](int it, int st) {
    const int q0 = q_start(it);
    const int bh = b * Hq + hk * n_rep + it / nqt;
    const uint32_t bar = full0 + 8 * st;
    mbar_expect_tx(bar, step_bytes);
    tma_load_3d(base + WG_Q + st * WG_TILE, &tm_q, bar, 0, q0, bh);
    tma_load_3d(base + WG_DO + st * WG_TILE, &tm_do, bar, 0, q0, bh);
    tma_load_1d(base + WG_LSE + st * WG_ROW, &tm_lse, bar, row0(it) & ~3);
    tma_load_1d(base + WG_DL + st * WG_ROW, &tm_dl, bar, row0(it) & ~3);
    if (causal) tma_load_1d(base + WG_QP + st * WG_ROW, &tm_qp, bar, q0);
  };

  TileClass cls, cls_p;
  int it = next_visible(0, cls);
  // warp 0's cursor: the next visible step to copy
  int ip = it;
  if (warp == 0) {
    if (lane == 0) {
      mbar_expect_tx(kv_bar, 2 * WG_TILE);
      tma_load_3d(base + WG_K, &tm_k, kv_bar, 0, k0, b * Hkv + hk);
      tma_load_3d(base + WG_V, &tm_v, kv_bar, 0, k0, b * Hkv + hk);
    }
    for (int st = 0; st < WG_NS && ip < it_end; ++st) {
      if (lane == 0) issue(ip, st);
      __syncwarp();
      ip = next_visible(ip + 1, cls_p);
    }
  }

  float dk_acc[32], dv_acc[32];
#pragma unroll
  for (int i = 0; i < 32; ++i) {
    dk_acc[i] = 0.f;
    dv_acc[i] = 0.f;
  }
  // S^T then P^T, and dP^T then dS^T (overwritten by each step's first
  // k-step)
  float p[32], dp[32];
#pragma unroll
  for (int i = 0; i < 32; ++i) {
    p[i] = 0.f;
    dp[i] = 0.f;
  }
  mbar_wait(kv_bar, 0);
  const uint64_t k_desc = sw128_desc(base + WG_K);
  const uint64_t v_desc = sw128_desc(base + WG_V);

  for (int n = 0; it < it_end; ++n) {
    const int st = n % WG_NS;
    const uint32_t parity = (n / WG_NS) & 1;
    mbar_wait(full0 + 8 * st, parity);  // step it has landed in stage st
    const int nq = min(BQ, Sq - q_start(it));
    const uint32_t qa = base + WG_Q + st * WG_TILE;
    const uint32_t oa = base + WG_DO + st * WG_TILE;
    const int* qp_s = reinterpret_cast<const int*>(gbase + WG_QP + st * WG_ROW);
    const int o = row0(it) & 3;
    const float* lse_s =
        reinterpret_cast<const float*>(gbase + WG_LSE + st * WG_ROW) + o;
    const float* dl_s =
        reinterpret_cast<const float*>(gbase + WG_DL + st * WG_ROW) + o;

    // S^T = K Q^T and dP^T = V dO^T, two groups: the exponentials of S^T
    // run while dP^T is still being multiplied
    wg_fence();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk)
      wgmma_ss(p, k_desc + 2 * kk, sw128_desc(qa) + 2 * kk, kk);
    wg_commit();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk)
      wgmma_ss(dp, v_desc + 2 * kk, sw128_desc(oa) + 2 * kk, kk);
    wg_commit();
    // while they run, warp 0 refills the stage step n - 1 released (every
    // warp has arrived on it: all four issued the products above) with the
    // visible step WG_NS - 1 ahead
    if (n > 0 && warp == 0 && ip < it_end) {
      const int sp = (n - 1) % WG_NS;
      if (lane == 0) {
        mbar_wait(empty0 + 8 * sp, ((n - 1) / WG_NS) & 1);
        issue(ip, sp);
      }
      __syncwarp();
      ip = next_visible(ip + 1, cls_p);
    }
    wg_wait<1>();
    acc_fence(p);
    // P^T = exp(S^T - lse[c]) in fp32: this lane holds kv rows r (e = 0, 1:
    // 16 warp + g; e = 2, 3: + 8) at q columns cb, cb + 1 of each chunk j
#pragma unroll
    for (int j = 0; j < BQ / 8; ++j) {
      const int cb = j * 8 + tig * 2;
      // exp(x) as exp2(x log2 e); a column with no visible key (lse =
      // -inf) must give P = 0, so its shift is +inf
      const float lb[2] = {
          lse_s[cb] <= NEG ? INFINITY : lse_s[cb] * LOG2E,
          lse_s[cb + 1] <= NEG ? INFINITY : lse_s[cb + 1] * LOG2E};
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = warp * 16 + g + (e >> 1) * 8, c = cb + (e & 1);
        float sv = p[4 * j + e];
        if (!cls.full) {
          const bool ok = c < nq && (!causal || qp_s[c] >= kp_s[r]);
          if (!ok) sv = NEG;
        }
        p[4 * j + e] = fast_exp2(fmaf(sv, LOG2E, -lb[e & 1]));
      }
    }
    wg_wait<0>();
    acc_fence(dp);
    // dS^T = P^T (dP^T - delta[c]) from the fp32 P, then both rounded to
    // bf16 as A fragments: k-step kk (q rows 16 kk..) is chunks 2 kk and
    // 2 kk + 1, so P and dS never touch shared memory
    uint32_t pa[BQ / 16][4], sa[BQ / 16][4];
#pragma unroll
    for (int j = 0; j < BQ / 8; ++j) {
      const float dl[2] = {dl_s[j * 8 + tig * 2], dl_s[j * 8 + tig * 2 + 1]};
#pragma unroll
      for (int e = 0; e < 4; ++e)
        dp[4 * j + e] = p[4 * j + e] * (dp[4 * j + e] - dl[e & 1]);
    }
#pragma unroll
    for (int kk = 0; kk < BQ / 16; ++kk)
#pragma unroll
      for (int i = 0; i < 4; ++i) {  // chunk 2 kk + i / 2, rows (i & 1)
        pa[kk][i] = pack_bf16(p[8 * kk + 2 * i], p[8 * kk + 2 * i + 1]);
        sa[kk][i] = pack_bf16(dp[8 * kk + 2 * i], dp[8 * kk + 2 * i + 1]);
      }
    // dV += P^T dO and dK += dS^T Q, dO and Q read MN-major from the
    // stage; the stage is released once both have read it
    acc_fence(dv_acc);
    acc_fence(dk_acc);
    wg_fence();
#pragma unroll
    for (int kk = 0; kk < BQ / 16; ++kk)
      wgmma_rs_t(dv_acc, pa[kk], sw128_desc(oa + kk * 2048));
#pragma unroll
    for (int kk = 0; kk < BQ / 16; ++kk)
      wgmma_rs_t(dk_acc, sa[kk], sw128_desc(qa + kk * 2048));
    wg_commit();
    wg_wait<0>();
    acc_fence(dv_acc);
    acc_fence(dk_acc);
    __syncwarp();
    if (lane == 0) mbar_arrive(empty0 + 8 * st);
    it = next_visible(it + 1, cls);
  }

  // dk was accumulated against the rotated k: back through the rotation's
  // transpose, y c + y[d+D/2] s (d < D/2), y c - y[d-D/2] s, each product
  // rounded on its own as the plain version's separate fp32 ops round them.
  // Column d and d + D/2 are chunks j and j + 4 of the same lane and e.
  if (ck != nullptr) {
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int r = warp * 16 + g + 8 * i;
      if (r >= nk) continue;  // past Sk: no table row, never written
#pragma unroll
      for (int j = 0; j < D / 16; ++j)
#pragma unroll
        for (int e = 2 * i; e < 2 * i + 2; ++e) {
          const size_t t = (size_t)(k0 + r) * H + j * 8 + tig * 2 + (e & 1);
          const float c = ck[t], s = sk[t];
          const float x = dk_acc[4 * j + e], y = dk_acc[4 * (j + D / 16) + e];
          dk_acc[4 * j + e] = __fadd_rn(__fmul_rn(x, c), __fmul_rn(y, s));
          dk_acc[4 * (j + D / 16) + e] =
              __fsub_rn(__fmul_rn(y, c), __fmul_rn(x, s));
        }
    }
  }
  // dK and dV rounded to bf16 and stored from the accumulators, two
  // columns per store; rows past Sk are not written
  const size_t kv_row0 = (size_t)(b * Hkv + hk) * Sk + k0;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int r = warp * 16 + g + 8 * i;
    if (r >= nk) continue;
#pragma unroll
    for (int j = 0; j < D / 8; ++j) {
      const size_t o = (kv_row0 + r) * D + j * 8 + tig * 2;
      *reinterpret_cast<uint32_t*>(dk + o) =
          pack_bf16(dk_acc[4 * j + 2 * i], dk_acc[4 * j + 2 * i + 1]);
      *reinterpret_cast<uint32_t*>(dv + o) =
          pack_bf16(dv_acc[4 * j + 2 * i], dv_acc[4 * j + 2 * i + 1]);
    }
  }
}

// ---------------------------------------------------------------------------
// dq on Hopper (bf16, D 64), the design in the note at the top: one
// warpgroup per (64-row q tile, q head, batch); per visible kv tile, with
// the q rows as wgmma's M and the 64 kv columns as N,
//   S = Q K^T, P = exp(S - lse), dP = dO V^T, dS = P (dP - delta),
// and then dQ += dS K with the 64 columns of d as N. Q and K rotated
// beforehand by rope_rows_kernel. Accumulator layout as for
// bwd_dkv_wgmma_kernel: this lane holds q rows 16 w + g and 16 w + g + 8
// at columns 8 j + 2 t, 8 j + 2 t + 1 in d[4 j .. 4 j + 3].
// ---------------------------------------------------------------------------

constexpr int DQ_NS = 2;               // ring stages
// shared memory, in bytes from a 1024-aligned base: Q and dO (resident),
// then NS stages of K, NS of V, NS rows of kv positions, and the barriers
// (full[NS], empty[NS], qo)
constexpr int DQ_Q = 0;
constexpr int DQ_DO = WG_TILE;
constexpr int DQ_K = 2 * WG_TILE;
constexpr int DQ_V = DQ_K + DQ_NS * WG_TILE;
constexpr int DQ_KP = DQ_V + DQ_NS * WG_TILE;
constexpr int DQ_BAR = DQ_KP + DQ_NS * BK * 4;
constexpr int DQ_SMEM = DQ_BAR + (2 * DQ_NS + 1) * 8 + 1024;  // + alignment

// Four blocks per SM: 128 registers (ptxas: 4 bytes spilled) and 4 x
// 50,728 bytes of shared memory. Three blocks (143 registers, no spill,
// two or three stages) were 6% slower, four stages (two blocks by shared
// memory) and two warpgroups a block sharing each stage (one block) 30%
// slower (PERF.md): the more warps an SM holds, the more of one block's
// exponentials run under another's products.
__global__ void __launch_bounds__(WG_NT, 4) bwd_dq_wgmma_kernel(
    const __grid_constant__ CUtensorMap tm_q,
    const __grid_constant__ CUtensorMap tm_k,
    const __grid_constant__ CUtensorMap tm_v,
    const __grid_constant__ CUtensorMap tm_do,
    const __grid_constant__ CUtensorMap tm_kp, const float* __restrict__ lse,
    const float* __restrict__ delta, __nv_bfloat16* __restrict__ dq,
    const int* __restrict__ qpos, const int* __restrict__ kpos,
    const float* cq, const float* sq, int Hq, int Hkv, int Sq, int Sk,
    int causal, int static_causal) {
  constexpr int D = WG_D, H = D / 2;
  extern __shared__ uint8_t wg_smem[];
  const uint32_t raw = smem_u32(wg_smem);
  const uint32_t base = (raw + 1023) & ~1023u;
  const uint8_t* gbase = wg_smem + (base - raw);
  const uint32_t full0 = base + DQ_BAR, empty0 = full0 + 8 * DQ_NS;
  const uint32_t qo_bar = empty0 + 8 * DQ_NS;

  const int num_q = (Sq + BQ - 1) / BQ;
  // static-causal: the heaviest q tiles (most kv tiles) launch first
  const int qt = static_causal ? num_q - 1 - (int)blockIdx.x : (int)blockIdx.x;
  const int h = blockIdx.y, b = blockIdx.z;
  const int hk = h / (Hq / Hkv);
  const int q0 = qt * BQ, nq = min(BQ, Sq - q0);
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, tig = lane & 3;
  const size_t row_base = (size_t)(b * Hq + h) * Sq;

  if (tid == 0) {
    for (int s = 0; s < DQ_NS; ++s) {
      mbar_init(full0 + 8 * s, 1);   // the copier's arrive.expect_tx
      mbar_init(empty0 + 8 * s, 4);  // one arrive per warp
    }
    mbar_init(qo_bar, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  // lse, delta and the position of this lane's rows g and g + 8 of its
  // warp's 16 (i = 0, 1), read once: exp(x) as exp2(x log2 e), and a row
  // with no visible key (lse = -inf) or past Sq must give P = 0, so its
  // shift is +inf
  float lb[2], dl[2];
  int qp[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int r = warp * 16 + g + 8 * i;
    const bool in = r < nq;
    const float lr = in ? lse[row_base + q0 + r] : -INFINITY;
    lb[i] = lr <= NEG ? INFINITY : lr * LOG2E;
    dl[i] = in ? delta[row_base + q0 + r] : 0.f;
    qp[i] = in ? qpos[q0 + r] : 0;
  }
  int qmin = 0, qmax = 0;
  if (causal && !static_causal) tile_minmax(qpos + q0, nq, qmin, qmax);
  __syncthreads();  // the barriers, once, before the loop

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
  // class: invisible tiles are neither copied nor multiplied. Every lane
  // of a warp calls it (tile_minmax is warp-wide).
  auto next_visible = [&](int kt, TileClass& cls) {
    for (; kt < kv_end; ++kt) {
      cls = tile_class(kt);
      if (cls.visible) return kt;
    }
    return kv_end;
  };
  // lane 0 of warp 0 copies kv tile kt into ring stage st by TMA: K and V
  // (rows past Sk zero-filled) and, when causal, the kv positions (64
  // entries from a multiple of 64: 16-byte aligned)
  const uint32_t step_bytes = 2 * WG_TILE + (causal ? BK * 4 : 0);
  auto issue = [&](int kt, int st) {
    const uint32_t bar = full0 + 8 * st;
    mbar_expect_tx(bar, step_bytes);
    tma_load_3d(base + DQ_K + st * WG_TILE, &tm_k, bar, 0, kt * BK,
                b * Hkv + hk);
    tma_load_3d(base + DQ_V + st * WG_TILE, &tm_v, bar, 0, kt * BK,
                b * Hkv + hk);
    if (causal) tma_load_1d(base + DQ_KP + st * BK * 4, &tm_kp, bar, kt * BK);
  };

  TileClass cls, cls_p;
  int kt = next_visible(0, cls);
  // warp 0's cursor: the next visible kv tile to copy
  int ip = kt;
  if (warp == 0) {
    if (lane == 0 && kt < kv_end) {  // Q and dO (rows past Sq zero), once
      mbar_expect_tx(qo_bar, 2 * WG_TILE);
      tma_load_3d(base + DQ_Q, &tm_q, qo_bar, 0, q0, b * Hq + h);
      tma_load_3d(base + DQ_DO, &tm_do, qo_bar, 0, q0, b * Hq + h);
    }
    for (int st = 0; st < DQ_NS && ip < kv_end; ++st) {
      if (lane == 0) issue(ip, st);
      __syncwarp();
      ip = next_visible(ip + 1, cls_p);
    }
  }

  // dQ, S then P, and dP then dS (S and dP overwritten by each tile's
  // first k-step)
  float acc[32], s[32], dp[32];
#pragma unroll
  for (int i = 0; i < 32; ++i) {
    acc[i] = 0.f;
    s[i] = 0.f;
    dp[i] = 0.f;
  }
  if (kt < kv_end) mbar_wait(qo_bar, 0);
  const uint64_t q_desc = sw128_desc(base + DQ_Q);
  const uint64_t o_desc = sw128_desc(base + DQ_DO);

  for (int n = 0; kt < kv_end; ++n) {
    const int st = n % DQ_NS;
    mbar_wait(full0 + 8 * st, (n / DQ_NS) & 1);  // tile kt is in stage st
    const int nk = min(BK, Sk - kt * BK);
    const uint32_t ka = base + DQ_K + st * WG_TILE;
    const uint32_t va = base + DQ_V + st * WG_TILE;
    const int* kp_s = reinterpret_cast<const int*>(gbase + DQ_KP + st * BK * 4);

    // S = Q K^T and dP = dO V^T, two groups: the exponentials of S run
    // while dP is still being multiplied
    wg_fence();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk)
      wgmma_ss(s, q_desc + 2 * kk, sw128_desc(ka) + 2 * kk, kk);
    wg_commit();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk)
      wgmma_ss(dp, o_desc + 2 * kk, sw128_desc(va) + 2 * kk, kk);
    wg_commit();
    // while they run, warp 0 refills the stage tile n - 1 released (every
    // warp has arrived on it: all four issued the products above) with
    // the visible tile DQ_NS - 1 ahead
    if (n > 0 && warp == 0 && ip < kv_end) {
      const int sp = (n - 1) % DQ_NS;
      if (lane == 0) {
        mbar_wait(empty0 + 8 * sp, ((n - 1) / DQ_NS) & 1);
        issue(ip, sp);
      }
      __syncwarp();
      ip = next_visible(ip + 1, cls_p);
    }
    wg_wait<1>();
    acc_fence(s);
    // P = exp(S - lse) in fp32: this lane holds q rows g (e = 0, 1) and
    // g + 8 (e = 2, 3) at kv columns c, c + 1 of each chunk j
#pragma unroll
    for (int j = 0; j < BK / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int c = j * 8 + tig * 2 + (e & 1);
        float sv = s[4 * j + e];
        if (!cls.full) {
          const bool ok = c < nk && (!causal || qp[e >> 1] >= kp_s[c]);
          if (!ok) sv = NEG;
        }
        s[4 * j + e] = fast_exp2(fmaf(sv, LOG2E, -lb[e >> 1]));
      }
    wg_wait<0>();
    acc_fence(dp);
    // dS = P (dP - delta) from the fp32 P, rounded to bf16 as A fragments:
    // k-step kk (kv columns 16 kk..) is chunks 2 kk and 2 kk + 1, so dS
    // never touches shared memory
#pragma unroll
    for (int j = 0; j < BK / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        dp[4 * j + e] = s[4 * j + e] * (dp[4 * j + e] - dl[e >> 1]);
    uint32_t sa[BK / 16][4];
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk)
#pragma unroll
      for (int i = 0; i < 4; ++i)  // chunk 2 kk + i / 2, rows (i & 1)
        sa[kk][i] = pack_bf16(dp[8 * kk + 2 * i], dp[8 * kk + 2 * i + 1]);
    // dQ += dS K, K read MN-major from the stage; the stage is released
    // once the product has read it
    acc_fence(acc);
    wg_fence();
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk)
      wgmma_rs_t(acc, sa[kk], sw128_desc(ka + kk * 2048));
    wg_commit();
    wg_wait<0>();
    acc_fence(acc);
    __syncwarp();
    if (lane == 0) mbar_arrive(empty0 + 8 * st);
    kt = next_visible(kt + 1, cls);
  }

  // dq was accumulated against the rotated q: back through the rotation's
  // transpose, y c + y[d+D/2] s (d < D/2), y c - y[d-D/2] s, each product
  // rounded on its own as the plain version's separate fp32 ops round them.
  // Column d and d + D/2 are chunks j and j + 4 of the same lane and e.
  if (cq != nullptr) {
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int r = warp * 16 + g + 8 * i;
      if (r >= nq) continue;  // past Sq: no table row, never written
#pragma unroll
      for (int j = 0; j < D / 16; ++j)
#pragma unroll
        for (int e = 2 * i; e < 2 * i + 2; ++e) {
          const size_t t = (size_t)(q0 + r) * H + j * 8 + tig * 2 + (e & 1);
          const float c = cq[t], sn = sq[t];
          const float x = acc[4 * j + e], y = acc[4 * (j + D / 16) + e];
          acc[4 * j + e] = __fadd_rn(__fmul_rn(x, c), __fmul_rn(y, sn));
          acc[4 * (j + D / 16) + e] =
              __fsub_rn(__fmul_rn(y, c), __fmul_rn(x, sn));
        }
    }
  }
  // dQ rounded to bf16 and stored from the accumulator, two columns per
  // store; rows past Sq are not written
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int r = warp * 16 + g + 8 * i;
    if (r >= nq) continue;
#pragma unroll
    for (int j = 0; j < D / 8; ++j)
      *reinterpret_cast<uint32_t*>(dq + (row_base + q0 + r) * D + j * 8 +
                                   tig * 2) =
          pack_bf16(acc[4 * j + 2 * i], acc[4 * j + 2 * i + 1]);
  }
}

// ---------------------------------------------------------------------------
// The forward on Hopper (bf16, D 64), the design in the note at the top:
// one warpgroup per (64-row q tile, q head, batch); per visible kv tile,
// with the q rows as wgmma's M and the 64 kv columns as N,
//   S = Q K^T, m' = max(m, rowmax S), alpha = exp(m - m'), P = exp(S - m'),
//   l = l alpha + rowsum P, O = O alpha + P V
// (the last with the 64 columns of d as N), and out = O / l, lse = m +
// log l after the last tile. Q and K rotated beforehand by
// rope_rows_kernel. Accumulator layout as for bwd_dkv_wgmma_kernel: this
// lane holds q rows 16 w + g and 16 w + g + 8 at columns 8 j + 2 t,
// 8 j + 2 t + 1 in d[4 j .. 4 j + 3].
// ---------------------------------------------------------------------------

constexpr int FW_NS = 2;      // ring stages
constexpr int FW_BLOCKS = 5;  // blocks an SM, for the launch bounds
// shared memory, in bytes from a 1024-aligned base: Q (resident), then NS
// stages of K, NS of V, NS rows of kv positions, and the barriers
// (full[NS], empty[NS], q)
constexpr int FW_Q = 0;
constexpr int FW_K = WG_TILE;
constexpr int FW_V = FW_K + FW_NS * WG_TILE;
constexpr int FW_KP = FW_V + FW_NS * WG_TILE;
constexpr int FW_BAR = FW_KP + FW_NS * BK * 4;
constexpr int FW_SMEM = FW_BAR + (2 * FW_NS + 1) * 8 + 1024;  // + alignment

__global__ void __launch_bounds__(WG_NT, FW_BLOCKS) fwd_wgmma_kernel(
    const __grid_constant__ CUtensorMap tm_q,
    const __grid_constant__ CUtensorMap tm_k,
    const __grid_constant__ CUtensorMap tm_v,
    const __grid_constant__ CUtensorMap tm_kp, __nv_bfloat16* __restrict__ out,
    float* __restrict__ lse, const int* __restrict__ qpos,
    const int* __restrict__ kpos, int Hq, int Hkv, int Sq, int Sk,
    int causal, int static_causal) {
  constexpr int D = WG_D;
  extern __shared__ uint8_t wg_smem[];
  const uint32_t raw = smem_u32(wg_smem);
  const uint32_t base = (raw + 1023) & ~1023u;
  const uint8_t* gbase = wg_smem + (base - raw);
  const uint32_t full0 = base + FW_BAR, empty0 = full0 + 8 * FW_NS;
  const uint32_t q_bar = empty0 + 8 * FW_NS;

  const int num_q = (Sq + BQ - 1) / BQ;
  // static-causal: the heaviest q tiles (most kv tiles) launch first
  const int qt = static_causal ? num_q - 1 - (int)blockIdx.x : (int)blockIdx.x;
  const int h = blockIdx.y, b = blockIdx.z;
  const int hk = h / (Hq / Hkv);
  const int q0 = qt * BQ, nq = min(BQ, Sq - q0);
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, tig = lane & 3;
  const size_t row_base = (size_t)(b * Hq + h) * Sq;

  if (tid == 0) {
    for (int s = 0; s < FW_NS; ++s) {
      mbar_init(full0 + 8 * s, 1);   // the copier's arrive.expect_tx
      mbar_init(empty0 + 8 * s, 4);  // one arrive per warp
    }
    mbar_init(q_bar, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  // the positions of this lane's rows g and g + 8 of its warp's 16, read
  // once
  int qp[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int r = warp * 16 + g + 8 * i;
    qp[i] = r < nq ? qpos[q0 + r] : 0;
  }
  int qmin = 0, qmax = 0;
  if (causal && !static_causal) tile_minmax(qpos + q0, nq, qmin, qmax);
  __syncthreads();  // the barriers, once, before the loop

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
  // class: invisible tiles are neither copied nor multiplied. Every lane
  // of a warp calls it (tile_minmax is warp-wide).
  auto next_visible = [&](int kt, TileClass& cls) {
    for (; kt < kv_end; ++kt) {
      cls = tile_class(kt);
      if (cls.visible) return kt;
    }
    return kv_end;
  };
  // lane 0 of warp 0 copies kv tile kt into ring stage st by TMA: K and V
  // (rows past Sk zero-filled) and, when causal, the kv positions (64
  // entries from a multiple of 64: 16-byte aligned)
  const uint32_t step_bytes = 2 * WG_TILE + (causal ? BK * 4 : 0);
  auto issue = [&](int kt, int st) {
    const uint32_t bar = full0 + 8 * st;
    mbar_expect_tx(bar, step_bytes);
    tma_load_3d(base + FW_K + st * WG_TILE, &tm_k, bar, 0, kt * BK,
                b * Hkv + hk);
    tma_load_3d(base + FW_V + st * WG_TILE, &tm_v, bar, 0, kt * BK,
                b * Hkv + hk);
    if (causal) tma_load_1d(base + FW_KP + st * BK * 4, &tm_kp, bar, kt * BK);
  };

  TileClass cls, cls_p;
  int kt = next_visible(0, cls);
  // warp 0's cursor: the next visible kv tile to copy
  int ip = kt;
  if (warp == 0) {
    if (lane == 0 && kt < kv_end) {  // Q (rows past Sq zero), once
      mbar_expect_tx(q_bar, WG_TILE);
      tma_load_3d(base + FW_Q, &tm_q, q_bar, 0, q0, b * Hq + h);
    }
    for (int st = 0; st < FW_NS && ip < kv_end; ++st) {
      if (lane == 0) issue(ip, st);
      __syncwarp();
      ip = next_visible(ip + 1, cls_p);
    }
  }

  // O, and S then P (S overwritten by each tile's first k-step); the
  // running row max m and sum l of this lane's two rows
  float o[32], s[32], m[2] = {NEG, NEG}, l[2] = {0.f, 0.f};
#pragma unroll
  for (int i = 0; i < 32; ++i) {
    o[i] = 0.f;
    s[i] = 0.f;
  }
  if (kt < kv_end) mbar_wait(q_bar, 0);
  const uint64_t q_desc = sw128_desc(base + FW_Q);

  for (int n = 0; kt < kv_end; ++n) {
    const int st = n % FW_NS;
    mbar_wait(full0 + 8 * st, (n / FW_NS) & 1);  // tile kt is in stage st
    const int nk = min(BK, Sk - kt * BK);
    const uint32_t ka = base + FW_K + st * WG_TILE;
    const uint32_t va = base + FW_V + st * WG_TILE;
    const int* kp_s = reinterpret_cast<const int*>(gbase + FW_KP + st * BK * 4);

    // S = Q K^T
    wg_fence();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk)
      wgmma_ss(s, q_desc + 2 * kk, sw128_desc(ka) + 2 * kk, kk);
    wg_commit();
    // while it runs, warp 0 refills the stage tile n - 1 released (every
    // warp has arrived on it: all four issued the product above) with the
    // visible tile FW_NS - 1 ahead
    if (n > 0 && warp == 0 && ip < kv_end) {
      const int sp = (n - 1) % FW_NS;
      if (lane == 0) {
        mbar_wait(empty0 + 8 * sp, ((n - 1) / FW_NS) & 1);
        issue(ip, sp);
      }
      __syncwarp();
      ip = next_visible(ip + 1, cls_p);
    }
    wg_wait<0>();
    acc_fence(s);
    // the mask, on tiles that are not full: this lane holds q rows g (e =
    // 0, 1) and g + 8 (e = 2, 3) at kv columns c, c + 1 of each chunk j
    if (!cls.full) {
#pragma unroll
      for (int j = 0; j < BK / 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int c = j * 8 + tig * 2 + (e & 1);
          const bool ok = c < nk && (!causal || qp[e >> 1] >= kp_s[c]);
          if (!ok) s[4 * j + e] = NEG;
        }
    }
    // the online softmax in fp32: a row's 64 scores lie across one quad
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      float mx = NEG;
#pragma unroll
      for (int j = 0; j < BK / 8; ++j)
        mx = fmaxf(mx, fmaxf(s[4 * j + 2 * i], s[4 * j + 2 * i + 1]));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      const float m_new = fmaxf(m[i], mx);
      // exp(x) as exp2(x log2 e)
      const float alpha = m[i] <= NEG ? 0.f : fast_exp2((m[i] - m_new) * LOG2E);
      // a row with no visible key yet has m_new = NEG: exp(NEG - NEG) must
      // be 0, so its shift is +inf
      const float mb = m_new <= NEG ? INFINITY : m_new * LOG2E;
      float rs = 0.f;
#pragma unroll
      for (int j = 0; j < BK / 8; ++j)
#pragma unroll
        for (int e = 2 * i; e < 2 * i + 2; ++e) {
          const float p = fast_exp2(fmaf(s[4 * j + e], LOG2E, -mb));
          rs += p;  // l sums p before its bf16 rounding
          s[4 * j + e] = p;
        }
      rs += __shfl_xor_sync(0xffffffffu, rs, 1);
      rs += __shfl_xor_sync(0xffffffffu, rs, 2);
      l[i] = l[i] * alpha + rs;
      m[i] = m_new;
      // O is not in flight: the previous tile's product was waited for
      // before its stage was released
#pragma unroll
      for (int j = 0; j < D / 8; ++j) {
        o[4 * j + 2 * i] *= alpha;
        o[4 * j + 2 * i + 1] *= alpha;
      }
    }
    // P rounded to bf16 as A fragments: k-step kk (kv columns 16 kk..) is
    // chunks 2 kk and 2 kk + 1, so P never touches shared memory
    uint32_t pa[BK / 16][4];
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk)
#pragma unroll
      for (int i = 0; i < 4; ++i)  // chunk 2 kk + i / 2, rows (i & 1)
        pa[kk][i] = pack_bf16(s[8 * kk + 2 * i], s[8 * kk + 2 * i + 1]);
    // O += P V, V read MN-major from the stage; the stage is released
    // once the product has read it. Waiting here keeps P's fragments and
    // S's accumulator apart: a P V still in flight under the next S
    // product made ptxas serialise every wgmma (a wait after each k-step)
    acc_fence(o);
    wg_fence();
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk)
      wgmma_rs_t(o, pa[kk], sw128_desc(va + kk * 2048));
    wg_commit();
    wg_wait<0>();
    acc_fence(o);
    __syncwarp();
    if (lane == 0) mbar_arrive(empty0 + 8 * st);
    kt = next_visible(kt + 1, cls);
  }

  // O / l rounded to bf16 and stored from the accumulator, two columns per
  // store; lse by the lane with t = 0; rows past Sq are not written
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int r = warp * 16 + g + 8 * i;
    if (r >= nq) continue;
    const float inv_l = 1.f / (l[i] == 0.f ? 1.f : l[i]);
#pragma unroll
    for (int j = 0; j < D / 8; ++j)
      *reinterpret_cast<uint32_t*>(out + (row_base + q0 + r) * D + j * 8 +
                                   tig * 2) =
          pack_bf16(o[4 * j + 2 * i] * inv_l, o[4 * j + 2 * i + 1] * inv_l);
    if (tig == 0)
      lse[row_base + q0 + r] = l[i] == 0.f ? -INFINITY : m[i] + logf(l[i]);
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


// cuTensorMapEncodeTiled (libcuda, not the runtime) through the runtime's
// entry point query, so the library needs no -lcuda; null if not found
using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                 void*, const cuuint64_t*, const cuuint64_t*,
                                 const cuuint32_t*, const cuuint32_t*,
                                 CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);
EncodeTiled encode_tiled() {
  static const EncodeTiled fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &found);
#else
    const cudaError_t err = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    return err == cudaSuccess && found == cudaDriverEntryPointSuccess
               ? reinterpret_cast<EncodeTiled>(p)
               : nullptr;
  }();
  return fn;
}

// the map of a contiguous bf16 [planes, rows, 64] tensor in 64 x 64 boxes,
// written in the 128-byte swizzle; boxes past `rows` are zero-filled
bool tile_map(CUtensorMap* map, const void* p, int rows, int planes) {
  const cuuint64_t dims[3] = {64, (cuuint64_t)rows, (cuuint64_t)planes};
  const cuuint64_t strides[2] = {64 * 2, (cuuint64_t)rows * 64 * 2};
  const cuuint32_t box[3] = {64, 64, 1}, unit[3] = {1, 1, 1};
  return encode_tiled()(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3,
                        const_cast<void*>(p), dims, strides, box, unit,
                        CU_TENSOR_MAP_INTERLEAVE_NONE,
                        CU_TENSOR_MAP_SWIZZLE_128B,
                        CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                        CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}
// the map of n contiguous 4-byte values in boxes of `box`, zero past n
bool row_map(CUtensorMap* map, const void* p, int n, int box_n,
             CUtensorMapDataType t) {
  const cuuint64_t dims[1] = {(cuuint64_t)n}, strides[1] = {4};
  const cuuint32_t box[1] = {(cuuint32_t)box_n}, unit[1] = {1};
  return encode_tiled()(map, t, 1, const_cast<void*>(p), dims, strides, box,
                        unit, CU_TENSOR_MAP_INTERLEAVE_NONE,
                        CU_TENSOR_MAP_SWIZZLE_NONE,
                        CU_TENSOR_MAP_L2_PROMOTION_NONE,
                        CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <int D>
cudaError_t launch_rope_rows(const void* x, const void* c, const void* s,
                             void* y, int B, int H, int S,
                             cudaStream_t stream) {
  // 16-byte loads and stores
  if (((uintptr_t)x | (uintptr_t)c | (uintptr_t)s | (uintptr_t)y) & 15)
    return cudaErrorMisalignedAddress;
  dim3 grid((S * (D / 16) + 255) / 256, B, (H + ROPE_HEADS - 1) / ROPE_HEADS);
  rope_rows_kernel<D><<<grid, 256, 0, stream>>>(
      (const __nv_bfloat16*)x, (const float*)c, (const float*)s,
      (__nv_bfloat16*)y, H, S);
  return cudaGetLastError();
}

// q and k arrive rotated (rope_rows_kernel), so there are no q tables; ck
// and sk, when given, are the tables of dk's inverse rotation
cudaError_t launch_dkv_wgmma(const void* q, const void* k, const void* v,
                             const void* dout, const void* lse,
                             const void* delta, void* dk, void* dv,
                             const void* qpos, const void* kpos,
                             const void* cq, const void* sq, const void* ck,
                             const void* sk, int B, int Hq, int Hkv, int Sq,
                             int Sk, int causal, int static_causal,
                             cudaStream_t stream) {
  if (cq != nullptr || sq != nullptr) return cudaErrorInvalidValue;
  // TMA reads from 16-byte aligned addresses; the stores move 4 bytes
  const uintptr_t addr = (uintptr_t)q | (uintptr_t)k | (uintptr_t)v |
                         (uintptr_t)dout | (uintptr_t)lse |
                         (uintptr_t)delta | (uintptr_t)qpos |
                         (uintptr_t)dk | (uintptr_t)dv;
  if (addr & 15) return cudaErrorMisalignedAddress;
  if (encode_tiled() == nullptr) return cudaErrorNotSupported;
  CUtensorMap tq, tk, tv, tdo, tl, td, tp;
  if (!tile_map(&tq, q, Sq, B * Hq) || !tile_map(&tdo, dout, Sq, B * Hq) ||
      !tile_map(&tk, k, Sk, B * Hkv) || !tile_map(&tv, v, Sk, B * Hkv) ||
      !row_map(&tl, lse, B * Hq * Sq, WG_BOX,
               CU_TENSOR_MAP_DATA_TYPE_FLOAT32) ||
      !row_map(&td, delta, B * Hq * Sq, WG_BOX,
               CU_TENSOR_MAP_DATA_TYPE_FLOAT32) ||
      !row_map(&tp, qpos, Sq, BQ, CU_TENSOR_MAP_DATA_TYPE_INT32))
    return cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      bwd_dkv_wgmma_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      WG_SMEM);
  if (err != cudaSuccess) return err;
  dim3 grid((Sk + BK - 1) / BK, Hkv, B);
  bwd_dkv_wgmma_kernel<<<grid, WG_NT, WG_SMEM, stream>>>(
      tq, tk, tv, tdo, tl, td, tp, (__nv_bfloat16*)dk, (__nv_bfloat16*)dv,
      (const int*)qpos, (const int*)kpos, (const float*)ck, (const float*)sk,
      Hq, Hkv, Sq, Sk, causal, static_causal);
  return cudaGetLastError();
}

// q and k arrive rotated (rope_rows_kernel), so there are no k tables; cq
// and sq, when given, are the tables of dq's inverse rotation
cudaError_t launch_dq_wgmma(const void* q, const void* k, const void* v,
                            const void* dout, const void* lse,
                            const void* delta, void* dq, const void* qpos,
                            const void* kpos, const void* cq, const void* sq,
                            const void* ck, const void* sk, int B, int Hq,
                            int Hkv, int Sq, int Sk, int causal,
                            int static_causal, cudaStream_t stream) {
  if (ck != nullptr || sk != nullptr) return cudaErrorInvalidValue;
  // TMA reads from 16-byte aligned addresses; the stores move 4 bytes
  const uintptr_t addr = (uintptr_t)q | (uintptr_t)k | (uintptr_t)v |
                         (uintptr_t)dout | (uintptr_t)kpos;
  if ((addr & 15) || ((uintptr_t)dq & 3)) return cudaErrorMisalignedAddress;
  if (encode_tiled() == nullptr) return cudaErrorNotSupported;
  CUtensorMap tq, tk, tv, tdo, tp;
  if (!tile_map(&tq, q, Sq, B * Hq) || !tile_map(&tdo, dout, Sq, B * Hq) ||
      !tile_map(&tk, k, Sk, B * Hkv) || !tile_map(&tv, v, Sk, B * Hkv) ||
      !row_map(&tp, kpos, Sk, BK, CU_TENSOR_MAP_DATA_TYPE_INT32))
    return cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      bwd_dq_wgmma_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      DQ_SMEM);
  if (err != cudaSuccess) return err;
  dim3 grid((Sq + BQ - 1) / BQ, Hq, B);
  bwd_dq_wgmma_kernel<<<grid, WG_NT, DQ_SMEM, stream>>>(
      tq, tk, tv, tdo, tp, (const float*)lse, (const float*)delta,
      (__nv_bfloat16*)dq, (const int*)qpos, (const int*)kpos,
      (const float*)cq, (const float*)sq, Hq, Hkv, Sq, Sk, causal,
      static_causal);
  return cudaGetLastError();
}

// q and k arrive rotated (rope_rows_kernel), so there are no tables
cudaError_t launch_fwd_wgmma(const void* q, const void* k, const void* v,
                             void* out, void* lse, const void* qpos,
                             const void* kpos, const void* cq,
                             const void* sq, const void* ck, const void* sk,
                             int B, int Hq, int Hkv, int Sq, int Sk,
                             int causal, int static_causal,
                             cudaStream_t stream) {
  if (cq != nullptr || sq != nullptr || ck != nullptr || sk != nullptr)
    return cudaErrorInvalidValue;
  // TMA reads from 16-byte aligned addresses; the stores move 4 bytes
  const uintptr_t addr =
      (uintptr_t)q | (uintptr_t)k | (uintptr_t)v | (uintptr_t)kpos;
  if ((addr & 15) || ((uintptr_t)out & 3)) return cudaErrorMisalignedAddress;
  if (encode_tiled() == nullptr) return cudaErrorNotSupported;
  CUtensorMap tq, tk, tv, tp;
  if (!tile_map(&tq, q, Sq, B * Hq) || !tile_map(&tk, k, Sk, B * Hkv) ||
      !tile_map(&tv, v, Sk, B * Hkv) ||
      !row_map(&tp, kpos, Sk, BK, CU_TENSOR_MAP_DATA_TYPE_INT32))
    return cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      fwd_wgmma_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, FW_SMEM);
  if (err != cudaSuccess) return err;
  dim3 grid((Sq + BQ - 1) / BQ, Hq, B);
  fwd_wgmma_kernel<<<grid, WG_NT, FW_SMEM, stream>>>(
      tq, tk, tv, tp, (__nv_bfloat16*)out, (float*)lse, (const int*)qpos,
      (const int*)kpos, Hq, Hkv, Sq, Sk, causal, static_causal);
  return cudaGetLastError();
}

}  // namespace

// Each entry dispatches on (input type, head dim); anything else is refused.
extern "C" {

// bf16 inputs run the Hopper forward at D 64 (q and k rotated beforehand,
// by pt_rope_rows) and the mma.sync one at D 128; fp32 inputs the
// CUDA-core one
int pt_flash_fwd(const void* q, const void* k, const void* v, void* out,
                 void* lse, const void* qpos, const void* kpos, const void* cq,
                 const void* sq, const void* ck, const void* sk, int B, int Hq,
                 int Hkv, int Sq, int Sk, int D, int causal, int static_causal,
                 int is_bf16, void* stream) {
#define PT_FWD_ARGS                                                        \
  q, k, v, out, lse, qpos, kpos, cq, sq, ck, sk, B, Hq, Hkv, Sq, Sk, causal, \
      static_causal, (cudaStream_t)stream
  if (is_bf16 && D == 64) return (int)launch_fwd_wgmma(PT_FWD_ARGS);
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
  // bf16 inputs run the Hopper dq at D 64 (q and k rotated beforehand, by
  // pt_rope_rows) and the mma.sync one at D 128; fp32 inputs the CUDA-core
  // one
#define PT_DQ_ARGS                                                          \
  q, k, v, dout, lse, delta, dq, qpos, kpos, cq, sq, ck, sk, B, Hq, Hkv, Sq, \
      Sk, causal, static_causal, (cudaStream_t)stream
  if (is_bf16 && D == 64) return (int)launch_dq_wgmma(PT_DQ_ARGS);
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
  // bf16 inputs run the Hopper dk/dv at D 64 (q and k rotated beforehand,
  // by pt_rope_rows) and the mma.sync one at D 128; fp32 inputs the
  // CUDA-core one
#define PT_DKV_ARGS                                                         \
  q, k, v, dout, lse, delta, dk, dv, qpos, kpos, cq, sq, ck, sk, B, Hq, Hkv, \
      Sq, Sk, causal, static_causal, (cudaStream_t)stream
  if (is_bf16 && D == 64) return (int)launch_dkv_wgmma(PT_DKV_ARGS);
  if (is_bf16 && D == 128) return (int)launch_dkv_mma<128>(PT_DKV_ARGS);
  if (!is_bf16 && D == 64) return (int)launch_dkv<float, 64>(PT_DKV_ARGS);
  if (!is_bf16 && D == 128) return (int)launch_dkv<float, 128>(PT_DKV_ARGS);
#undef PT_DKV_ARGS
  return (int)cudaErrorInvalidValue;
}

// the Hopper dk/dv's, dq's and forward's dynamic shared memory per block,
// in bytes
int pt_dkv_wgmma_smem(void) { return WG_SMEM; }
int pt_dq_wgmma_smem(void) { return DQ_SMEM; }
int pt_fwd_wgmma_smem(void) { return FW_SMEM; }

// the rotation pre-pass of the Hopper kernels: x [B, H, S, D] bf16 by
// the gathered tables [S, D/2] fp32, into y
int pt_rope_rows(const void* x, const void* c, const void* s, void* y, int B,
                 int H, int S, int D, void* stream) {
  if (D == WG_D)
    return (int)launch_rope_rows<WG_D>(x, c, s, y, B, H, S,
                                       (cudaStream_t)stream);
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
