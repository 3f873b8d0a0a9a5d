// Descriptor-matching kernels for Hopper (sm_90a), bound through a plain C
// interface (loaded with ctypes by vslam_tpu_torch/ops/cuda_matching.py).
//
// 1. Radius match — replaces the Pallas TPU kernels
//    vslam_tpu/ops/pallas_matching.py:_radius_kernel (radius_match_pallas)
//    and :_radius_kernel_batched (radius_match_pallas_batched): the
//    single call is the B = 1 case of the batched one. Per member and map row: bf16 dot with every keypoint (f32 accumulate),
//    d = sqrt(max(2 - 2 dot, 0)), masked by keypoint validity, map validity
//    and the pixel radius^2 (exact subtraction, as the TPU kernel does);
//    the row's best keypoint (lowest k on ties) is kept if d < desc_thresh.
//    Per keypoint: the minimum claim, ties to the lowest row. Per map row:
//    the min squared pixel distance to any valid keypoint (found counter).
//
// 2. Top-2 match — replaces vslam_tpu/ops/pallas_matching.py:_match_kernel
//    (top2_match_pallas). Per query: the two smallest distances over valid
//    database rows and the argbest (lowest row on ties; -1 when no row is
//    valid, as the TPU kernel's accumulator leaves it).
//
// What bounds them on an H100: both do 2*M*K*D operations (3.36 GFLOP at
// M=16384, K=400, D=256) over ~8.6 MB of inputs, so the tensor-core bf16
// rate (989 TFLOP/s dense) bounds them at ~3.4 us against ~2.6 us for the
// bytes at 3.35 TB/s; B members of the batched radius match scale both by
// B (13.6 us against 10.5 us at B = 4). The products run on the tensor cores through WMMA
// (16x16x16 bf16 fragments, f32 accumulators); the masking, the row-wise
// best and the top-2 run on the CUDA cores out of shared memory, so no
// (M, K) block ever reaches device memory.
//
// Design: the TPU runs its grid in order and carries an accumulator from
// one map tile to the next; Hopper runs blocks in parallel. So:
//  * radius: a block owns 64 map rows of one member (grid: map tiles x B,
//    every array offset by the member's stride) and loops over that
//    member's keypoints in chunks of 64 held in shared memory, keeping each row's best in
//    registers. Each matched row then does a 64-bit atomicMin of
//    (float bits of d) << 32 | row at its keypoint: d >= 0, so the float
//    bits order like the floats, and the minimum (ties to the lowest row)
//    does not depend on block order. The claims are laid out (B, K) and
//    cleared with one cudaMemsetAsync; a finishing kernel over B * K
//    unpacks them. The TPU kernel loops over members inside each grid
//    step to pay the step latency once; blocks here have no such cost, so
//    the member is a grid dimension.
//  * top-2: 400 queries alone fill too few blocks, so the map is split
//    across blocks; each block writes a partial (best, second, argbest)
//    per query and a merge kernel folds the partials in block order with
//    the TPU kernel's merge rule (strict < keeps the earlier block;
//    second = min(max(b, t), min(s, t2))).
// This is a first, simple version: no TMA, wgmma or pipelining yet.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stdint.h>

using namespace nvcuda;

namespace {

constexpr int TM = 64;        // map rows per block
constexpr int KC = 64;        // keypoints / queries per shared-memory chunk
constexpr int NTHREADS = 128; // 4 warps; warp w computes rows 16w..16w+15
constexpr int LDO = KC + 4;   // leading dimension of the f32 dot tile
constexpr float BIG = 1e9f;

__host__ __device__ inline int ld_desc(int D) { return D + 8; }

inline size_t smem_bytes(int D) {
  return (size_t)(TM + KC) * ld_desc(D) * sizeof(__nv_bfloat16) +
         (size_t)TM * LDO * sizeof(float) + (size_t)KC * 3 * sizeof(float);
}

// Copies `rows` rows of a (n, D) bf16 matrix starting at row0 into shared
// memory with leading dimension D + 8; rows past n are zero.
__device__ inline void load_rows(__nv_bfloat16* dst, const __nv_bfloat16* src,
                                 int row0, int rows, int n, int D) {
  const int vec = D / 8;  // 16-byte vectors per row
  const int ldd = ld_desc(D);
  for (int i = threadIdx.x; i < rows * vec; i += blockDim.x) {
    const int r = i / vec, c = i % vec;
    uint4 v = make_uint4(0u, 0u, 0u, 0u);
    if (row0 + r < n)
      v = reinterpret_cast<const uint4*>(src + (size_t)(row0 + r) * D)[c];
    *reinterpret_cast<uint4*>(dst + r * ldd + c * 8) = v;
  }
}

// s_dot[r][c] = sum_d s_db[r][d] * s_q[c][d] for the block's 64 x 64 tile.
__device__ inline void tile_dots(const __nv_bfloat16* s_db, const __nv_bfloat16* s_q,
                                 float* s_dot, int D) {
  const int w = threadIdx.x / 32;
  const int ldd = ld_desc(D);
  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[KC / 16];
#pragma unroll
  for (int j = 0; j < KC / 16; ++j) wmma::fill_fragment(acc[j], 0.0f);
  for (int kk = 0; kk < D / 16; ++kk) {
    wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, wmma::row_major> a;
    wmma::load_matrix_sync(a, s_db + (16 * w) * ldd + kk * 16, ldd);
#pragma unroll
    for (int j = 0; j < KC / 16; ++j) {
      wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, wmma::col_major> b;
      wmma::load_matrix_sync(b, s_q + (16 * j) * ldd + kk * 16, ldd);
      wmma::mma_sync(acc[j], a, b, acc[j]);
    }
  }
#pragma unroll
  for (int j = 0; j < KC / 16; ++j)
    wmma::store_matrix_sync(s_dot + (16 * w) * LDO + 16 * j, acc[j], LDO,
                            wmma::mem_row_major);
}

__device__ inline float desc_dist(float dot) {
  // 2 - 2 dot is exact up to one rounding (2 dot is exact); the sign bit
  // is cleared so that a -0 never reaches the packed atomicMin.
  return fabsf(sqrtf(fmaxf(__fsub_rn(2.0f, __fmul_rn(2.0f, dot)), 0.0f)));
}

__global__ void __launch_bounds__(NTHREADS)
radius_rows_kernel(const __nv_bfloat16* __restrict__ q, const float* __restrict__ uv_q,
                   const uint8_t* __restrict__ valid_q, int K,
                   const __nv_bfloat16* __restrict__ db, const float* __restrict__ uv_db,
                   const uint8_t* __restrict__ valid_db, int M, int D,
                   float radius2, float desc_thresh,
                   unsigned long long* __restrict__ claim,
                   float* __restrict__ min_pix_d2) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int ldd = ld_desc(D);
  const size_t b = blockIdx.y;  // member
  q += b * K * D;
  uv_q += b * K * 2;
  valid_q += b * K;
  db += b * M * D;
  uv_db += b * M * 2;
  valid_db += b * M;
  claim += b * K;
  min_pix_d2 += b * M;
  __nv_bfloat16* s_db = reinterpret_cast<__nv_bfloat16*>(smem);
  __nv_bfloat16* s_q = s_db + TM * ldd;
  float* s_dot = reinterpret_cast<float*>(s_q + KC * ldd);
  float* s_qu = s_dot + TM * LDO;
  float* s_qv = s_qu + KC;
  float* s_qok = s_qv + KC;

  const int row0 = blockIdx.x * TM;
  load_rows(s_db, db, row0, TM, M, D);

  const int r = threadIdx.x >> 1, half = threadIdx.x & 1;
  const int grow = row0 + r;
  const bool in_range = grow < M;
  const float ru = in_range ? uv_db[2 * grow] : 0.0f;
  const float rv = in_range ? uv_db[2 * grow + 1] : 0.0f;
  const bool row_ok = in_range && valid_db[grow];

  float best_d = BIG, minpix = BIG;
  int best_k = 0x7fffffff;
  for (int k0 = 0; k0 < K; k0 += KC) {
    __syncthreads();  // previous chunk fully consumed
    load_rows(s_q, q, k0, KC, K, D);
    for (int c = threadIdx.x; c < KC; c += blockDim.x) {
      const int k = k0 + c;
      const bool ok = k < K && valid_q[k];
      s_qu[c] = k < K ? uv_q[2 * k] : 0.0f;
      s_qv[c] = k < K ? uv_q[2 * k + 1] : 0.0f;
      s_qok[c] = ok ? 1.0f : 0.0f;
    }
    __syncthreads();
    tile_dots(s_db, s_q, s_dot, D);
    __syncthreads();
    // The two threads of a row take alternate keypoints, each in
    // increasing k, so strict < keeps the lowest k per thread.
    for (int c = half; c < KC && k0 + c < K; c += 2) {
      if (s_qok[c] == 0.0f) continue;
      const float dx = __fsub_rn(ru, s_qu[c]);
      const float dy = __fsub_rn(rv, s_qv[c]);
      const float pd2 = __fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy));
      minpix = fminf(minpix, pd2);
      if (row_ok && pd2 <= radius2) {
        const float d = desc_dist(s_dot[r * LDO + c]);
        if (d < best_d) {
          best_d = d;
          best_k = k0 + c;
        }
      }
    }
  }
  const float od = __shfl_xor_sync(0xffffffffu, best_d, 1);
  const int ok_ = __shfl_xor_sync(0xffffffffu, best_k, 1);
  const float om = __shfl_xor_sync(0xffffffffu, minpix, 1);
  if (od < best_d || (od == best_d && ok_ < best_k)) {
    best_d = od;
    best_k = ok_;
  }
  minpix = fminf(minpix, om);
  if (half == 0 && in_range) {
    min_pix_d2[grow] = minpix;
    if (row_ok && best_d < desc_thresh) {
      const unsigned long long packed =
          ((unsigned long long)__float_as_uint(best_d) << 32) | (unsigned int)grow;
      atomicMin(&claim[best_k], packed);
    }
  }
}

__global__ void radius_finish_kernel(const unsigned long long* __restrict__ claim, int K,
                                     int* __restrict__ mp_idx, uint8_t* __restrict__ kp_ok,
                                     float* __restrict__ dist) {
  const int k = blockIdx.x * blockDim.x + threadIdx.x;
  if (k >= K) return;
  const unsigned long long c = claim[k];
  if (c == ~0ull) {
    dist[k] = BIG;
    mp_idx[k] = -1;
    kp_ok[k] = 0;
  } else {
    const float d = __uint_as_float((unsigned int)(c >> 32));
    const bool ok = d < 0.5f * BIG;
    dist[k] = d;
    kp_ok[k] = ok ? 1 : 0;
    mp_idx[k] = ok ? (int)(c & 0xffffffffull) : -1;
  }
}

__global__ void __launch_bounds__(NTHREADS)
top2_partial_kernel(const __nv_bfloat16* __restrict__ db, const uint8_t* __restrict__ valid_db,
                    int M, const __nv_bfloat16* __restrict__ q, int K, int D,
                    float* __restrict__ part_best, float* __restrict__ part_second,
                    int* __restrict__ part_idx) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int ldd = ld_desc(D);
  __nv_bfloat16* s_db = reinterpret_cast<__nv_bfloat16*>(smem);
  __nv_bfloat16* s_q = s_db + TM * ldd;
  float* s_dot = reinterpret_cast<float*>(s_q + KC * ldd);
  float* s_rok = s_dot + TM * LDO;  // row validity (TM <= 3 * KC floats)

  const int row0 = blockIdx.x * TM;
  load_rows(s_db, db, row0, TM, M, D);
  for (int i = threadIdx.x; i < TM; i += blockDim.x)
    s_rok[i] = (row0 + i < M && valid_db[row0 + i]) ? 1.0f : 0.0f;

  // Thread t serves query column t % KC over rows [32 h, 32 h + 32), h = t / KC.
  const int col = threadIdx.x % KC, h = threadIdx.x / KC;
  for (int k0 = 0; k0 < K; k0 += KC) {
    __syncthreads();
    load_rows(s_q, q, k0, KC, K, D);
    __syncthreads();
    tile_dots(s_db, s_q, s_dot, D);
    __syncthreads();
    float b = BIG, s = BIG;
    int bi = -1;
    const int rbeg = h * (TM / 2);
    for (int rr = rbeg; rr < rbeg + TM / 2; ++rr) {
      const float d = s_rok[rr] != 0.0f ? desc_dist(s_dot[rr * LDO + col]) : BIG;
      if (d < b) {
        s = b;
        b = d;
        bi = row0 + rr;
      } else if (d < s) {
        s = d;
      }
    }
    // Merge the upper half (h = 1) into the lower half (h = 0): lanes
    // col and col + 64 sit in different warps, so go through shared
    // memory (reusing the dot tile, which is consumed by now).
    __syncthreads();
    float* x = s_dot;
    if (h == 1) {
      x[col] = b;
      x[KC + col] = s;
      reinterpret_cast<int*>(x)[2 * KC + col] = bi;
    }
    __syncthreads();
    if (h == 0 && k0 + col < K) {
      const float tb = x[col], ts = x[KC + col];
      const int ti = reinterpret_cast<int*>(x)[2 * KC + col];
      const float nb = fminf(b, tb);
      const int ni = tb < b ? ti : bi;
      const float ns = fminf(fmaxf(b, tb), fminf(s, ts));
      const size_t o = (size_t)blockIdx.x * K + k0 + col;
      part_best[o] = nb;
      part_second[o] = ns;
      part_idx[o] = ni;
    }
  }
}

__global__ void top2_merge_kernel(const float* __restrict__ part_best,
                                  const float* __restrict__ part_second,
                                  const int* __restrict__ part_idx, int nblocks, int K,
                                  float* __restrict__ d1, float* __restrict__ d2,
                                  int* __restrict__ idx) {
  const int k = blockIdx.x * blockDim.x + threadIdx.x;
  if (k >= K) return;
  float b = BIG, s = BIG;
  int bi = -1;
  for (int j = 0; j < nblocks; ++j) {
    const size_t o = (size_t)j * K + k;
    const float tb = part_best[o], ts = part_second[o];
    const int ti = part_idx[o];
    const float nb = fminf(b, tb);
    const int ni = tb < b ? ti : bi;
    s = fminf(fmaxf(b, tb), fminf(s, ts));
    b = nb;
    bi = ni;
  }
  d1[k] = b;
  d2[k] = s;
  idx[k] = bi;
}

}  // namespace

extern "C" {

// Radius match of B members. claim_scratch holds B * K uint64; outputs:
// mp_idx (B, K) int32, kp_ok (B, K) uint8, dist (B, K) f32, min_pix_d2
// (B, M) f32; inputs carry the member as their leading dimension.
// Returns a cudaError_t.
int vslam_radius_match(const void* q, const void* uv_q, const void* valid_q, int K,
                       const void* db, const void* uv_db, const void* valid_db, int M,
                       int D, int B, float radius2, float desc_thresh, void* claim_scratch,
                       void* mp_idx, void* kp_ok, void* dist, void* min_pix_d2,
                       void* stream) {
  if (D % 16 != 0 || K < 0 || M < 0 || B < 0 || B > 65535) return (int)cudaErrorInvalidValue;
  if (B == 0) return (int)cudaSuccess;
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  const size_t smem = smem_bytes(D);
  cudaError_t err = cudaFuncSetAttribute(
      radius_rows_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const size_t nclaim = (size_t)B * K;
  // Every claim starts as ~0 (no row), which loses every atomicMin.
  if (nclaim > 0 &&
      (err = cudaMemsetAsync(claim_scratch, 0xFF, nclaim * 8, st)) != cudaSuccess)
    return (int)err;
  if (M > 0) {
    const dim3 grid((M + TM - 1) / TM, B);
    radius_rows_kernel<<<grid, NTHREADS, smem, st>>>(
        static_cast<const __nv_bfloat16*>(q), static_cast<const float*>(uv_q),
        static_cast<const uint8_t*>(valid_q), K, static_cast<const __nv_bfloat16*>(db),
        static_cast<const float*>(uv_db), static_cast<const uint8_t*>(valid_db), M, D,
        radius2, desc_thresh, static_cast<unsigned long long*>(claim_scratch),
        static_cast<float*>(min_pix_d2));
    if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  }
  if (nclaim > 0) {
    radius_finish_kernel<<<(int)((nclaim + 255) / 256), 256, 0, st>>>(
        static_cast<const unsigned long long*>(claim_scratch), (int)nclaim,
        static_cast<int*>(mp_idx), static_cast<uint8_t*>(kp_ok), static_cast<float*>(dist));
    if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  }
  return (int)cudaSuccess;
}

// Number of map-row blocks the top-2 kernel splits M into (the partial
// scratch holds that many rows of K floats / ints each).
int vslam_top2_num_blocks(int M) { return (M + TM - 1) / TM; }

// Top-2 match. part_* scratch: vslam_top2_num_blocks(M) * K entries each;
// outputs: d1, d2 (K) f32, idx (K) int32. Returns a cudaError_t.
int vslam_top2_match(const void* db, const void* valid_db, int M, const void* q, int K,
                     int D, void* part_best, void* part_second, void* part_idx, void* d1,
                     void* d2, void* idx, void* stream) {
  if (D % 16 != 0 || K < 0 || M < 0) return (int)cudaErrorInvalidValue;
  if (K == 0) return (int)cudaSuccess;
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  const size_t smem = smem_bytes(D);
  cudaError_t err = cudaFuncSetAttribute(
      top2_partial_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const int nb = vslam_top2_num_blocks(M);
  if (nb > 0) {
    top2_partial_kernel<<<nb, NTHREADS, smem, st>>>(
        static_cast<const __nv_bfloat16*>(db), static_cast<const uint8_t*>(valid_db), M,
        static_cast<const __nv_bfloat16*>(q), K, D, static_cast<float*>(part_best),
        static_cast<float*>(part_second), static_cast<int*>(part_idx));
    if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  }
  top2_merge_kernel<<<(K + 127) / 128, 128, 0, st>>>(
      static_cast<const float*>(part_best), static_cast<const float*>(part_second),
      static_cast<const int*>(part_idx), nb, K, static_cast<float*>(d1),
      static_cast<float*>(d2), static_cast<int*>(idx));
  return (int)cudaGetLastError();
}

}  // extern "C"
