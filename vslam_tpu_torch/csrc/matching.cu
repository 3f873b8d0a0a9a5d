// Descriptor-matching kernels for Hopper (sm_90a), bound through a plain C
// interface (loaded with ctypes by vslam_tpu_torch/ops/cuda_matching.py).
//
// 1. Radius match — replaces the Pallas TPU kernels
//    vslam_tpu/ops/pallas_matching.py:_radius_kernel (radius_match_pallas)
//    and :_radius_kernel_batched (radius_match_pallas_batched); the single
//    call is the B = 1 case of the batched one. Per member and map row: the
//    min squared pixel distance to any valid keypoint (found counter); for
//    a valid row, its best keypoint among the valid ones within the pixel
//    radius (d = sqrt(max(2 - 2 dot, 0)) of the bf16 descriptors, f32
//    sums; lowest k on ties), kept if d < desc_thresh. Per keypoint: the
//    minimum claim, ties to the lowest row.
//
//    What bounds it: the outputs depend only on the pairs that pass the
//    validity and radius gates, so the least work is the input's own
//    floor: every row's and keypoint's pixels and validity, the
//    descriptors of the rows and keypoints that have a candidate pair,
//    the outputs, and 2 D operations per candidate pair. On the tracking
//    path a 12 px disc covers ~0.15% of a 640x480 image, so a visible row
//    has about one candidate and that floor is bytes, under a microsecond
//    at 3.35 TB/s (chip_smoke.py's radius_work counts it for each timed
//    input) — far below the M x K x D product (3.4 us at the bf16
//    tensor-core rate) that a dense tile product pays.
//
//    Design: one cooperative launch (no memset, no finish kernel), its
//    persistent grid sized from the SM count x occupancy (queried once per
//    process by the wrapper). Phase 1 clears the (B, K) claims, phase 2
//    walks work items (member, 64 map rows) in a grid-stride loop, phase 3
//    unpacks the claims; grid.sync() separates them. In phase 2 a block
//    stages its member's keypoint pixels in shared memory (an invalid
//    keypoint as NaN, which fminf skips and the radius test rejects, as
//    skipping it would) and the item's rows' projections and validity.
//    Pixel pass: thread t takes row t % 64 against a quarter of the
//    keypoints (read as broadcasts), computes the squared pixel distance
//    by exact subtraction (the TPU kernel's formula, rounded step by
//    step), keeps a running min (merged per row with an integer atomicMin
//    of the float bits, exact in any order) and sets the candidates' bits
//    in a mask in shared memory, counted per chunk of 64 keypoints.
//    Only a candidate reads descriptors. A dense chunk (at least
//    DENSE_PAIRS pairs, as when every row lies within radius of every
//    keypoint) takes one tensor-core tile product (WMMA, bf16 in, f32 out,
//    straight from device memory); a partial one (the map's last rows, the
//    last keypoints) takes a tile shifted back inside the inputs and reads
//    only its own pairs. Every other candidate goes to the CUDA cores: a
//    warp walks a row's candidate bits, 8 lanes a pair (4 pairs at once):
//    lane j dots 16-byte vectors j, j + 8, ... of the row's and the
//    keypoint's descriptor in f32 in element order and a butterfly over
//    the 8 lanes sums them (every lane ends with the same bits), so a
//    pair's distance does not depend on which group takes it. Each pair then
//    offers (float bits of d) << 32 | k to its row with a shared-memory
//    64-bit atomicMin: the least d, ties to the lowest k, in any order. A
//    row that is invalid or has no candidate reads no descriptor byte. A
//    matched row (d < desc_thresh) does a 64-bit atomicMin of (float bits
//    of d) << 32 | row at its keypoint: d >= 0, so the float bits order
//    like the floats, and the minimum (ties to the lowest row) does not
//    depend on block order; the batched call equals B single calls bit for
//    bit. Inputs reach the kernel as per-member base pointers (a kernel
//    parameter of up to MAX_MEMBERS pointers per input), so the members'
//    maps need not be stacked.
//
// 2. Top-2 match — replaces vslam_tpu/ops/pallas_matching.py:_match_kernel
//    (top2_match_pallas). Per query: the two smallest distances
//    d = sqrt(max(2 - 2 dot, 0)) over valid database rows and the argbest
//    (lowest row on ties; d2 == d1 when two rows tie at the best; -1 and
//    d1 = d2 = 1e9 when no row is valid, as the TPU kernel's accumulator
//    leaves it).
//
//    What bounds it on an H100: 2*M*K*D operations (3.36 GFLOP at M=16384,
//    K=400, D=256) over ~8.6 MB of inputs, so the tensor-core bf16 rate
//    (989 TFLOP/s dense) bounds it at ~3.4 us against ~2.6 us for the
//    bytes at 3.35 TB/s. An invalid row never changes the result, so the
//    input's own floor counts the valid rows only.
//
//    Design: the TPU runs its grid in order and carries an accumulator
//    from one map tile to the next; Hopper runs blocks in parallel. One
//    cooperative launch (no memset, no second kernel), its grid the SM
//    count x this kernel's occupancy at its own shared-memory size
//    (queried once per device by the wrapper). Phase 1 walks work items
//    (query chunk of T_QC = 80, map split): a block loads its chunk into
//    shared memory once and walks its split's 64-row map tiles (split s of
//    S takes tiles s, s + S, ..., so the valid low slots of a real map
//    spread over all blocks). Each warp reads a tile's 64 validity bytes
//    and ballots, and passes over a tile with no valid row before its
//    descriptors are loaded. Live tiles are double-buffered with
//    16-byte cp.async copies, so the next tile's load overlaps this tile's
//    product. The product runs on the tensor cores through WMMA (16x16x16
//    bf16 fragments, f32 accumulators, d ascending in steps of 16: the
//    k-order of the earlier two-kernel version, so the dots keep their
//    bits) into an f32 tile in shared memory; each thread then scans a
//    quarter of the rows of one query column, keeping its running (best,
//    second, argbest) in registers across all the block's tiles. It takes
//    a row's distance only when the dot reaches the dot of its current
//    second (d falls as the dot rises, so a lower dot cannot enter the top
//    2), and compares distances, not dots, so that dots that round to one
//    distance tie and the lowest row wins. A column's four thread partials
//    are merged once, at the end, and the block writes one partial per
//    query. After grid.sync(), phase 2 gives each query a warp, anywhere
//    in the grid, that folds its S partials. Every merge is order-free:
//    the best as a packed (float bits of d) << 32 | row (the least d, then
//    the lowest row), the second as min(max(b, tb), min(s, ts)), which is
//    symmetric. No (M, K) block ever reaches device memory.
//
//    Shared memory: (80 + 2 x 64) (D + 8) x 2 B + 64 x 84 x 4 B, 131 KB at
//    D = 256. An H100 gives a block at most 227 KB, so D <= 496: past it
//    vslam_top2_max_grid returns an error and the wrapper raises.

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_pipeline.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stdint.h>

using namespace nvcuda;
namespace cg = cooperative_groups;

namespace {

constexpr float BIG = 1e9f;
constexpr unsigned int FULL = 0xffffffffu;

// Leading dimension (elements) of a bf16 descriptor row in shared memory:
// 8 elements of padding keep the rows of a tensor-core fragment load on
// distinct banks.
__host__ __device__ inline int ld_desc(int D) { return D + 8; }

__device__ inline float desc_dist(float dot) {
  // 2 - 2 dot is exact up to one rounding (2 dot is exact); the sign bit
  // is cleared so that a -0 never reaches the packed atomicMin.
  return fabsf(sqrtf(fmaxf(__fsub_rn(2.0f, __fmul_rn(2.0f, dot)), 0.0f)));
}

// (float bits of d) << 32 | k: d >= 0, so the minimum is the least d and,
// among equal d, the lowest k, whatever order the candidates come in.
__device__ inline unsigned long long pack_dk(float d, int k) {
  return ((unsigned long long)__float_as_uint(d) << 32) | (unsigned int)k;
}

// ---- radius match -------------------------------------------------------

constexpr int MAX_MEMBERS = 64;  // members per launch (pointers per input)
constexpr int RT = 64;           // map rows per work item
constexpr int R_THREADS = 256;   // 8 warps; warp w owns rows w, w + 8, ... of an item
constexpr int R_WARPS = R_THREADS / 32;
constexpr int R_KS = 1024;       // keypoints per pass: pixels (8 KB), candidate masks (8 KB)
constexpr int R_KW = R_KS / 32;  // mask words per row and pass
constexpr int R_KC = 64;         // keypoints per chunk (the dense tile's width)
constexpr int R_NCH = R_KS / R_KC;
constexpr int R_LDO = R_KC + 4;  // leading dimension of a dense chunk's f32 dot tile
// A 64-row x 64-keypoint chunk with at least DENSE_PAIRS candidate pairs
// takes the tensor-core tile product instead of one dot per pair. A pair's
// dot reads ~1 KB of descriptors (the keypoint's 512 B from L2, the row's
// from L1), so at 64 pairs the dots read as much as the tile product's two
// 64 x 256 bf16 operands (64 KB), and past it they cost more. On the
// tracking path a chunk holds ~3 pairs; in the dense case (every pair in
// radius) 4,096.
constexpr int DENSE_PAIRS = 64;
constexpr int R_GROUP = 8;       // lanes per CUDA-core pair: 4 pairs per warp at once

// Per-member base pointers (a kernel parameter: 3 KB at MAX_MEMBERS = 64).
struct RadiusMembers {
  const uint4* q[MAX_MEMBERS];         // (K, D) bf16 as 16-byte vectors
  const float2* uv_q[MAX_MEMBERS];     // (K,) pixels
  const uint8_t* valid_q[MAX_MEMBERS]; // (K,)
  const uint4* db[MAX_MEMBERS];        // (M, D) bf16
  const float2* uv_db[MAX_MEMBERS];    // (M,) projections
  const uint8_t* valid_db[MAX_MEMBERS];// (M,)
};

// Squared pixel distance by exact subtraction, rounded step by step (no
// contraction into an FMA), as the TPU kernel computes it.
__device__ inline float pix_d2(float2 r, float2 p) {
  const float dx = __fsub_rn(r.x, p.x);
  const float dy = __fsub_rn(r.y, p.y);
  return __fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy));
}

// Keypoint k's pixels, or NaN for an invalid keypoint: every distance to
// it is then NaN, which fminf skips and `<= radius2` rejects — exactly
// what skipping the keypoint gives.
__device__ inline float2 kp_uv(const float2* uv_q, const uint8_t* valid_q, int k) {
  const float nan = __int_as_float(0x7fc00000);
  return valid_q[k] ? uv_q[k] : make_float2(nan, nan);
}

// acc + the dot of 8 bf16 pairs, in element order (a bf16 product is exact
// in f32, so each step rounds once, at the add).
__device__ inline float dot8(float acc, uint4 a, uint4 b) {
  const unsigned int av[4] = {a.x, a.y, a.z, a.w};
  const unsigned int bv[4] = {b.x, b.y, b.z, b.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    acc = fmaf(__uint_as_float(av[i] << 16), __uint_as_float(bv[i] << 16), acc);
    acc = fmaf(__uint_as_float(av[i] & 0xffff0000u), __uint_as_float(bv[i] & 0xffff0000u), acc);
  }
  return acc;
}

__global__ void __launch_bounds__(R_THREADS)
radius_match_kernel(const __grid_constant__ RadiusMembers in, int B, int K, int M, int D,
                    float radius2, float desc_thresh, unsigned long long* __restrict__ claim,
                    int* __restrict__ mp_idx, uint8_t* __restrict__ kp_ok,
                    float* __restrict__ dist, float* __restrict__ min_pix_d2) {
  __shared__ float2 s_uv[R_KS];
  // Candidate bits, row x keypoint of the pass (one pad word per row keeps
  // the rows of a warp on distinct banks).
  __shared__ unsigned int s_mask[RT][R_KW + 1];
  __shared__ int s_cnt[R_NCH];               // candidate pairs per chunk
  __shared__ unsigned long long s_best[RT];  // per row: pack_dk of its best candidate
  // Per row: min squared pixel distance, as float bits (>= +0, never NaN,
  // so the unsigned order is the float order).
  __shared__ unsigned int s_min[RT];
  __shared__ float2 s_ruv[RT];               // the item's rows' projections
  __shared__ bool s_rok[RT];                 // and validity
  __shared__ __align__(32) float s_dot[RT * R_LDO];  // a dense chunk's dot tile
  cg::grid_group grid = cg::this_grid();
  const int nclaim = B * K;
  const int gtid = blockIdx.x * R_THREADS + threadIdx.x;
  const int gstride = gridDim.x * R_THREADS;

  // Phase 1: every claim starts as ~0 (no row), which loses every atomicMin.
  for (int i = gtid; i < nclaim; i += gstride) claim[i] = ~0ull;
  grid.sync();

  // Phase 2: work items (member, 64 map rows).
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int nvec = D / 8;  // 16-byte vectors per descriptor
  const int tiles = (M + RT - 1) / RT;
  const bool tiles_fit = M >= RT && K >= R_KC;  // a 64 x 64 tile fits inside the inputs
  int staged = -1;  // member whose keypoint pixels s_uv holds (when K <= R_KS)
  for (int item = blockIdx.x; item < B * tiles; item += gridDim.x) {
    const int b = item / tiles;
    const int row0 = (item - b * tiles) * RT;
    const int nrows = min(RT, M - row0);
    const float2* uv_q = in.uv_q[b];
    const uint8_t* valid_q = in.valid_q[b];
    const uint4* q = in.q[b];
    const uint4* db = in.db[b];
    __syncthreads();  // the block is done with the previous item
    if (threadIdx.x < RT) {
      s_best[threadIdx.x] = ~0ull;
      s_min[threadIdx.x] = __float_as_uint(BIG);
      if (threadIdx.x < nrows) {
        s_ruv[threadIdx.x] = in.uv_db[b][row0 + threadIdx.x];
        s_rok[threadIdx.x] = in.valid_db[b][row0 + threadIdx.x] != 0;
      }
    }
    for (int ks = 0; ks < K; ks += R_KS) {  // one pass unless K > R_KS
      const int kn = min(R_KS, K - ks);
      const int nw = (kn + 31) / 32;
      if (ks > 0) __syncthreads();  // the block is done with the previous pass
      if (K > R_KS || b != staged) {  // block-uniform
        for (int c = threadIdx.x; c < kn; c += R_THREADS) s_uv[c] = kp_uv(uv_q, valid_q, ks + c);
        staged = b;
      }
      if (threadIdx.x < R_NCH) s_cnt[threadIdx.x] = 0;
      __syncthreads();

      // Pixel pass: thread t takes row t % 64 against mask words
      // t / 64, t / 64 + 4, ... (32 keypoints each, read as broadcasts).
      {
        const int r = threadIdx.x % RT, part = threadIdx.x / RT;
        const bool live = r < nrows;
        const float2 ruv = live ? s_ruv[r] : make_float2(0.0f, 0.0f);
        const bool row_ok = live && s_rok[r];
        float mp = BIG;
        for (int w = part; w < nw; w += R_THREADS / RT) {  // warp-uniform
          const int cbase = w * 32, cn = min(32, kn - cbase);
          unsigned int bits = 0u;
#pragma unroll 8
          for (int j = 0; j < cn; ++j) {
            const float d2 = pix_d2(ruv, s_uv[cbase + j]);
            mp = fminf(mp, d2);
            bits |= (row_ok && d2 <= radius2) ? (1u << j) : 0u;
          }
          if (live) s_mask[r][w] = bits;
          const unsigned int n = __reduce_add_sync(FULL, __popc(bits));
          if (lane == 0 && n != 0u) atomicAdd(&s_cnt[w / 2], (int)n);
        }
        if (live) atomicMin(&s_min[r], __float_as_uint(mp));
      }
      __syncthreads();

      // One predicate sends a chunk to the tensor cores (block-uniform: it
      // reads only shared counts); the CUDA-core pass below takes every
      // candidate of every other chunk.
      auto tensor_chunk = [&](int c) { return tiles_fit && s_cnt[c] >= DENSE_PAIRS; };

      // Tensor-core chunks: one 64 x 64 dot tile (bf16 in, f32 out),
      // straight from the descriptors in device memory; warp w takes tile
      // rows 16 (w % 4).. and tile keypoints 32 (w / 4).. A tile always
      // lies inside the map and the keypoints: the item's last rows
      // (M % 64) and the last chunk's keypoints (K % 64) are covered by a
      // tile shifted back to end at row M / keypoint K, of which only the
      // chunk's own pairs are read.
      const int t0 = min(row0, M - RT);  // the tile's first map row
      for (int c = 0; c * R_KC < kn; ++c) {
        if (!tensor_chunk(c)) continue;
        const int c0 = c * R_KC;
        const int cs = min(c0, kn - R_KC);  // the tile's first keypoint in the pass (>= -ks)
        const int rg = warp & 3, ch = warp >> 2;
        const __nv_bfloat16* A =
            reinterpret_cast<const __nv_bfloat16*>(db) + (size_t)(t0 + 16 * rg) * D;
        const __nv_bfloat16* Bq =
            reinterpret_cast<const __nv_bfloat16*>(q) + (size_t)(ks + cs + 32 * ch) * D;
        wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[2];
        wmma::fill_fragment(acc[0], 0.0f);
        wmma::fill_fragment(acc[1], 0.0f);
        for (int kk = 0; kk < D / 16; ++kk) {
          wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, wmma::row_major> fa;
          wmma::load_matrix_sync(fa, A + kk * 16, D);
#pragma unroll
          for (int j = 0; j < 2; ++j) {
            wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, wmma::col_major> fb;
            wmma::load_matrix_sync(fb, Bq + (size_t)(16 * j) * D + kk * 16, D);
            wmma::mma_sync(acc[j], fa, fb, acc[j]);
          }
        }
        __syncthreads();  // the previous dense chunk's tile is consumed
#pragma unroll
        for (int j = 0; j < 2; ++j)
          wmma::store_matrix_sync(s_dot + (16 * rg) * R_LDO + 32 * ch + 16 * j, acc[j], R_LDO,
                                  wmma::mem_row_major);
        __syncthreads();
        for (int r = warp; r < nrows; r += R_WARPS) {
          const int i = row0 + r - t0;  // the item's row r in the tile
          unsigned long long best = ~0ull;
#pragma unroll
          for (int h = 0; h < R_KC / 32; ++h) {
            const int j = lane + 32 * h;
            const int kc = cs + j;  // keypoint in the pass; the chunk's own from c0 on
            if (kc >= c0 && ((s_mask[r][kc >> 5] >> (kc & 31)) & 1u)) {
              const unsigned long long o = pack_dk(desc_dist(s_dot[i * R_LDO + j]), ks + kc);
              best = o < best ? o : best;
            }
          }
          if (best != ~0ull) atomicMin(&s_best[r], best);
        }
      }

      // CUDA-core pairs: warp w walks rows w, w + 8, ...; lane j holds the
      // row's mask word j (R_KW = 32 words), and the row's candidates go 4
      // at a time, 8 lanes each. Lane l of a group dots vectors l, l + 8,
      // ... of the row's and the keypoint's descriptor in element order,
      // and a butterfly over the group sums them (a + b == b + a, so every
      // lane ends with the same bits): the same order for a pair whichever
      // group takes it.
      const int g = lane / R_GROUP, gl = lane % R_GROUP;
      for (int r = warp; r < nrows; r += R_WARPS) {
        const unsigned int word = lane < nw && !tensor_chunk(lane / 2) ? s_mask[r][lane] : 0u;
        const uint4* rd = db + (size_t)(row0 + r) * nvec;
        for (unsigned int words = __ballot_sync(FULL, word != 0u); words != 0u;
             words &= words - 1u) {
          const int w = __ffs(words) - 1;
          for (unsigned int bits = __shfl_sync(FULL, word, w); bits != 0u;) {
            unsigned int mine = bits;  // group g takes the g-th lowest candidate left
            for (int i = 0; i < g; ++i) mine &= mine - 1u;
            const int c = w * 32 + __ffs(mine) - 1;
            float acc = 0.0f;
            if (mine != 0u) {
              const uint4* qk = q + (size_t)(ks + c) * nvec;
              for (int v = gl; v < nvec; v += R_GROUP) acc = dot8(acc, rd[v], qk[v]);
            }
#pragma unroll
            for (int o = R_GROUP / 2; o > 0; o >>= 1) acc += __shfl_xor_sync(FULL, acc, o);
            if (mine != 0u && gl == 0) atomicMin(&s_best[r], pack_dk(desc_dist(acc), ks + c));
#pragma unroll
            for (int i = 0; i < 32 / R_GROUP; ++i) bits &= bits - 1u;
          }
        }
      }
    }
    __syncthreads();

    if (threadIdx.x < nrows) {
      const int row = row0 + threadIdx.x;
      min_pix_d2[(size_t)b * M + row] = __uint_as_float(s_min[threadIdx.x]);
      const unsigned long long best = s_best[threadIdx.x];
      const float d = __uint_as_float((unsigned int)(best >> 32));
      if (best != ~0ull && d < desc_thresh)  // only a valid row has a candidate
        atomicMin(&claim[(size_t)b * K + (int)(best & 0xffffffffull)],
                  pack_dk(d, row));
    }
  }
  grid.sync();

  // Phase 3: unpack the claims (read from L2, where the atomics landed).
  for (int i = gtid; i < nclaim; i += gstride) {
    const unsigned long long c = __ldcg(&claim[i]);
    if (c == ~0ull) {
      dist[i] = BIG;
      mp_idx[i] = -1;
      kp_ok[i] = 0;
    } else {
      const float d = __uint_as_float((unsigned int)(c >> 32));
      const bool ok = d < 0.5f * BIG;
      dist[i] = d;
      kp_ok[i] = ok ? 1 : 0;
      mp_idx[i] = ok ? (int)(c & 0xffffffffull) : -1;
    }
  }
}

// ---- top-2 match --------------------------------------------------------

constexpr int T_ROWS = 64;  // map rows per tile
constexpr int T_QC = 80;    // queries per resident chunk: 5 fragments of 16 (K = 400 is 5 chunks)
constexpr int T_QF = T_QC / 16;
constexpr int T_RF = 2;     // row fragments per warp: warp w takes query fragment w % 5
                            // and row fragments 2 (w / 5), 2 (w / 5) + 1 of a tile
constexpr int T_WARPS = T_ROWS / 16 / T_RF * T_QF;  // 10
constexpr int T_THREADS = 32 * T_WARPS;
constexpr int T_PARTS = T_THREADS / T_QC;  // scan threads per query column
constexpr int T_LDO = T_QC + 4;            // leading dimension of the f32 dot tile
static_assert(T_THREADS % T_QC == 0 && T_ROWS % T_PARTS == 0, "scan layout");
static_assert(T_PARTS * T_QC * 12 <= T_ROWS * T_LDO * 4, "the partials fit in the dot tile");

// Shared memory: the query chunk, two map tiles, the f32 dot tile.
inline size_t top2_smem_bytes(int D) {
  return (size_t)(T_QC + 2 * T_ROWS) * ld_desc(D) * sizeof(__nv_bfloat16) +
         (size_t)T_ROWS * T_LDO * sizeof(float);
}

// Starts copying rows [row0, row0 + rows) of a (n, D) bf16 matrix into
// shared memory (leading dimension D + 8) as 16-byte cp.async copies;
// rows at or past n are zeroed. The caller commits the group.
__device__ inline void load_rows_async(__nv_bfloat16* dst, const __nv_bfloat16* src,
                                       int row0, int rows, int n, int D) {
  const int vec = D / 8;  // 16-byte vectors per row
  const int ldd = ld_desc(D);
  for (int i = threadIdx.x; i < rows * vec; i += blockDim.x) {
    const int r = i / vec, c = i - r * vec;
    __nv_bfloat16* d = dst + r * ldd + c * 8;
    if (row0 + r < n)
      __pipeline_memcpy_async(d, src + (size_t)(row0 + r) * D + c * 8, 16);
    else
      *reinterpret_cast<uint4*>(d) = make_uint4(0u, 0u, 0u, 0u);
  }
}

// s_dot[r][c] = sum_d s_db[r][d] * s_q[c][d] over the 64 x T_QC tile:
// WMMA 16x16x16 fragments, bf16 in, f32 accumulators, d ascending in steps
// of 16. A warp whose query fragment lies at or past kn (the chunk's
// queries) skips it: those columns are never read.
__device__ inline void tile_dots(const __nv_bfloat16* s_db, const __nv_bfloat16* s_q,
                                 float* s_dot, int D, int kn) {
  const int w = threadIdx.x / 32;
  const int cf = w % T_QF, rf = (w / T_QF) * T_RF;
  if (16 * cf >= kn) return;
  const int ldd = ld_desc(D);
  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[T_RF];
#pragma unroll
  for (int j = 0; j < T_RF; ++j) wmma::fill_fragment(acc[j], 0.0f);
#pragma unroll 4
  for (int kk = 0; kk < D / 16; ++kk) {
    wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, wmma::col_major> b;
    wmma::load_matrix_sync(b, s_q + (16 * cf) * ldd + kk * 16, ldd);
#pragma unroll
    for (int j = 0; j < T_RF; ++j) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, wmma::row_major> a;
      wmma::load_matrix_sync(a, s_db + (16 * (rf + j)) * ldd + kk * 16, ldd);
      wmma::mma_sync(acc[j], a, b, acc[j]);
    }
  }
#pragma unroll
  for (int j = 0; j < T_RF; ++j)
    wmma::store_matrix_sync(s_dot + (16 * (rf + j)) * T_LDO + 16 * cf, acc[j], T_LDO,
                            wmma::mem_row_major);
}

// The first tile of the split's sequence t, t + S, ... that has a valid
// row, or ntiles; *bits gets its validity (bit r: row 64 t + r). A warp
// reads a tile's 64 validity bytes (two a lane) and ballots, so a tile
// with no valid row is passed over before a descriptor byte is read; no
// byte at or past M is read.
__device__ inline int next_live_tile(const uint8_t* __restrict__ valid, int M, int ntiles,
                                     int t, int S, unsigned long long* bits) {
  const int lane = threadIdx.x & 31;
  for (; t < ntiles; t += S) {
    const int r = t * T_ROWS + lane;
    const unsigned int lo = __ballot_sync(FULL, r < M && valid[r]);
    const unsigned int hi = __ballot_sync(FULL, r + 32 < M && valid[r + 32]);
    if (lo | hi) {
      *bits = (unsigned long long)hi << 32 | lo;
      return t;
    }
  }
  return ntiles;
}

__device__ inline float key_dist(unsigned long long key) {
  return __uint_as_float((unsigned int)(key >> 32));
}

// Folds a partial (key t, second ts) into (key, s): the lesser packed
// (d, row) key, and the second smallest of the four distances. Exact and
// symmetric, so any order of folds gives the same bits.
__device__ inline void top2_fold(unsigned long long& key, float& s, unsigned long long t,
                                 float ts) {
  s = fminf(fmaxf(key_dist(key), key_dist(t)), fminf(s, ts));
  key = t < key ? t : key;
}

__global__ void __launch_bounds__(T_THREADS, 1)
top2_match_kernel(const __nv_bfloat16* __restrict__ db, const uint8_t* __restrict__ valid_db,
                  int M, const __nv_bfloat16* __restrict__ q, int K, int D, int S,
                  unsigned long long* __restrict__ part_key, float* __restrict__ part_s,
                  float* __restrict__ d1, float* __restrict__ d2, int* __restrict__ idx) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int ldd = ld_desc(D);
  __nv_bfloat16* s_q = reinterpret_cast<__nv_bfloat16*>(smem);
  __nv_bfloat16* s_db = s_q + T_QC * ldd;  // two tiles
  float* s_dot = reinterpret_cast<float*>(s_db + 2 * T_ROWS * ldd);
  cg::grid_group grid = cg::this_grid();
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int col = threadIdx.x % T_QC, part = threadIdx.x / T_QC;
  const int ntiles = (M + T_ROWS - 1) / T_ROWS;
  const int nchunks = (K + T_QC - 1) / T_QC;

  // Phase 1: work items (query chunk, map split) -> one partial per query
  // and split, laid out (K, S).
  for (int item = blockIdx.x; item < nchunks * S; item += gridDim.x) {
    const int chunk = item / S, split = item - chunk * S;
    const int k0 = chunk * T_QC, kn = min(T_QC, K - k0);
    __syncthreads();  // the block is done with the previous item's shared memory
    unsigned long long bits;
    int t = next_live_tile(valid_db, M, ntiles, split, S, &bits);
    if (t < ntiles) {
      load_rows_async(s_q, q, k0, T_QC, K, D);
      load_rows_async(s_db, db, t * T_ROWS, T_ROWS, M, D);
    }
    __pipeline_commit();
    float b = BIG, s = BIG;                   // running best and second distance
    float bdot = -INFINITY, thr = -INFINITY;  // their dots: a dot below thr cannot enter
    int bi = -1;
    for (int buf = 0; t < ntiles; buf ^= 1) {
      unsigned long long nbits;
      const int tn = next_live_tile(valid_db, M, ntiles, t + S, S, &nbits);
      if (tn < ntiles)  // the other buffer was last read before the previous tile's scan
        load_rows_async(s_db + (buf ^ 1) * T_ROWS * ldd, db, tn * T_ROWS, T_ROWS, M, D);
      __pipeline_commit();
      __pipeline_wait_prior(1);  // this tile (and the queries) have landed
      __syncthreads();
      tile_dots(s_db + buf * T_ROWS * ldd, s_q, s_dot, D, kn);
      __syncthreads();
      if (col < kn) {
        // Rows part, part + T_PARTS, ... ascending, so the strict < keeps
        // the lowest row among equal distances.
        const unsigned long long mb = bits >> part;
        const float* x = s_dot + part * T_LDO + col;
#pragma unroll
        for (int i = 0; i < T_ROWS / T_PARTS; ++i) {
          const float dot = x[i * T_PARTS * T_LDO];
          if (((mb >> (T_PARTS * i)) & 1ull) && dot >= thr) {
            const float d = desc_dist(dot);
            if (d < b) {
              s = b;
              thr = bdot;
              b = d;
              bdot = dot;
              bi = t * T_ROWS + part + T_PARTS * i;
            } else if (d < s) {
              s = d;
              thr = dot;
            }
          }
        }
      }
      t = tn;
      bits = nbits;
    }
    __pipeline_wait_prior(0);
    __syncthreads();  // the dot tile is consumed: it now holds the column partials
    unsigned long long* s_key = reinterpret_cast<unsigned long long*>(s_dot);
    float* s_sec = reinterpret_cast<float*>(s_key + T_PARTS * T_QC);
    s_key[part * T_QC + col] = pack_dk(b, bi);  // no valid row: (BIG, 0xffffffff)
    s_sec[part * T_QC + col] = s;
    __syncthreads();
    if (part == 0 && col < kn) {
      unsigned long long key = s_key[col];
      float sec = s_sec[col];
#pragma unroll
      for (int p = 1; p < T_PARTS; ++p) top2_fold(key, sec, s_key[p * T_QC + col], s_sec[p * T_QC + col]);
      const size_t o = (size_t)(k0 + col) * S + split;
      part_key[o] = key;
      part_s[o] = sec;
    }
  }
  grid.sync();

  // Phase 2: a warp per query folds its S partials (read from L2, where
  // the other blocks wrote them), then a butterfly over the lanes.
  for (int k = blockIdx.x * T_WARPS + warp; k < K; k += gridDim.x * T_WARPS) {
    unsigned long long key = pack_dk(BIG, -1);
    float s = BIG;
    for (int p = lane; p < S; p += 32)
      top2_fold(key, s, __ldcg(&part_key[(size_t)k * S + p]), __ldcg(&part_s[(size_t)k * S + p]));
#pragma unroll
    for (int o = 16; o > 0; o >>= 1)
      top2_fold(key, s, __shfl_xor_sync(FULL, key, o), __shfl_xor_sync(FULL, s, o));
    if (lane == 0) {
      d1[k] = key_dist(key);
      d2[k] = s;
      idx[k] = (int)(unsigned int)(key & 0xffffffffull);
    }
  }
}

}  // namespace

extern "C" {

// Largest grid of the radius kernel that is co-resident on `device` (the
// SM count x blocks per SM), or -cudaError_t. The wrapper queries it once
// per device and passes it to every launch. The calling thread's current
// device is the same before and after.
int vslam_radius_max_grid(int device) {
  int sms = 0, per_sm = 0, current = 0;
  cudaError_t err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err == cudaSuccess) err = cudaGetDevice(&current);
  if (err == cudaSuccess) err = cudaSetDevice(device);  // the occupancy query's device
  if (err == cudaSuccess) {
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, radius_match_kernel,
                                                        R_THREADS, 0);
    const cudaError_t back = cudaSetDevice(current);
    if (err == cudaSuccess) err = back;
  }
  return err == cudaSuccess ? sms * per_sm : -(int)err;
}

// Radius match of B members in one cooperative launch. Inputs: arrays of B
// per-member base pointers (q, db: (K, D) / (M, D) bf16, 32-byte aligned;
// uv_q, uv_db: (K, 2) / (M, 2) f32, 8-byte aligned; valid_q, valid_db:
// bool). Outputs laid out (B, K) / (B, M): claim (uint64 scratch), mp_idx
// int32, kp_ok uint8, dist f32, min_pix_d2 f32. max_grid: from
// vslam_radius_max_grid. Returns a cudaError_t; a grid too large for a
// cooperative launch is an error, never shrunk here.
int vslam_radius_match(const void* const* q, const void* const* uv_q,
                       const void* const* valid_q, int K, const void* const* db,
                       const void* const* uv_db, const void* const* valid_db, int M, int D,
                       int B, float radius2, float desc_thresh, void* claim, void* mp_idx,
                       void* kp_ok, void* dist, void* min_pix_d2, int max_grid, void* stream) {
  if (D % 16 != 0 || K < 0 || M < 0 || B < 0 || B > MAX_MEMBERS || max_grid < 1)
    return (int)cudaErrorInvalidValue;
  if (B == 0 || (K == 0 && M == 0)) return (int)cudaSuccess;
  RadiusMembers in = {};
  for (int b = 0; b < B; ++b) {
    in.q[b] = static_cast<const uint4*>(q[b]);
    in.uv_q[b] = static_cast<const float2*>(uv_q[b]);
    in.valid_q[b] = static_cast<const uint8_t*>(valid_q[b]);
    in.db[b] = static_cast<const uint4*>(db[b]);
    in.uv_db[b] = static_cast<const float2*>(uv_db[b]);
    in.valid_db[b] = static_cast<const uint8_t*>(valid_db[b]);
  }
  const int items = B * ((M + RT - 1) / RT);
  const int unpack = (B * K + R_THREADS - 1) / R_THREADS;
  const int want = items > unpack ? items : unpack;
  const int grid = want < 1 ? 1 : (want < max_grid ? want : max_grid);
  unsigned long long* claim_ = static_cast<unsigned long long*>(claim);
  int* mp_idx_ = static_cast<int*>(mp_idx);
  uint8_t* kp_ok_ = static_cast<uint8_t*>(kp_ok);
  float* dist_ = static_cast<float*>(dist);
  float* min_pix_d2_ = static_cast<float*>(min_pix_d2);
  void* args[] = {&in, &B, &K, &M, &D, &radius2, &desc_thresh, &claim_, &mp_idx_,
                  &kp_ok_, &dist_, &min_pix_d2_};
  cudaError_t err = cudaLaunchCooperativeKernel(
      reinterpret_cast<const void*>(radius_match_kernel), dim3(grid), dim3(R_THREADS), args, 0,
      reinterpret_cast<cudaStream_t>(stream));
  return (int)(err != cudaSuccess ? err : cudaGetLastError());
}

// Largest grid of the top-2 kernel that is co-resident on `device` at
// descriptor width D (the SM count x blocks per SM at its shared-memory
// size), or -cudaError_t. Also lifts the kernel's dynamic shared-memory
// limit to the device's opt-in maximum. The wrapper calls it once per
// (device, D) and passes the result to every launch; the calling thread's
// current device is the same before and after.
int vslam_top2_max_grid(int device, int D) {
  if (D < 16 || D % 16 != 0) return -(int)cudaErrorInvalidValue;
  int sms = 0, optin = 0, per_sm = 0, current = 0;
  cudaError_t err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, device);
  if (err == cudaSuccess) err = cudaGetDevice(&current);
  if (err == cudaSuccess) err = cudaSetDevice(device);
  if (err == cudaSuccess) {
    err = cudaFuncSetAttribute(top2_match_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               optin);
    if (err == cudaSuccess)
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, top2_match_kernel, T_THREADS,
                                                          top2_smem_bytes(D));
    const cudaError_t back = cudaSetDevice(current);
    if (err == cudaSuccess) err = back;
  }
  if (err == cudaSuccess && per_sm < 1) err = cudaErrorInvalidConfiguration;  // D too wide
  return err == cudaSuccess ? sms * per_sm : -(int)err;
}

// Top-2 match in one cooperative launch. db (M, D) bf16, q (K, D) bf16 and
// valid_db (M,) bool, each 16-byte aligned. Scratch: part_key
// (uint64) and part_s (f32), K x max_grid entries each. Outputs: d1, d2
// (K,) f32, idx (K,) int32. max_grid: from vslam_top2_max_grid(device, D).
// The map is split into S = max_grid / ceil(K / 80) interleaved tile sets
// (at least 1, at most the tile count). Returns a cudaError_t; K = 0
// launches nothing.
int vslam_top2_match(const void* db, const void* valid_db, int M, const void* q, int K, int D,
                     void* part_key, void* part_s, void* d1, void* d2, void* idx, int max_grid,
                     void* stream) {
  if (D < 16 || D % 16 != 0 || K < 0 || M < 0 || max_grid < 1)
    return (int)cudaErrorInvalidValue;
  if (K == 0) return (int)cudaSuccess;
  const int nchunks = (K + T_QC - 1) / T_QC;
  const int ntiles = (M + T_ROWS - 1) / T_ROWS;
  int S = max_grid / nchunks;  // splits: enough items to fill the grid,
  if (S > ntiles) S = ntiles;   // none without a tile,
  if (S < 1) S = 1;             // and at least one
  const int grid = nchunks * S < max_grid ? nchunks * S : max_grid;
  const __nv_bfloat16* db_ = static_cast<const __nv_bfloat16*>(db);
  const uint8_t* valid_ = static_cast<const uint8_t*>(valid_db);
  const __nv_bfloat16* q_ = static_cast<const __nv_bfloat16*>(q);
  unsigned long long* key_ = static_cast<unsigned long long*>(part_key);
  float* s_ = static_cast<float*>(part_s);
  float* d1_ = static_cast<float*>(d1);
  float* d2_ = static_cast<float*>(d2);
  int* idx_ = static_cast<int*>(idx);
  void* args[] = {&db_, &valid_, &M, &q_, &K, &D, &S, &key_, &s_, &d1_, &d2_, &idx_};
  cudaError_t err = cudaLaunchCooperativeKernel(
      reinterpret_cast<const void*>(top2_match_kernel), dim3(grid), dim3(T_THREADS), args,
      top2_smem_bytes(D), reinterpret_cast<cudaStream_t>(stream));
  return (int)(err != cudaSuccess ? err : cudaGetLastError());
}

}  // extern "C"
