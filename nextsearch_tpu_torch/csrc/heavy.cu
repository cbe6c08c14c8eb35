// Heavy-term kernels of the sparse BM25 path, written for Hopper (sm_90a).
//
// Built by nextsearch_tpu_torch/ops/cuda_build.py with
//   nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//        -Xcompiler -fPIC
// into a shared library with a plain C interface (loaded with ctypes). Every
// entry point launches on the caller's stream, allocates nothing, does not
// synchronise, and returns cudaGetLastError() so a refused launch is seen.
//
// ns_heavy_fused3  replaces nextsearch_tpu/ops/heavy_pallas.py
//                  heavy_fused3_pallas (K1): H = mix @ table with the
//                  per-128-doc sub-block max (smax) and the per-2048-doc tile
//                  count of H > 0 (cnt) computed from the same accumulators.
// ns_gather_rows   replaces gather_rows_pallas (K3, f32 out) and
//                  gather_rows_bf16_pallas (K2, bf16 out): table[ids] as one
//                  templated whole-row copy.
// ns_unified_fused replaces unified_fused_pallas (K5): K1's product plus the
//                  light entries (doc, q, value) of each tile added into it,
//                  with K1's smax/cnt epilogue taken of the summed totals.
// ns_per_query_topk replaces nextsearch_tpu/ops/select_pallas.py
//                  per_query_topk_pallas (K4): for each query q, the k2
//                  largest positive values of scores[bounds[q]:bounds[q+1]],
//                  as exact f32 values and global flat indices, ties going
//                  to the lowest index. Slots past the live entries keep the
//                  zeros the caller filled in.
//
// Layouts are the port's: the dense table is [rows, n_slots] and H is
// [Q, n_slots], both row-major. smax is [sub_pad, Q] and cnt [tiles_pad, Q],
// the JAX package's layouts; the caller pre-fills smax with -inf and cnt with
// 0, so the padding rows past the real sub-blocks and tiles keep those values.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int CSUB = 128;    // docs per selection sub-block (one block column)
constexpr int CPT = 16;      // sub-blocks per 2048-doc tile
constexpr int BM = 64;       // queries per block
constexpr int BK = 16;       // contraction rows per shared-memory stage
constexpr int TM = 8;        // queries per thread
constexpr int TN = 4;        // docs per thread
constexpr int THREADS = 256; // (BM / TM) * (CSUB / TN)

__device__ __forceinline__ float round_bf16(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

// Eight consecutive table values widened to f32 (one or two 16-byte loads).
__device__ __forceinline__ void load8(const float* p, float* v) {
  const float4 a = *reinterpret_cast<const float4*>(p);
  const float4 b = *reinterpret_cast<const float4*>(p + 4);
  v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w;
  v[4] = b.x; v[5] = b.y; v[6] = b.z; v[7] = b.w;
}

__device__ __forceinline__ void load8(const __nv_bfloat16* p, float* v) {
  const uint4 raw = *reinterpret_cast<const uint4*>(p);
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __bfloat1622float2(h[i]);
    v[2 * i] = f.x;
    v[2 * i + 1] = f.y;
  }
}

// One block computes a BM-query x 128-doc tile of H: the block column is one
// selection sub-block, so the block owns smax[sub, q0:q0+BM] outright and
// writes it without atomics. The contraction over the ND table rows runs in
// BK-row stages through shared memory; each thread keeps TM x TN f32
// accumulators in registers.
//
// FAST: both operands are rounded to bf16 (round-to-nearest-even) before the
// product, as the TPU's one-pass DEFAULT dot does; a bf16 x bf16 product is
// exact in f32, so only the f32 accumulation rounds. Exact mode multiplies
// the f32 operands with true fp32 FFMA (no TF32 anywhere).
//
// Bound: FP32 FFMA throughput. At the 1M-doc serving shapes the block reads its
// table stage once per 64 queries and H is written once; the product itself
// (Q * ND * n_slots FMAs) dominates. Tensor cores (wgmma) are the next step.
//
// ENTRIES (K5, the unified-totals kernel): the TPU kernel folded the light
// entries into its tile with 3-way bf16-split one-hot matmuls, because the
// MXU was its only fast adder and Mosaic could only DMA aligned 8x128 entry
// windows. Here the entry stream is plain (doc, q, value) arrays sorted by
// (doc, q), with per-sub-block offsets (ent_off): after the product the block
// parks its tile in shared memory, walks its sub-block's entries, skips
// those of other query blocks, and the thread at the start of each (q, doc)
// run adds the run's stream-order sum once. Runs never share a cell, so the
// adds need no atomics and two launches give identical bits. The entries are
// a few per sub-block at the serving shapes: the product still bounds it.
template <bool FAST, typename TabT, bool ENTRIES>
__global__ void __launch_bounds__(THREADS)
heavy_fused3_kernel(const float* __restrict__ mix, const TabT* __restrict__ table,
                    const int* __restrict__ ent_doc, const int* __restrict__ ent_q,
                    const float* __restrict__ ent_val,
                    const int* __restrict__ ent_off, float* __restrict__ h,
                    float* __restrict__ smax, float* __restrict__ cnt, int Q,
                    int ND, long long n_slots, int n_qblk) {
  // The mix and table stages; K5 reuses the same memory for its tile.
  constexpr int SMEM = ENTRIES ? BM * CSUB : BK * (BM + CSUB);
  __shared__ __align__(16) float smem[SMEM];
  float (*As)[BM] = reinterpret_cast<float (*)[BM]>(smem);  // k-major
  float (*Bs)[CSUB] = reinterpret_cast<float (*)[CSUB]>(smem + BK * BM);
  const int tid = threadIdx.x;
  const int qb = blockIdx.x % n_qblk;
  const long long sub = blockIdx.x / n_qblk;
  const int q0 = qb * BM;
  const long long d0 = sub * CSUB;
  const int tx = tid & 31;  // docs tx*TN .. tx*TN+3 of the sub-block
  const int ty = tid >> 5;  // queries q0 + ty*TM .. +7 (one warp, one ty)

  float acc[TM][TN];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = 0.f;

  const int a_m = tid >> 2;         // mix loader: one query row,
  const int a_k = (tid & 3) * 4;    //   four consecutive k
  const int b_k = tid >> 4;         // table loader: one k row,
  const int b_n = (tid & 15) * 8;   //   eight consecutive docs
  const int a_q = q0 + a_m;

  for (int k0 = 0; k0 < ND; k0 += BK) {
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int k = k0 + a_k + j;
      float v = (a_q < Q && k < ND) ? mix[(long long)a_q * ND + k] : 0.f;
      if constexpr (FAST) v = round_bf16(v);
      As[a_k + j][a_m] = v;
    }
    {
      float v[8];
      const int k = k0 + b_k;
      if (k < ND) {
        load8(table + (long long)k * n_slots + d0 + b_n, v);
        if constexpr (FAST && sizeof(TabT) == 4) {
#pragma unroll
          for (int j = 0; j < 8; ++j) v[j] = round_bf16(v[j]);
        }
      } else {
#pragma unroll
        for (int j = 0; j < 8; ++j) v[j] = 0.f;
      }
      *reinterpret_cast<float4*>(&Bs[b_k][b_n]) =
          make_float4(v[0], v[1], v[2], v[3]);
      *reinterpret_cast<float4*>(&Bs[b_k][b_n + 4]) =
          make_float4(v[4], v[5], v[6], v[7]);
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < BK; ++kk) {
      const float4 a0 = *reinterpret_cast<const float4*>(&As[kk][ty * TM]);
      const float4 a1 = *reinterpret_cast<const float4*>(&As[kk][ty * TM + 4]);
      const float4 b = *reinterpret_cast<const float4*>(&Bs[kk][tx * TN]);
      const float a[TM] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
      const float bv[TN] = {b.x, b.y, b.z, b.w};
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int j = 0; j < TN; ++j) acc[i][j] = fmaf(a[i], bv[j], acc[i][j]);
    }
    __syncthreads();
  }

  if constexpr (ENTRIES) {
    // The loop ended on __syncthreads(), so the stage memory is free.
    float (*Ts)[CSUB] = reinterpret_cast<float (*)[CSUB]>(smem);
#pragma unroll
    for (int i = 0; i < TM; ++i)
      *reinterpret_cast<float4*>(&Ts[ty * TM + i][tx * TN]) =
          make_float4(acc[i][0], acc[i][1], acc[i][2], acc[i][3]);
    __syncthreads();
    const int e0 = ent_off[sub];
    const int e1 = ent_off[sub + 1];
    for (int e = e0 + tid; e < e1; e += THREADS) {
      const int d = ent_doc[e];
      const int q = ent_q[e];
      // other query blocks' entries; the sentinel doc n_slots lies past
      // every sub-block, so it never lands on a tile's padding docs
      if (q < q0 || q >= q0 + BM || d < d0 || d >= d0 + CSUB) continue;
      if (e > e0 && ent_doc[e - 1] == d && ent_q[e - 1] == q) continue;
      float run = ent_val[e];
      for (int j = e + 1; j < e1 && ent_doc[j] == d && ent_q[j] == q; ++j)
        run += ent_val[j];
      Ts[q - q0][d - d0] += run;
    }
    __syncthreads();
#pragma unroll
    for (int i = 0; i < TM; ++i) {
      const float4 t = *reinterpret_cast<const float4*>(&Ts[ty * TM + i][tx * TN]);
      acc[i][0] = t.x; acc[i][1] = t.y; acc[i][2] = t.z; acc[i][3] = t.w;
    }
  }

  // Epilogue from the f32 accumulators: the warp holds one query row's 128
  // docs, so the sub-block max and positive count are warp reductions.
  // Counts are small integers, so the f32 atomic add into the tile's count
  // is exact in any order.
  const long long tile = sub / CPT;
#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int q = q0 + ty * TM + i;
    float mx = fmaxf(fmaxf(acc[i][0], acc[i][1]), fmaxf(acc[i][2], acc[i][3]));
    int c = (acc[i][0] > 0.f) + (acc[i][1] > 0.f) + (acc[i][2] > 0.f) +
            (acc[i][3] > 0.f);
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      c += __shfl_xor_sync(0xffffffffu, c, off);
    }
    if (q < Q) {
      *reinterpret_cast<float4*>(h + (long long)q * n_slots + d0 + tx * TN) =
          make_float4(acc[i][0], acc[i][1], acc[i][2], acc[i][3]);
      if (tx == 0) {
        smax[sub * Q + q] = mx;
        atomicAdd(cnt + tile * Q + q, static_cast<float>(c));
      }
    }
  }
}

__device__ __forceinline__ void store4(float* p, float4 v) {
  *reinterpret_cast<float4*>(p) = v;
}

__device__ __forceinline__ void store4(__nv_bfloat16* p, float4 v) {
  // __floats2bfloat162_rn rounds each value to nearest even, as torch's
  // .to(torch.bfloat16) and XLA's convert do.
  const __nv_bfloat162 lo = __floats2bfloat162_rn(v.x, v.y);
  const __nv_bfloat162 hi = __floats2bfloat162_rn(v.z, v.w);
  uint2 raw;
  raw.x = *reinterpret_cast<const uint32_t*>(&lo);
  raw.y = *reinterpret_cast<const uint32_t*>(&hi);
  *reinterpret_cast<uint2*>(p) = raw;
}

// out[u, :] = table[ids[u], :] (converted to OutT). Pure data movement,
// bound by device memory bandwidth: 16-byte loads, neighbouring threads on
// neighbouring addresses, rows spread over gridDim.y. Row ids are clamped
// to the table, as the JAX caller clips them before its gather.
template <typename OutT>
__global__ void gather_rows_kernel(const int* __restrict__ ids,
                                   const float* __restrict__ table,
                                   OutT* __restrict__ out, int n_ids,
                                   int n_rows, long long n_slots) {
  const long long nv = n_slots / 4;
  for (int u = blockIdx.y; u < n_ids; u += gridDim.y) {
    int r = ids[u];
    r = r < 0 ? 0 : (r >= n_rows ? n_rows - 1 : r);
    const float4* src = reinterpret_cast<const float4*>(table + (long long)r * n_slots);
    OutT* dst = out + (long long)u * n_slots;
    for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < nv;
         i += (long long)gridDim.x * blockDim.x) {
      store4(dst + 4 * i, __ldg(src + i));
    }
  }
}

// The entry stream of K5 (all null for K1).
struct Entries {
  const int* doc;
  const int* q;
  const float* val;
  const int* off;
};

template <bool FAST, typename TabT, bool ENTRIES>
void launch_heavy(const float* mix, const void* table, Entries ent, float* h,
                  float* smax, float* cnt, int Q, int ND, long long n_slots,
                  cudaStream_t stream) {
  const int n_qblk = (Q + BM - 1) / BM;
  const long long n_sub = n_slots / CSUB;
  const unsigned int grid = static_cast<unsigned int>(n_sub * n_qblk);
  heavy_fused3_kernel<FAST, TabT, ENTRIES><<<grid, THREADS, 0, stream>>>(
      mix, static_cast<const TabT*>(table), ent.doc, ent.q, ent.val, ent.off,
      h, smax, cnt, Q, ND, n_slots, n_qblk);
}

template <bool ENTRIES>
int dispatch_heavy(const float* mix, const void* table, int table_bf16,
                   int fast, Entries ent, float* h, float* smax, float* cnt,
                   int Q, int ND, long long n_slots, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (fast && table_bf16)
    launch_heavy<true, __nv_bfloat16, ENTRIES>(mix, table, ent, h, smax, cnt, Q, ND, n_slots, s);
  else if (fast)
    launch_heavy<true, float, ENTRIES>(mix, table, ent, h, smax, cnt, Q, ND, n_slots, s);
  else if (table_bf16)
    launch_heavy<false, __nv_bfloat16, ENTRIES>(mix, table, ent, h, smax, cnt, Q, ND, n_slots, s);
  else
    launch_heavy<false, float, ENTRIES>(mix, table, ent, h, smax, cnt, Q, ND, n_slots, s);
  return static_cast<int>(cudaGetLastError());
}

// K4. The TPU kernel DMA'd each query's window from a 1024-aligned floor into
// VMEM, masked it, and ran k2 rounds of (max, first index, clear) over a
// static number of blocks, so a window longer than its static bound was
// silently cut. Here one block owns one query and runs k2 rounds of a
// block-wide arg-max on a 64-bit key: the value's bits (order-preserving for
// positive floats) over the inverted window index, so a larger key is a
// larger value or, among equal values, a lower index. Each round takes the
// largest key strictly below the last round's winner. Keys are unique, so
// nothing is cleared, the input stays read-only, and any window length gives
// the exact result.
//
// Bound: each round rereads the window from device memory (k2 passes, mostly
// from L2); at the serving shapes (512 queries, windows of a few thousand
// entries, k2 = 32) that is far below the sort it replaces.
constexpr int SEL_THREADS = 512;
constexpr int SEL_WARPS = SEL_THREADS / 32;

__device__ __forceinline__ unsigned long long sel_key(float v, unsigned int j) {
  // dead entries (v <= 0, or NaN) get key 0 and are never selected
  return v > 0.f
             ? (static_cast<unsigned long long>(__float_as_uint(v)) << 32) |
                   (0xFFFFFFFFu - j)
             : 0ull;
}

__device__ __forceinline__ unsigned long long warp_max(unsigned long long v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    const unsigned long long o = __shfl_xor_sync(0xffffffffu, v, off);
    v = o > v ? o : v;
  }
  return v;
}

__global__ void __launch_bounds__(SEL_THREADS)
per_query_topk_kernel(const float* __restrict__ scores,
                      const long long* __restrict__ bounds, long long n,
                      int k2, float* __restrict__ vals,
                      long long* __restrict__ gidx) {
  __shared__ unsigned long long red[SEL_WARPS];
  __shared__ unsigned long long winner;
  const int q = blockIdx.x;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  long long s = bounds[q];
  long long e = bounds[q + 1];
  s = s < 0 ? 0 : (s > n ? n : s);
  e = e < s ? s : (e > n ? n : e);
  const long long len = e - s;
  const float* win = scores + s;
  unsigned long long prev = ~0ull;
  for (int r = 0; r < k2; ++r) {
    unsigned long long best = 0;
    for (long long i = tid; i < len; i += SEL_THREADS) {
      const unsigned long long key = sel_key(win[i], static_cast<unsigned int>(i));
      if (key < prev && key > best) best = key;
    }
    best = warp_max(best);
    if (lane == 0) red[warp] = best;
    __syncthreads();
    if (warp == 0) {
      best = warp_max(lane < SEL_WARPS ? red[lane] : 0ull);
      if (lane == 0) winner = best;
    }
    __syncthreads();
    best = winner;  // the same value in every thread: the loop exits together
    if (best == 0) break;
    if (tid == 0) {
      vals[(long long)q * k2 + r] = __uint_as_float(static_cast<unsigned int>(best >> 32));
      gidx[(long long)q * k2 + r] =
          s + (0xFFFFFFFFu - static_cast<unsigned int>(best & 0xFFFFFFFFull));
    }
    prev = best;
  }
}

}  // namespace

extern "C" int ns_heavy_fused3(const float* mix, const void* table,
                               int table_bf16, int fast, float* h, float* smax,
                               float* cnt, int Q, int ND, long long n_slots,
                               void* stream) {
  return dispatch_heavy<false>(mix, table, table_bf16, fast,
                               Entries{nullptr, nullptr, nullptr, nullptr}, h,
                               smax, cnt, Q, ND, n_slots, stream);
}

extern "C" int ns_unified_fused(const float* mix, const void* table,
                                int table_bf16, int fast, const int* ent_doc,
                                const int* ent_q, const float* ent_val,
                                const int* ent_off, float* totals, float* smax,
                                float* cnt, int Q, int ND, long long n_slots,
                                void* stream) {
  return dispatch_heavy<true>(mix, table, table_bf16, fast,
                              Entries{ent_doc, ent_q, ent_val, ent_off},
                              totals, smax, cnt, Q, ND, n_slots, stream);
}

extern "C" int ns_gather_rows(const int* ids, const float* table, void* out,
                              int out_bf16, int n_ids, int n_rows,
                              long long n_slots, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int threads = 256;
  const long long nv = n_slots / 4;
  long long bx = (nv + threads * 8 - 1) / (threads * 8);
  if (bx < 1) bx = 1;
  const dim3 grid(static_cast<unsigned int>(bx),
                  static_cast<unsigned int>(n_ids < 65535 ? n_ids : 65535));
  if (out_bf16)
    gather_rows_kernel<__nv_bfloat16><<<grid, threads, 0, s>>>(
        ids, table, static_cast<__nv_bfloat16*>(out), n_ids, n_rows, n_slots);
  else
    gather_rows_kernel<float><<<grid, threads, 0, s>>>(
        ids, table, static_cast<float*>(out), n_ids, n_rows, n_slots);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int ns_per_query_topk(const float* scores, const long long* bounds,
                                 long long n, int n_queries, int k2,
                                 float* vals, long long* gidx, void* stream) {
  per_query_topk_kernel<<<n_queries, SEL_THREADS, 0,
                          static_cast<cudaStream_t>(stream)>>>(
      scores, bounds, n, k2, vals, gidx);
  return static_cast<int>(cudaGetLastError());
}
