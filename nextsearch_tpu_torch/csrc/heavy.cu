// Kernels of the sparse BM25 path and of its probes, written for Hopper
// (sm_90a).
//
// Built by nextsearch_tpu_torch/ops/cuda_build.py with
//   nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//        -Xcompiler -fPIC
// into a shared library with a plain C interface (loaded with ctypes). Every
// entry point launches on the caller's stream, allocates nothing, does not
// synchronise, and returns cudaGetLastError() so a refused launch is seen.
//
// ns_heavy_fused3  replaces nextsearch_tpu/ops/heavy_pallas.py
//                  heavy_fused3_pallas (K1) and heavy_fused_pallas (K6): H =
//                  mix @ table with the per-128-doc sub-block max (smax) and
//                  the per-2048-doc tile count of H > 0 (cnt) computed from
//                  the same accumulators, H stored f32 or bf16 rounded up.
//                  The TPU's 2D (K6) and 3D (K1) kernels differ only in how
//                  Mosaic tiles the table; on Hopper both are this kernel.
// ns_heavy_variant replaces benchmarks/probe_fusedmm.py fused_variant (P6):
//                  the one-pass product with the epilogue, the smax store or
//                  the H store taken out, or H stored bf16 to nearest.
// ns_gather_rows   replaces gather_rows_pallas (K3, f32 or bf16 rows kept in
//                  their type) and gather_rows_bf16_pallas (K2, f32 rows to
//                  bf16): table[ids] as one templated whole-row copy.
// ns_unified_fused replaces unified_fused_pallas (K5): K1's product plus the
//                  light entries (doc, q, value) of each tile added into it,
//                  with K1's smax/cnt epilogue taken of the summed totals.
// ns_per_query_topk replaces nextsearch_tpu/ops/select_pallas.py
//                  per_query_topk_pallas (K4): for each query q, the k2
//                  largest positive values of scores[bounds[q]:bounds[q+1]],
//                  as exact f32 values and global flat indices, ties going
//                  to the lowest index. Slots past the live entries keep the
//                  zeros the caller filled in.
// ns_probe_*       replace benchmarks/mosaic_probe.py's lowering probes
//                  P1-P5 (t1/k1 .. t5/k5): nt_dot (o = a . b^T), row_copy
//                  (2 * e[off[0]] at an index read on the device),
//                  window_op (a scatter-add of W entries), copy (the
//                  (4, 128, Q) -> (512, Q) reshape) and transpose.
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

// How H leaves the kernel.
constexpr int H_F32 = 0;      // the f32 accumulators
constexpr int H_BF16_UP = 1;  // bf16 rounded toward +inf for non-negative
                              // values: (bits + 0xFFFF) >> 16, as the JAX
                              // package's _round_up_store, so a stored value
                              // bounds its accumulator from above
constexpr int H_BF16_RN = 2;  // bf16 rounded to nearest even (astype)

// P6's epilogue variants; K1, K5 and K6 always run EPI_FULL.
constexpr int EPI_FULL = 0;     // smax per sub-block, cnt per tile
constexpr int EPI_NONE = 1;     // no epilogue: smax stays -inf, cnt 0
constexpr int EPI_REDUCED = 2;  // the epilogue's reductions without the
                                // per-query stores: a second pass writes
                                // max(smax) + min(cnt) of each tile

__device__ __forceinline__ float round_bf16(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

__device__ __forceinline__ uint32_t bf16_up_bits(float x) {
  return (__float_as_uint(x) + 0xFFFFu) >> 16;
}

__device__ __forceinline__ uint32_t bf16_rn_bits(float x) {
  const __nv_bfloat16 b = __float2bfloat16_rn(x);
  return *reinterpret_cast<const uint16_t*>(&b);
}

// Four consecutive H values of one query row.
template <int HST>
__device__ __forceinline__ void store_h4(void* h, long long i, float a, float b,
                                         float c, float d) {
  if constexpr (HST == H_F32) {
    *reinterpret_cast<float4*>(static_cast<float*>(h) + i) = make_float4(a, b, c, d);
  } else {
    uint2 raw;
    if constexpr (HST == H_BF16_UP) {
      raw.x = bf16_up_bits(a) | (bf16_up_bits(b) << 16);
      raw.y = bf16_up_bits(c) | (bf16_up_bits(d) << 16);
    } else {
      raw.x = bf16_rn_bits(a) | (bf16_rn_bits(b) << 16);
      raw.y = bf16_rn_bits(c) | (bf16_rn_bits(d) << 16);
    }
    *reinterpret_cast<uint2*>(static_cast<__nv_bfloat16*>(h) + i) = raw;
  }
}

// Eight consecutive table values widened to f32 (one or two 16-byte loads,
// through the read-only data cache: no kernel here writes what it reads).
__device__ __forceinline__ void load8(const float* p, float* v) {
  const float4 a = __ldg(reinterpret_cast<const float4*>(p));
  const float4 b = __ldg(reinterpret_cast<const float4*>(p + 4));
  v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w;
  v[4] = b.x; v[5] = b.y; v[6] = b.z; v[7] = b.w;
}

__device__ __forceinline__ void load8(const __nv_bfloat16* p, float* v) {
  const uint4 raw = __ldg(reinterpret_cast<const uint4*>(p));
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
// the f32 operands with true fp32 FFMA (no TF32 anywhere); over a bf16
// table it rounds mix to bf16 first, as the JAX callers cast
// mix.astype(table.dtype) before the dot, so there too only the sums round.
//
// HST picks how H is stored (f32, bf16 up, bf16 to nearest); smax and cnt
// always come from the f32 accumulators. VARIANT (P6 only) reads two
// run-time switches: store_h = 0 writes zeros in place of H, and epi picks
// one of the EPI_* epilogues; EPI_REDUCED writes each block's tile maximum
// to part[sub * n_qblk + qb] and the counts to a scratch cnt, which
// variant_reduce_kernel folds per tile.
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
template <bool FAST, typename TabT, bool ENTRIES, int HST, bool VARIANT>
__global__ void __launch_bounds__(THREADS)
heavy_fused3_kernel(const float* __restrict__ mix, const TabT* __restrict__ table,
                    const int* __restrict__ ent_doc, const int* __restrict__ ent_q,
                    const float* __restrict__ ent_val,
                    const int* __restrict__ ent_off, void* __restrict__ h,
                    float* __restrict__ smax, float* __restrict__ cnt,
                    float* __restrict__ part, int Q, int ND, long long n_slots,
                    int n_qblk, int store_h, int epi) {
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
      if constexpr (FAST || sizeof(TabT) == 2) v = round_bf16(v);
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
  const bool write_h = !VARIANT || store_h;
  const bool epi_on = !VARIANT || epi != EPI_NONE;
  const bool per_query = !VARIANT || epi == EPI_FULL;
  // EPI_REDUCED: this thread's share of the tile max (-inf to start)
  float bmax = __int_as_float(0xff800000);
#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int q = q0 + ty * TM + i;
    if (q < Q) {
      const long long at = (long long)q * n_slots + d0 + tx * TN;
      if (write_h)
        store_h4<HST>(h, at, acc[i][0], acc[i][1], acc[i][2], acc[i][3]);
      else
        store_h4<HST>(h, at, 0.f, 0.f, 0.f, 0.f);
    }
    if (!epi_on) continue;
    float mx = fmaxf(fmaxf(acc[i][0], acc[i][1]), fmaxf(acc[i][2], acc[i][3]));
    int c = (acc[i][0] > 0.f) + (acc[i][1] > 0.f) + (acc[i][2] > 0.f) +
            (acc[i][3] > 0.f);
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      c += __shfl_xor_sync(0xffffffffu, c, off);
    }
    if (q < Q && tx == 0) {
      if (per_query) smax[sub * Q + q] = mx;
      else bmax = fmaxf(bmax, mx);
      atomicAdd(cnt + tile * Q + q, static_cast<float>(c));
    }
  }
  if constexpr (VARIANT) {
    if (epi == EPI_REDUCED) {
      // lane 0 of each warp holds its rows' max; fold the 8 warps
      __shared__ float wmax[THREADS / 32];
      if (tx == 0) wmax[ty] = bmax;
      __syncthreads();
      if (tid == 0) {
        float m = wmax[0];
        for (int w = 1; w < THREADS / 32; ++w) m = fmaxf(m, wmax[w]);
        part[sub * n_qblk + qb] = m;
      }
    }
  }
}

// P6's second pass for EPI_REDUCED: one block per 2048-doc tile folds the
// tile's block maxima (part) and the minimum over queries of its positive
// counts (cnt_s), and writes their sum into all 16 of the tile's smax rows,
// as the TPU probe broadcast max(sm) + min(ct) into them.
__global__ void __launch_bounds__(THREADS)
variant_reduce_kernel(const float* __restrict__ part,
                      const float* __restrict__ cnt_s, float* __restrict__ smax,
                      int Q, int n_qblk) {
  __shared__ float rmax[THREADS];
  __shared__ float rmin[THREADS];
  const int t = blockIdx.x;
  const int tid = threadIdx.x;
  float m = __int_as_float(0xff800000);  // -inf
  for (int i = tid; i < CPT * n_qblk; i += THREADS)
    m = fmaxf(m, part[(long long)t * CPT * n_qblk + i]);
  float c = __int_as_float(0x7f800000);  // +inf
  for (int q = tid; q < Q; q += THREADS) c = fminf(c, cnt_s[(long long)t * Q + q]);
  rmax[tid] = m;
  rmin[tid] = c;
  __syncthreads();
  for (int s = THREADS / 2; s > 0; s >>= 1) {
    if (tid < s) {
      rmax[tid] = fmaxf(rmax[tid], rmax[tid + s]);
      rmin[tid] = fminf(rmin[tid], rmin[tid + s]);
    }
    __syncthreads();
  }
  const float v = rmax[0] + rmin[0];
  for (int i = tid; i < CPT * Q; i += THREADS)
    smax[((long long)t * CPT + i / Q) * Q + i % Q] = v;
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
// bound by device memory bandwidth: each step moves one 16-byte vector of
// the source row (4 f32 or 8 bf16 values), neighbouring threads on
// neighbouring addresses, rows spread over gridDim.y. Row ids are clamped
// to the table, as the JAX caller clips them before its gather. InT/OutT:
// f32/f32 (K3), f32/bf16 (K2), bf16/bf16 (K3 over bf16 dense rows); the
// same-type gathers copy the bytes.
template <typename InT, typename OutT>
__global__ void gather_rows_kernel(const int* __restrict__ ids,
                                   const InT* __restrict__ table,
                                   OutT* __restrict__ out, int n_ids,
                                   int n_rows, long long n_slots) {
  const long long nv = n_slots / (16 / sizeof(InT));
  for (int u = blockIdx.y; u < n_ids; u += gridDim.y) {
    int r = ids[u];
    r = r < 0 ? 0 : (r >= n_rows ? n_rows - 1 : r);
    const InT* src = table + (long long)r * n_slots;
    OutT* dst = out + (long long)u * n_slots;
    for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < nv;
         i += (long long)gridDim.x * blockDim.x) {
      if constexpr (sizeof(InT) == sizeof(OutT))
        reinterpret_cast<uint4*>(dst)[i] = __ldg(reinterpret_cast<const uint4*>(src) + i);
      else
        store4(dst + 4 * i, __ldg(reinterpret_cast<const float4*>(src) + i));
    }
  }
}

// The entry stream of K5 (all null otherwise).
struct Entries {
  const int* doc;
  const int* q;
  const float* val;
  const int* off;
};

struct HeavyArgs {
  const float* mix;
  const void* table;
  Entries ent;
  void* h;
  float* smax;
  float* cnt;
  float* part;  // P6 EPI_REDUCED block maxima, else null
  int Q;
  int ND;
  long long n_slots;
  int store_h;
  int epi;
};

template <bool FAST, typename TabT, bool ENTRIES, int HST, bool VARIANT>
void launch_heavy(const HeavyArgs& a, cudaStream_t stream) {
  const int n_qblk = (a.Q + BM - 1) / BM;
  const long long n_sub = a.n_slots / CSUB;
  const unsigned int grid = static_cast<unsigned int>(n_sub * n_qblk);
  heavy_fused3_kernel<FAST, TabT, ENTRIES, HST, VARIANT><<<grid, THREADS, 0, stream>>>(
      a.mix, static_cast<const TabT*>(a.table), a.ent.doc, a.ent.q, a.ent.val,
      a.ent.off, a.h, a.smax, a.cnt, a.part, a.Q, a.ND, a.n_slots, n_qblk,
      a.store_h, a.epi);
}

// P6 is the one-pass (fast) product only, as the TPU probe's DEFAULT dot.
template <bool ENTRIES, int HST, bool VARIANT>
void dispatch_heavy(const HeavyArgs& a, int table_bf16, int fast,
                    cudaStream_t s) {
  if (table_bf16 && (fast || VARIANT))
    launch_heavy<true, __nv_bfloat16, ENTRIES, HST, VARIANT>(a, s);
  else if (fast || VARIANT)
    launch_heavy<true, float, ENTRIES, HST, VARIANT>(a, s);
  else if constexpr (!VARIANT) {
    if (table_bf16)
      launch_heavy<false, __nv_bfloat16, ENTRIES, HST, VARIANT>(a, s);
    else
      launch_heavy<false, float, ENTRIES, HST, VARIANT>(a, s);
  }
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

// P1-P5, the lowering probes of benchmarks/mosaic_probe.py: five tiny
// kernels that checked which operations Mosaic could lower for the unified
// kernel (K5) on the TPU. On Hopper each is a plain kernel over f32 tensors,
// held against its PyTorch version by
// nextsearch_tpu_torch/benchmarks/kernel_probe.py. All five are bound by
// launch latency at the probe's shapes (at most 128 x 1024 outputs).
constexpr int PTS = 16;  // output tile edge of the NT dot, window op, transpose

// P1: o[Q, T] = a[Q, W] . b[T, W]^T, f32 FFMA in contraction order.
__global__ void nt_dot_kernel(const float* __restrict__ a,
                              const float* __restrict__ b,
                              float* __restrict__ o, int Q, int T, int W) {
  __shared__ float as[PTS][PTS + 1];
  __shared__ float bs[PTS][PTS + 1];
  const int q = blockIdx.y * PTS + threadIdx.y;
  const int t = blockIdx.x * PTS + threadIdx.x;
  float acc = 0.f;
  for (int w0 = 0; w0 < W; w0 += PTS) {
    const int wa = w0 + threadIdx.x;
    const int qb = blockIdx.y * PTS + threadIdx.y;
    const int tb = blockIdx.x * PTS + threadIdx.y;
    as[threadIdx.y][threadIdx.x] = (qb < Q && wa < W) ? a[(long long)qb * W + wa] : 0.f;
    bs[threadIdx.y][threadIdx.x] = (tb < T && wa < W) ? b[(long long)tb * W + wa] : 0.f;
    __syncthreads();
#pragma unroll
    for (int k = 0; k < PTS; ++k)
      acc = fmaf(as[threadIdx.y][k], bs[threadIdx.x][k], acc);
    __syncthreads();
  }
  if (q < Q && t < T) o[(long long)q * T + t] = acc;
}

// P2: o[r, :] = 2 * e[off[0], :] for each of o's R rows, the row index read
// on the device.
__global__ void row_copy_kernel(const float* __restrict__ e,
                                const int* __restrict__ off,
                                float* __restrict__ o, int n_rows, int R,
                                int W) {
  int r = off[0];
  r = r < 0 ? 0 : (r >= n_rows ? n_rows - 1 : r);
  for (int i = blockIdx.x * blockDim.x + threadIdx.x; i < R * W;
       i += gridDim.x * blockDim.x)
    o[i] = e[(long long)r * W + i % W] * 2.f;
}

// P3, the one-hot window op: o[q, d] = sum over the W entries w with
// (wq[w], wd[w]) == (q, d) of wv[w]. One thread per output cell; the block
// stages the W entries in shared memory and each thread walks them in
// order, so repeated (q, d) entries add in entry order, as the one-hot
// product's contraction does.
constexpr int WIN_MAX = 1024;

__global__ void window_op_kernel(const int* __restrict__ wq,
                                 const float* __restrict__ wv,
                                 const int* __restrict__ wd,
                                 float* __restrict__ o, int Q, int T, int W) {
  __shared__ int sq[WIN_MAX];
  __shared__ int sd[WIN_MAX];
  __shared__ float sv[WIN_MAX];
  const int tid = threadIdx.y * PTS + threadIdx.x;
  for (int i = tid; i < W; i += PTS * PTS) {
    sq[i] = wq[i];
    sd[i] = wd[i];
    sv[i] = wv[i];
  }
  __syncthreads();
  const int q = blockIdx.y * PTS + threadIdx.y;
  const int t = blockIdx.x * PTS + threadIdx.x;
  if (q >= Q || t >= T) return;
  float acc = 0.f;
  for (int w = 0; w < W; ++w)
    if (sq[w] == q && sd[w] == t) acc += sv[w];
  o[(long long)q * T + t] = acc;
}

// P4: the reshape (4, 128, Q) -> (512, Q), which in row-major memory is a
// copy.
__global__ void copy_kernel(const float4* __restrict__ a, float4* __restrict__ o,
                            long long n4) {
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < n4;
       i += (long long)gridDim.x * blockDim.x)
    o[i] = a[i];
}

// P5: o[C, R] = a[R, C]^T through a shared-memory tile.
__global__ void transpose_kernel(const float* __restrict__ a,
                                 float* __restrict__ o, int R, int C) {
  __shared__ float tile[PTS][PTS + 1];
  const int c = blockIdx.x * PTS + threadIdx.x;
  const int r = blockIdx.y * PTS + threadIdx.y;
  if (r < R && c < C) tile[threadIdx.y][threadIdx.x] = a[(long long)r * C + c];
  __syncthreads();
  const int oc = blockIdx.y * PTS + threadIdx.x;  // output column = input row
  const int orow = blockIdx.x * PTS + threadIdx.y;
  if (orow < C && oc < R) o[(long long)orow * R + oc] = tile[threadIdx.x][threadIdx.y];
}

dim3 probe_tiles(int rows, int cols) {
  return dim3((cols + PTS - 1) / PTS, (rows + PTS - 1) / PTS);
}

}  // namespace

extern "C" int ns_heavy_fused3(const float* mix, const void* table,
                               int table_bf16, int fast, int h_bf16_up,
                               void* h, float* smax, float* cnt, int Q, int ND,
                               long long n_slots, void* stream) {
  const HeavyArgs a{mix, table, Entries{nullptr, nullptr, nullptr, nullptr},
                    h, smax, cnt, nullptr, Q, ND, n_slots, 1, EPI_FULL};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (h_bf16_up)
    dispatch_heavy<false, H_BF16_UP, false>(a, table_bf16, fast, s);
  else
    dispatch_heavy<false, H_F32, false>(a, table_bf16, fast, s);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int ns_unified_fused(const float* mix, const void* table,
                                int table_bf16, int fast, const int* ent_doc,
                                const int* ent_q, const float* ent_val,
                                const int* ent_off, float* totals, float* smax,
                                float* cnt, int Q, int ND, long long n_slots,
                                void* stream) {
  const HeavyArgs a{mix, table, Entries{ent_doc, ent_q, ent_val, ent_off},
                    totals, smax, cnt, nullptr, Q, ND, n_slots, 1, EPI_FULL};
  dispatch_heavy<true, H_F32, false>(a, table_bf16, fast,
                                     static_cast<cudaStream_t>(stream));
  return static_cast<int>(cudaGetLastError());
}

// P6. epi is EPI_FULL, EPI_NONE or EPI_REDUCED; under EPI_REDUCED cnt_s
// (zeroed [tiles_pad, Q]) and part ([n_sub * ceil(Q / 64)]) are scratch and
// cnt stays as the caller filled it.
extern "C" int ns_heavy_variant(const float* mix, const void* table,
                                int table_bf16, int h_bf16_rn, int store_h,
                                int epi, void* h, float* smax, float* cnt,
                                float* cnt_s, float* part, int Q, int ND,
                                long long n_slots, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const HeavyArgs a{mix, table, Entries{nullptr, nullptr, nullptr, nullptr},
                    h, smax, epi == EPI_REDUCED ? cnt_s : cnt, part, Q, ND,
                    n_slots, store_h, epi};
  if (h_bf16_rn)
    dispatch_heavy<false, H_BF16_RN, true>(a, table_bf16, 1, s);
  else
    dispatch_heavy<false, H_F32, true>(a, table_bf16, 1, s);
  const int rc = static_cast<int>(cudaGetLastError());
  if (rc != 0 || epi != EPI_REDUCED) return rc;
  const int n_tiles = static_cast<int>(n_slots / (CSUB * CPT));
  variant_reduce_kernel<<<n_tiles, THREADS, 0, s>>>(part, cnt_s, smax, Q,
                                                    (Q + BM - 1) / BM);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int ns_gather_rows(const int* ids, const void* table, int in_bf16,
                              void* out, int out_bf16, int n_ids, int n_rows,
                              long long n_slots, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int threads = 256;
  const long long nv = n_slots / (in_bf16 ? 8 : 4);  // 16-byte vectors
  long long bx = (nv + threads * 8 - 1) / (threads * 8);
  if (bx < 1) bx = 1;
  const dim3 grid(static_cast<unsigned int>(bx),
                  static_cast<unsigned int>(n_ids < 65535 ? n_ids : 65535));
  if (in_bf16 && out_bf16)
    gather_rows_kernel<__nv_bfloat16, __nv_bfloat16><<<grid, threads, 0, s>>>(
        ids, static_cast<const __nv_bfloat16*>(table),
        static_cast<__nv_bfloat16*>(out), n_ids, n_rows, n_slots);
  else if (in_bf16)
    return static_cast<int>(cudaErrorInvalidValue);  // bf16 -> f32 unused
  else if (out_bf16)
    gather_rows_kernel<float, __nv_bfloat16><<<grid, threads, 0, s>>>(
        ids, static_cast<const float*>(table), static_cast<__nv_bfloat16*>(out),
        n_ids, n_rows, n_slots);
  else
    gather_rows_kernel<float, float><<<grid, threads, 0, s>>>(
        ids, static_cast<const float*>(table), static_cast<float*>(out), n_ids,
        n_rows, n_slots);
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

extern "C" int ns_probe_nt_dot(const float* a, const float* b, float* o, int Q,
                               int T, int W, void* stream) {
  nt_dot_kernel<<<probe_tiles(Q, T), dim3(PTS, PTS), 0,
                  static_cast<cudaStream_t>(stream)>>>(a, b, o, Q, T, W);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int ns_probe_row_copy(const float* e, const int* off, float* o,
                                 int n_rows, int R, int W, void* stream) {
  row_copy_kernel<<<(R * W + 255) / 256, 256, 0, static_cast<cudaStream_t>(stream)>>>(
      e, off, o, n_rows, R, W);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int ns_probe_window_op(const int* wq, const float* wv, const int* wd,
                                  float* o, int Q, int T, int W, void* stream) {
  if (W > WIN_MAX) return static_cast<int>(cudaErrorInvalidValue);
  window_op_kernel<<<probe_tiles(Q, T), dim3(PTS, PTS), 0,
                     static_cast<cudaStream_t>(stream)>>>(wq, wv, wd, o, Q, T, W);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int ns_probe_copy(const float* a, float* o, long long n, void* stream) {
  const long long n4 = n / 4;
  long long blocks = (n4 + 255) / 256;
  if (blocks < 1) blocks = 1;
  if (blocks > 65535) blocks = 65535;
  copy_kernel<<<static_cast<unsigned int>(blocks), 256, 0,
                static_cast<cudaStream_t>(stream)>>>(
      reinterpret_cast<const float4*>(a), reinterpret_cast<float4*>(o), n4);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int ns_probe_transpose(const float* a, float* o, int R, int C,
                                  void* stream) {
  transpose_kernel<<<probe_tiles(R, C), dim3(PTS, PTS), 0,
                     static_cast<cudaStream_t>(stream)>>>(a, o, R, C);
  return static_cast<int>(cudaGetLastError());
}
