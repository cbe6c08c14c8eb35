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
// ns_mix_lists     the pre-pass of K1, K5, K6 and P6 (no TPU counterpart):
//                  each mix row's nonzero entries, after the bf16 rounding
//                  the product applies, as a count and (column, value) lists
//                  in ascending column order; where the product rounds mix,
//                  also the whole row rounded to bf16 and zero-padded to a
//                  multiple of 32 columns, the tensor-core kernel's A operand.
// ns_heavy_fused3  replaces nextsearch_tpu/ops/heavy_pallas.py
//                  heavy_fused3_pallas (K1) and heavy_fused_pallas (K6): H =
//                  mix @ table with the per-128-doc sub-block max (smax) and
//                  the per-2048-doc tile count of H > 0 (cnt) computed from
//                  the same sums, H stored f32 or bf16 rounded up. The TPU's
//                  2D (K6) and 3D (K1) kernels differ only in how Mosaic
//                  tiles the table; on Hopper both are these kernels: a
//                  gather over each query's nonzero mix entries, and for
//                  64-query blocks with long lists a dense product, on the
//                  tensor cores (heavy_dense_tc_kernel) where the operands
//                  are bf16 values and as an fp32 FFMA loop
//                  (heavy_dense_exact_kernel) in f32-exact mode.
// ns_heavy_variant replaces benchmarks/probe_fusedmm.py fused_variant (P6):
//                  the one-pass product with the epilogue, the smax store or
//                  the H store taken out, or H stored bf16 to nearest.
// ns_gather_rows   replaces gather_rows_pallas (K3, f32 or bf16 rows kept in
//                  their type) and gather_rows_bf16_pallas (K2, f32 rows to
//                  bf16): table[ids] as whole-row copies. K2 converts in
//                  registers (gather_rows_kernel); K3 copies bytes with
//                  eight loads in flight per thread
//                  (gather_rows_unrolled_kernel).
// ns_unified_fused replaces unified_fused_pallas (K5): K1's product plus the
//                  light entries (doc, q, value) of each tile added into it,
//                  with K1's smax/cnt epilogue taken of the summed totals.
// ns_per_query_topk replaces nextsearch_tpu/ops/select_pallas.py
//                  per_query_topk_pallas (K4): for each query q, the k2
//                  largest positive values of scores[bounds[q]:bounds[q+1]],
//                  as exact f32 values and global flat indices, ties going
//                  to the lowest index, zeros past the live entries: a
//                  one-pass threshold select (per_query_select_kernel).
// ns_score_epilogue ports XLA's fusion of the fused mode's passes over the
//                  [Q, n_slots] score array after the heavy product
//                  (nextsearch_tpu/ops/bm25.py:300-301/358-359/232; no
//                  Pallas kernel): scores += H in place, found = the count
//                  of scores > 0, and tiled_topk's per-2048-doc tile max,
//                  in one pass (score_epilogue_kernel).
// ns_probe_*       replace benchmarks/mosaic_probe.py's lowering probes
//                  P1-P5 (t1/k1 .. t5/k5): nt_dot (o = a . b^T), row_copy
//                  (2 * e[off[0]] at an index read on the device),
//                  window_op (a scatter-add of W entries, one block per
//                  band of output rows: window_band_kernel), copy (the
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
constexpr int TM = 8;        // queries per thread
constexpr int TN = 4;        // docs per thread
constexpr int THREADS = 256; // (BM / TM) * (CSUB / TN)
constexpr int GATHER_CUT = 32;  // longest mix list a block gathers over

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

// Four consecutive H values of one query row, as a streaming store
// (evict-first): H is 2 GB a launch, written once and read back only in
// small parts by later kernels, and would otherwise push the table tiles
// that the other q-blocks are about to read out of the 50 MB L2.
template <int HST>
__device__ __forceinline__ void store_h4(void* h, long long i, float a, float b,
                                         float c, float d) {
  if constexpr (HST == H_F32) {
    __stcs(reinterpret_cast<float4*>(static_cast<float*>(h) + i),
           make_float4(a, b, c, d));
  } else {
    uint2 raw;
    if constexpr (HST == H_BF16_UP) {
      raw.x = bf16_up_bits(a) | (bf16_up_bits(b) << 16);
      raw.y = bf16_up_bits(c) | (bf16_up_bits(d) << 16);
    } else {
      raw.x = bf16_rn_bits(a) | (bf16_rn_bits(b) << 16);
      raw.y = bf16_rn_bits(c) | (bf16_rn_bits(d) << 16);
    }
    __stcs(reinterpret_cast<uint2*>(static_cast<__nv_bfloat16*>(h) + i), raw);
  }
}

// Four consecutive table values widened to f32 (16 bytes of f32 or 8 of
// bf16), through the read-only data cache: no kernel here writes what it
// reads.
__device__ __forceinline__ void load4(const float* p, float* v) {
  const float4 a = __ldg(reinterpret_cast<const float4*>(p));
  v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w;
}

__device__ __forceinline__ void load4(const __nv_bfloat16* p, float* v) {
  const uint2 raw = __ldg(reinterpret_cast<const uint2*>(p));
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&raw);
  const float2 a = __bfloat1622float2(h[0]);
  const float2 b = __bfloat1622float2(h[1]);
  v[0] = a.x; v[1] = a.y; v[2] = b.x; v[3] = b.y;
}

// The pre-pass of the heavy product: one warp per mix row writes the row's
// nonzero entries, rounded to bf16 when ROUND (where the product rounds
// mix), in ascending column order: each 32-column step compacts its nonzero
// lanes with a ballot and a population count of the lanes below. count[q] is
// the row's whole nonzero count, which may exceed the capacity L: entries
// past L are dropped, and the product takes its dense kernel for that row's
// block. Slots past the count are zeroed. With mixb (ROUND only) it also
// writes the rounded row as bf16 into mixb[q, 0:ND_pad], zero past ND (ND_pad
// a multiple of 32): the A operand of heavy_dense_tc_kernel, which then
// copies it with cp.async and never touches the f32 mix. Bound: one read of
// mix.
template <bool ROUND>
__global__ void mix_lists_kernel(const float* __restrict__ mix, int Q, int ND,
                                 int L, int* __restrict__ count,
                                 int* __restrict__ cols,
                                 float* __restrict__ vals,
                                 __nv_bfloat16* __restrict__ mixb, int ND_pad) {
  const int q = (blockIdx.x * blockDim.x + threadIdx.x) >> 5;
  const int lane = threadIdx.x & 31;
  if (q >= Q) return;  // whole warps leave together
  const float* row = mix + (long long)q * ND;
  int* qcols = cols + (long long)q * L;
  float* qvals = vals + (long long)q * L;
  int n = 0;
  const int c_end = mixb != nullptr ? ND_pad : ND;
  for (int c0 = 0; c0 < c_end; c0 += 32) {
    const int c = c0 + lane;
    float v = c < ND ? row[c] : 0.f;
    if constexpr (ROUND) {
      v = round_bf16(v);
      if (mixb != nullptr && c < ND_pad)
        mixb[(long long)q * ND_pad + c] = __float2bfloat16_rn(v);
    }
    const bool nz = v != 0.f;
    const unsigned int m = __ballot_sync(0xffffffffu, nz);
    const int at = n + __popc(m & ((1u << lane) - 1u));
    if (nz && at < L) {
      qcols[at] = c;
      qvals[at] = v;
    }
    n += __popc(m);
  }
  for (int at = n + lane; at < L; at += 32) {
    qcols[at] = 0;
    qvals[at] = 0.f;
  }
  if (lane == 0) count[q] = n;
}

// The heavy product's tile: a block computes a BM-query x 128-doc tile of H.
// The tile's column is one selection sub-block, so the block owns
// smax[sub, q0:q0+BM] outright and writes it without atomics; a warp holds
// 8 query rows and a lane 4 docs of each.
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
// Three kernels compute the tiles, each taking the 64-query blocks
// (q-blocks) that the mix lists' counts (mix_lists_kernel) give it, on the
// device, never by a host sync; a launch runs the gather kernel and one of
// the dense kernels, and each leaves the other's q-blocks alone:
//
// - heavy_gather_kernel, for a q-block whose queries all have at most L <=
//   GATHER_CUT nonzero mix entries: for each entry of a query a lane adds
//   val * table[col][its 4 docs] into its sums, a 16-byte (f32) or 8-byte
//   (bf16) read per lane and a 512- or 256-byte read per warp. Serving mixes
//   hold one entry per heavy term of a query (1-4 of 384-1877 columns), so
//   this leaves out the >99% of the dense loop's FMAs that multiply by
//   zero. The kernel is latency-bound per warp (a list read, then the table
//   read it names), so it keeps few registers for many warps per SM, and
//   works two queries at a time with up to GCHUNK entries' reads in flight
//   each.
// - heavy_dense_tc_kernel, for the other q-blocks (e.g. the probes' dense
//   torch.rand mixes) where both operands are bf16 values (FAST, or a bf16
//   table): the product on the tensor cores, described above the kernel.
// - heavy_dense_exact_kernel, for the other q-blocks in f32-exact mode (f32
//   table, !FAST), where no tensor-core form gives fp32 products: an FFMA
//   loop fed by cp.async, described above the kernel.
//
// All run over a grid of (sub-block, q-block) tiles, q-blocks minor, so
// the q-blocks of one sub-block run together and each table slab the batch
// uses comes from device memory once and from L2 after; a block whose
// q-block is another kernel's reads its counts and leaves. The dense
// kernels are separate so that their register budgets do not rise to hold
// the gather's state; a persistent grid over the dense q-blocks only was
// tried and measured slower on the card for both paths.
//
// The gather and the f32-exact FFMA loop give the same bits: the gather
// runs the loop's fmaf(mix[k], table[k][d], acc) chain over the same k in
// the same ascending order, only without the k where mix[k] is 0, and for
// finite table values fmaf(0, x, acc) == acc (acc starts at +0 and never
// becomes -0, since an exact zero sum rounds to +0). The tensor-core kernel
// multiplies the same bf16 values (each product exact in f32) but sums them
// in the tensor cores' order and with their accumulation, which rounds
// toward zero once per 16-term mma step, so its H agrees with the gather's
// within a tolerance ((ND / 8 + 8) * 2^-23 relative in the tests: ND / 16
// steps of 2^-23 over non-negative terms, doubled for the other side), while
// H > 0, and with it cnt, is the same in all three: the operands are
// non-negative, so a sum is positive exactly when one product is. No
// reported score comes from H: the exact rescore recomputes them.
//
// Bound: device memory for the gather. It needs the table rows the batch's
// mix uses (each once) and H written once; at the 1M-doc serving shapes
// that is ~0.8 GB of bf16 (fast) or ~1.5 GB of f32 (exact) table plus 2 GB
// of f32 H, 0.85-1.1 ms at 3.35 TB/s, and ~2.6 GFLOP of FMAs. An FFMA
// dense loop, at the probes' dense mixes, is bound by FP32 FFMA throughput
// (393 GFLOP at Q 512, ND 384, 1M docs: 5.9 ms at 67 TFLOP/s); on the
// tensor cores the same product is 0.40 ms, and the kernel is bound by the
// 2 GB H store.
//
// ENTRIES (K5, the unified-totals kernel): the TPU kernel folded the light
// entries into its tile with 3-way bf16-split one-hot matmuls, because the
// MXU was its only fast adder and Mosaic could only DMA aligned 8x128 entry
// windows. Here the entry stream is plain (doc, q, value) arrays sorted by
// (doc, q), with per-sub-block offsets (ent_off): the block walks its
// sub-block's entries, skips those of other query blocks, and the thread at
// the start of each (q, doc) run adds the run's stream-order sum once into
// a tile in shared memory; each cell then gets product + run sum. Runs
// never share a cell, so the adds need no atomics and two launches give
// identical bits. The gather kernel folds the runs into a zeroed tile
// before the product (so each row's epilogue follows its product, as in
// K1; + 0 leaves a sum as it is); the dense kernel parks its product there
// and adds the runs after. The entries are a few per sub-block at the
// serving shapes, but their walk (a few dependent reads) and its barriers
// sit in series with the gather's own reads.

constexpr int GCHUNK = 4;        // entries of one query read together

// The mix lists of mix_lists_kernel: count [Q], columns and values [Q, L].
struct Lists {
  const int* cnt;
  const int* col;
  const float* val;
  int L;
};

// The entry stream of K5 (all null otherwise).
struct Entries {
  const int* doc;
  const int* q;
  const float* val;
  const int* off;
};

// Where a tile's results go: H, smax, cnt, and P6's EPI_REDUCED block maxima.
struct Outs {
  void* h;
  float* smax;
  float* cnt;
  float* part;
  int store_h;
  int epi;
};

// The epilogue of one query row of a tile from its f32 sums (this lane's 4
// docs in a0..a3): the H store, then the sub-block max and positive count as
// warp reductions (the warp holds the row's 128 docs; the values are not
// NaN). Counts are small
// integers, so the f32 atomic add into the tile's count is exact in any
// order. Under P6's EPI_REDUCED the row's max folds into bmax instead of
// its smax store. q is the same in the whole warp.
template <int HST, bool VARIANT>
__device__ __forceinline__ void row_epilogue(float a0, float a1, float a2,
                                             float a3, int q, int Q,
                                             long long sub, long long d0,
                                             int tx, long long n_slots,
                                             const Outs& o, float& bmax) {
  const bool write_h = !VARIANT || o.store_h;
  const bool epi_on = !VARIANT || o.epi != EPI_NONE;
  const bool per_query = !VARIANT || o.epi == EPI_FULL;
  if (q < Q) {
    const long long at = (long long)q * n_slots + d0 + tx * TN;
    if (write_h)
      store_h4<HST>(o.h, at, a0, a1, a2, a3);
    else
      store_h4<HST>(o.h, at, 0.f, 0.f, 0.f, 0.f);
  }
  if (!epi_on) return;
  // One redux.sync each, in place of five shuffle steps (an SM issues one
  // warp shuffle a clock, and a launch has 4M rows): the max through an
  // order-preserving integer key, the sign bit flipped for non-negative
  // values and all bits for negative ones.
  const uint32_t bits = __float_as_uint(fmaxf(fmaxf(a0, a1), fmaxf(a2, a3)));
  const uint32_t key = __reduce_max_sync(
      0xffffffffu, bits ^ ((bits >> 31) ? 0xffffffffu : 0x80000000u));
  const float mx =
      __uint_as_float(key ^ ((key >> 31) ? 0x80000000u : 0xffffffffu));
  const int c = __reduce_add_sync(
      0xffffffffu, (a0 > 0.f) + (a1 > 0.f) + (a2 > 0.f) + (a3 > 0.f));
  if (q < Q && tx == 0) {
    if (per_query) o.smax[sub * Q + q] = mx;
    else bmax = fmaxf(bmax, mx);
    atomicAdd(o.cnt + (sub / CPT) * Q + q, static_cast<float>(c));
  }
}

// P6's EPI_REDUCED: the block's tile maximum (lane 0 of each warp holds its
// rows' share in bmax) into part[sub * n_qblk + qb]. Every thread calls it.
template <bool VARIANT>
__device__ __forceinline__ void block_max(float bmax, const Outs& o,
                                          long long sub, int qb, int n_qblk) {
  if constexpr (VARIANT) {
    if (o.epi == EPI_REDUCED) {
      __shared__ float wmax[THREADS / 32];
      const int tid = threadIdx.x;
      if ((tid & 31) == 0) wmax[tid >> 5] = bmax;
      __syncthreads();
      if (tid == 0) {
        float m = wmax[0];
        for (int w = 1; w < THREADS / 32; ++w) m = fmaxf(m, wmax[w]);
        o.part[sub * n_qblk + qb] = m;
      }
      __syncthreads();  // wmax is free for the next tile
    }
  }
}

// K5: add the sub-block's light entries of the tile's ROWS queries into the
// tile Ts (rows LD floats apart; see ENTRIES above). Every thread calls it
// between two barriers.
template <int ROWS, int LD>
__device__ __forceinline__ void add_entries(float* Ts, const Entries& ent,
                                            long long sub, int q0, long long d0) {
  const int e0 = ent.off[sub];
  const int e1 = ent.off[sub + 1];
  for (int e = e0 + threadIdx.x; e < e1; e += blockDim.x) {
    const int d = ent.doc[e];
    const int q = ent.q[e];
    // other query blocks' entries; the sentinel doc n_slots lies past every
    // sub-block, so it never lands on a tile's padding docs
    if (q < q0 || q >= q0 + ROWS || d < d0 || d >= d0 + CSUB) continue;
    if (e > e0 && ent.doc[e - 1] == d && ent.q[e - 1] == q) continue;
    float run = ent.val[e];
    for (int j = e + 1; j < e1 && ent.doc[j] == d && ent.q[j] == q; ++j)
      run += ent.val[j];
    Ts[(q - q0) * LD + (d - d0)] += run;
  }
}

// Whether this block's q-block holds a list longer than L (the dense
// kernel's tile). Every thread calls it; it is also a barrier.
__device__ __forceinline__ bool dense_qblock(const Lists& lists, int q0, int Q) {
  const int q = q0 + threadIdx.x;
  const bool longer = threadIdx.x < BM && q < Q && __ldg(lists.cnt + q) > lists.L;
  return __syncthreads_or(longer) != 0;
}

template <bool FAST, typename TabT, bool ENTRIES, int HST, bool VARIANT>
__global__ void __launch_bounds__(THREADS, 4)
heavy_gather_kernel(const TabT* __restrict__ table, const Lists lists,
                    const Entries ent, const Outs out, int Q, long long n_slots,
                    int n_qblk) {
  __shared__ __align__(16) float Ts[ENTRIES ? BM : 1][CSUB];
  const int tid = threadIdx.x;
  const int qb = blockIdx.x % n_qblk;
  const long long sub = blockIdx.x / n_qblk;
  const int q0 = qb * BM;
  const long long d0 = sub * CSUB;
  const int tx = tid & 31;
  const int ty = tid >> 5;
  if (dense_qblock(lists, q0, Q)) return;  // a dense kernel's tile
  if constexpr (ENTRIES) {
    // K5: the light entries' run sums first, into a zeroed tile, so that
    // each row's product takes its entries and its epilogue at once
    float4* t4 = reinterpret_cast<float4*>(&Ts[0][0]);
    for (int i = tid; i < BM * CSUB / 4; i += THREADS)
      t4[i] = make_float4(0.f, 0.f, 0.f, 0.f);
    __syncthreads();
    add_entries<BM, CSUB>(&Ts[0][0], ent, sub, q0, d0);
    __syncthreads();
  }

  const int L = lists.L;
  const TabT* tab = table + d0 + tx * TN;
  float bmax = __int_as_float(0xff800000);  // -inf
  for (int i = 0; i < TM; i += 2) {
    int q[2], n[2];
#pragma unroll
    for (int p = 0; p < 2; ++p) {
      q[p] = q0 + ty * TM + i + p;
      n[p] = q[p] < Q ? __ldg(lists.cnt + q[p]) : 0;
    }
    float acc[2][TN];
#pragma unroll
    for (int p = 0; p < 2; ++p)
#pragma unroll
      for (int j = 0; j < TN; ++j) acc[p][j] = 0.f;
    const int n_max = n[0] > n[1] ? n[0] : n[1];
    for (int e0 = 0; e0 < n_max; e0 += GCHUNK) {
      float t[2][GCHUNK][TN];
      float v[2][GCHUNK];
#pragma unroll
      for (int p = 0; p < 2; ++p)
#pragma unroll
        for (int u = 0; u < GCHUNK; ++u) {
          if (e0 + u < n[p]) {
            const long long at = (long long)q[p] * L + e0 + u;
            v[p][u] = __ldg(lists.val + at);
            load4(tab + (long long)__ldg(lists.col + at) * n_slots, t[p][u]);
          }
        }
#pragma unroll
      for (int p = 0; p < 2; ++p)
#pragma unroll
        for (int u = 0; u < GCHUNK; ++u) {
          if (e0 + u < n[p]) {
#pragma unroll
            for (int j = 0; j < TN; ++j) {
              float x = t[p][u][j];
              if constexpr (FAST && sizeof(TabT) == 4) x = round_bf16(x);
              acc[p][j] = fmaf(v[p][u], x, acc[p][j]);
            }
          }
        }
    }
#pragma unroll
    for (int p = 0; p < 2; ++p) {
      if constexpr (ENTRIES) {
        // the product, then its cell's run sum once (0 where none: exact)
        const float4 e =
            *reinterpret_cast<const float4*>(&Ts[ty * TM + i + p][tx * TN]);
        acc[p][0] += e.x;
        acc[p][1] += e.y;
        acc[p][2] += e.z;
        acc[p][3] += e.w;
      }
      row_epilogue<HST, VARIANT>(acc[p][0], acc[p][1], acc[p][2], acc[p][3],
                                 q[p], Q, sub, d0, tx, n_slots, out, bmax);
    }
  }
  block_max<VARIANT>(bmax, out, sub, qb, n_qblk);
}

// The dense product on the tensor cores, for bf16 operands.
//
// Replaces, for dense mixes, the bodies of the TPU kernels K1 _make_kernel3,
// K5 _make_unified_kernel and K6 _make_kernel
// (nextsearch_tpu/ops/heavy_pallas.py) and P6 (benchmarks/probe_fusedmm.py
// fused_variant), which run the product on the MXU, one bf16 pass in fast
// mode. Both operands are bf16 values, so every product is exact in f32 and
// only the order and rounding of the f32 sums differ from the gather's.
//
// Bound: bytes. At K6's shapes (Q 512, ND 384, 1M docs) the product is 393
// GFLOP, 0.40 ms at the bf16 peak, against 2.05 GB of f32 H to store and
// 0.77 GB of table to read, 0.85 ms at 3.35 TB/s. What the design does
// about it:
//
// - A block computes 128 queries (two q-blocks) x 128 docs (one selection
//   sub-block), so that the table tile is read from L2 once per two
//   q-blocks: with 64-query tiles the L2 reads of the operands (9 GB at
//   K6's shapes) cost more than the H store.
// - The operands come through a ring of TC_STAGES stages of TC_BK
//   contraction rows, filled by cp.async (16 bytes a thread; rows past Q or
//   ND are zero-filled by a copy of size 0, never read), so copies are in
//   flight while the product runs. A is the bf16 mix that the pre-pass
//   wrote (mixb, [Q, ND_pad] row-major); B is the table, [ND, n_slots]
//   row-major, i.e. doc-contiguous, which mma's "col" operand takes through
//   ldmatrix.trans. An f32 table (FAST) cannot be copied asynchronously: it
//   passes through registers, rounded to bf16 on the way. Shared-memory
//   rows are padded by 16 bytes so that the 8 rows of an ldmatrix fall into
//   8 different bank groups.
// - The product is mma.sync.m16n8k16 (bf16 in, f32 out) fed by ldmatrix:
//   8 warps as 2 x 4, a warp holding 64 queries x 32 docs in 64 registers.
//   The kernel is bound by bytes, and mma.sync's share of the tensor cores'
//   rate covers 393 GFLOP in well under the 0.85 ms of bytes. wgmma, whose
//   products run asynchronously beside the warps' other work, would need
//   the doc-contiguous table tile in a swizzled layout behind a transposing
//   descriptor; it is the next step where the product and the stores are to
//   overlap inside one block.
// - The epilogue does not run from the fragments (a row's 128 docs are
//   spread over 4 warps and 4 lanes of each): the tile is staged in shared
//   memory (the ring's, free by then), K5's entries are added there, and
//   then a warp takes whole query rows: 16 bytes a lane, 512 contiguous
//   bytes of H a warp, and the row's max and positive count by shuffles,
//   exactly K1's row_epilogue, so smax is the max of the f32 values H is
//   stored from and cnt their positive count. Two blocks fit an SM (about
//   125 registers, 76 KB of shared memory). Measured on an H100 at K6's
//   shapes the launch takes 2.0 ms, of which the product alone is 1.5: the
//   two phases of co-resident blocks hardly overlap. Other tiles (64 x 64
//   or 32 x 32 a warp, 64-row stages) read the same within 5%, and a
//   persistent block per SM that stores the previous tile's rows between
//   the next tile's mma steps was 20-35% slower (half the warps per SM), so
//   it was not kept.
constexpr int TC_BM = 2 * BM;           // queries per block
constexpr int TC_BK = 32;               // contraction rows per stage
constexpr int TC_STAGES = 4;
constexpr int TC_WM = 2;                // warps along the queries
constexpr int TC_WN = 4;                // warps along the docs
constexpr int TC_WARPS = TC_WM * TC_WN;
constexpr int TC_THREADS = TC_WARPS * 32;
constexpr int TC_MT = TC_BM / TC_WM / 16;  // 16-query mma tiles per warp
constexpr int TC_NT = CSUB / TC_WN / 8;    // 8-doc mma tiles per warp
constexpr int TC_A_LD = TC_BK + 8;      // bf16 per A row in shared memory
constexpr int TC_B_LD = CSUB + 8;       // bf16 per B row
constexpr int TC_T_LD = CSUB + 8;       // f32 per row of the staged tile
constexpr int TC_A_BYTES = TC_BM * TC_A_LD * 2;
constexpr int TC_B_BYTES = TC_BK * TC_B_LD * 2;
constexpr int TC_STAGE_BYTES = TC_A_BYTES + TC_B_BYTES;
constexpr int TC_RING_BYTES = TC_STAGES * TC_STAGE_BYTES;
constexpr int TC_TILE_BYTES = TC_BM * TC_T_LD * 4;
constexpr int TC_SMEM_BYTES =
    TC_RING_BYTES > TC_TILE_BYTES ? TC_RING_BYTES : TC_TILE_BYTES;

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes from device memory to shared memory, or 16 zero bytes when !ok
// (the source is then not read).
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src, bool ok) {
  const int n = ok ? 16 : 0;
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(src), "r"(n)
               : "memory");
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr)
               : "memory");
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4], uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr)
      : "memory");
}

// c += a (16 x 16, row-major fragments) * b (16 x 8, "col" fragments).
__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Which of a 128-query tile's two q-blocks hold a list longer than L (the
// dense kernels' tiles): the others are the gather kernel's, computed by
// the tile's block but never stored. Every thread calls it (it holds two
// barriers); false when neither half is dense.
__device__ __forceinline__ bool dense_halves(const Lists& lists, int q0, int Q,
                                             bool& lo, bool& hi) {
  const int tid = threadIdx.x;
  const bool longer = tid < TC_BM && q0 + tid < Q &&
                      __ldg(lists.cnt + q0 + tid) > lists.L;
  lo = __syncthreads_or(longer && tid < BM) != 0;
  hi = __syncthreads_or(longer && tid >= BM) != 0;
  return lo || hi;
}

// The epilogue of a 128 x 128 tile staged in shared memory (Ts, rows
// TC_T_LD floats apart, written by the whole block just before): K5's
// entries are added there, then each warp takes whole query rows (the first
// half of the warps the low q-block's, the second half the high one's): 16
// bytes a lane, 512 contiguous bytes of H a warp, and the row's max and
// positive count by shuffles (row_epilogue). Every thread of a TC_THREADS
// block calls it; returns the thread's share of P6's tile maximum.
template <bool ENTRIES, int HST, bool VARIANT>
__device__ __forceinline__ float staged_epilogue(float* Ts, const Entries& ent,
                                                 const Outs& out, bool dense_lo,
                                                 bool dense_hi, int q0, int Q,
                                                 long long sub,
                                                 long long n_slots) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const long long d0 = sub * CSUB;
  __syncthreads();
  if constexpr (ENTRIES) {
    add_entries<TC_BM, TC_T_LD>(Ts, ent, sub, q0, d0);
    __syncthreads();
  }
  float bmax = __int_as_float(0xff800000);  // -inf
  if (warp < TC_WARPS / 2 ? dense_lo : dense_hi) {
    constexpr int ROWS = TC_BM / TC_WARPS;
#pragma unroll 4
    for (int i = 0; i < ROWS; ++i) {
      const int r = warp * ROWS + i;
      const float4 v = *reinterpret_cast<const float4*>(Ts + r * TC_T_LD + lane * TN);
      row_epilogue<HST, VARIANT>(v.x, v.y, v.z, v.w, q0 + r, Q, sub, d0, lane,
                                 n_slots, out, bmax);
    }
  }
  return bmax;
}

template <typename TabT, bool ENTRIES, int HST, bool VARIANT>
__global__ void __launch_bounds__(TC_THREADS, 2)
heavy_dense_tc_kernel(const __nv_bfloat16* __restrict__ mixb, int ND_pad,
                      const TabT* __restrict__ table, const Lists lists,
                      const Entries ent, const Outs out, int Q, int ND,
                      long long n_slots, int n_qblk) {
  extern __shared__ __align__(128) unsigned char tc_smem[];
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int n_tc = (n_qblk + 1) / 2;
  const int qb2 = blockIdx.x % n_tc;
  const long long sub = blockIdx.x / n_tc;
  const int q0 = qb2 * TC_BM;
  const long long d0 = sub * CSUB;

  bool dense_lo, dense_hi;
  if (!dense_halves(lists, q0, Q, dense_lo, dense_hi)) return;

  const uint32_t ring = smem_addr(tc_smem);
  auto load_stage = [&](int slot, int kt) {
    const int k0 = kt * TC_BK;
    const uint32_t sa = ring + slot * TC_STAGE_BYTES;
    const uint32_t sb = sa + TC_A_BYTES;
#pragma unroll
    for (int i = 0; i < TC_BM * TC_BK / 8 / TC_THREADS; ++i) {
      const int c = tid + i * TC_THREADS;
      const int r = c / (TC_BK / 8);  // 16-byte chunks of 8 values
      const int ch = c % (TC_BK / 8);
      const bool ok = q0 + r < Q;
      cp_async16(sa + (r * TC_A_LD + ch * 8) * 2,
                 mixb + (long long)(ok ? q0 + r : 0) * ND_pad + k0 + ch * 8, ok);
    }
    if constexpr (sizeof(TabT) == 2) {
#pragma unroll
      for (int i = 0; i < TC_BK * CSUB / 8 / TC_THREADS; ++i) {
        const int c = tid + i * TC_THREADS;
        const int r = c >> 4;  // CSUB / 8 = 16 chunks a row
        const int ch = c & 15;
        const bool ok = k0 + r < ND;
        cp_async16(sb + (r * TC_B_LD + ch * 8) * 2,
                   table + (long long)(ok ? k0 + r : 0) * n_slots + d0 + ch * 8,
                   ok);
      }
    } else {
      // f32 rows rounded to bf16 on their way through registers
      unsigned char* bs = tc_smem + slot * TC_STAGE_BYTES + TC_A_BYTES;
#pragma unroll
      for (int i = 0; i < TC_BK * CSUB / 4 / TC_THREADS; ++i) {
        const int c = tid + i * TC_THREADS;
        const int r = c >> 5;  // CSUB / 4 = 32 float4 a row
        const int ch = c & 31;
        float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
        if (k0 + r < ND)
          v = __ldg(reinterpret_cast<const float4*>(
                        table + (long long)(k0 + r) * n_slots + d0) + ch);
        const __nv_bfloat162 lo = __floats2bfloat162_rn(v.x, v.y);
        const __nv_bfloat162 hi = __floats2bfloat162_rn(v.z, v.w);
        uint2 raw;
        raw.x = *reinterpret_cast<const uint32_t*>(&lo);
        raw.y = *reinterpret_cast<const uint32_t*>(&hi);
        *reinterpret_cast<uint2*>(bs + (r * TC_B_LD + ch * 4) * 2) = raw;
      }
    }
  };

  float acc[TC_MT][TC_NT][4];
#pragma unroll
  for (int i = 0; i < TC_MT; ++i)
#pragma unroll
    for (int j = 0; j < TC_NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.f;

  const int wm = warp / TC_WN;  // the warp's 16 * TC_MT queries
  const int wn = warp % TC_WN;  // and its 8 * TC_NT docs
  const int n_k = ND_pad / TC_BK;
#pragma unroll
  for (int s = 0; s < TC_STAGES - 1; ++s) {
    if (s < n_k) load_stage(s, s);
    asm volatile("cp.async.commit_group;\n" ::: "memory");
  }
  for (int kt = 0; kt < n_k; ++kt) {
    // stage kt has landed (this thread's copies, then everyone's), and every
    // warp is done with stage kt - 1, whose slot the next copies take
    asm volatile("cp.async.wait_group %0;\n" ::"n"(TC_STAGES - 2) : "memory");
    __syncthreads();
    if (kt + TC_STAGES - 1 < n_k)
      load_stage((kt + TC_STAGES - 1) % TC_STAGES, kt + TC_STAGES - 1);
    asm volatile("cp.async.commit_group;\n" ::: "memory");
    const uint32_t sa = ring + (kt % TC_STAGES) * TC_STAGE_BYTES;
    const uint32_t sb = sa + TC_A_BYTES;
#pragma unroll
    for (int kk = 0; kk < TC_BK; kk += 16) {
      uint32_t a[TC_MT][4], b[TC_NT / 2][4];
#pragma unroll
      for (int mt = 0; mt < TC_MT; ++mt)
        ldmatrix_x4(a[mt],
                    sa + ((wm * TC_MT * 16 + mt * 16 + (lane & 15)) * TC_A_LD +
                          kk + (lane >> 4) * 8) * 2);
#pragma unroll
      for (int np = 0; np < TC_NT / 2; ++np)
        ldmatrix_x4_trans(b[np],
                          sb + ((kk + (lane & 15)) * TC_B_LD + wn * TC_NT * 8 +
                                np * 16 + (lane >> 4) * 8) * 2);
#pragma unroll
      for (int mt = 0; mt < TC_MT; ++mt)
#pragma unroll
        for (int nt = 0; nt < TC_NT; ++nt)
          mma_bf16(acc[mt][nt], a[mt], b[nt >> 1][(nt & 1) * 2],
                   b[nt >> 1][(nt & 1) * 2 + 1]);
    }
  }
  asm volatile("cp.async.wait_all;\n" ::: "memory");
  __syncthreads();  // the ring is free: stage the tile in its memory

  float* Ts = reinterpret_cast<float*>(tc_smem);
  {
    const int g = lane >> 2;
    const int t = lane & 3;
#pragma unroll
    for (int mt = 0; mt < TC_MT; ++mt)
#pragma unroll
      for (int nt = 0; nt < TC_NT; ++nt) {
        float* p = Ts + (wm * TC_MT * 16 + mt * 16 + g) * TC_T_LD +
                   wn * TC_NT * 8 + nt * 8 + 2 * t;
        *reinterpret_cast<float2*>(p) = make_float2(acc[mt][nt][0], acc[mt][nt][1]);
        *reinterpret_cast<float2*>(p + 8 * TC_T_LD) =
            make_float2(acc[mt][nt][2], acc[mt][nt][3]);
      }
  }
  const float bmax = staged_epilogue<ENTRIES, HST, VARIANT>(
      Ts, ent, out, dense_lo, dense_hi, q0, Q, sub, n_slots);
  if constexpr (VARIANT) {
    if (out.epi == EPI_REDUCED) {
      // each dense q-block's tile maximum, as block_max writes it
      __shared__ float wmax[TC_WARPS];
      if (lane == 0) wmax[warp] = bmax;
      __syncthreads();
      const int qb = qb2 * 2 + tid;
      if (tid < 2 && qb < n_qblk && (tid ? dense_hi : dense_lo)) {
        float m = wmax[tid * (TC_WARPS / 2)];
        for (int w = 1; w < TC_WARPS / 2; ++w)
          m = fmaxf(m, wmax[tid * (TC_WARPS / 2) + w]);
        out.part[sub * n_qblk + qb] = m;
      }
    }
  }
}

// The dense product in f32-exact mode (f32 table, !FAST): fp32 products
// have no tensor-core form that gives these bits, so this is an FFMA loop,
// and it keeps the bits of the gather: each sum runs fmaf(mix[k],
// table[k][d], acc) over ascending k. Bound: operations (FP32 FFMA). The
// feed is what it changes against a plain loop (64 x 128 tiles, 8 x 4 sums
// a thread, load - barrier - multiply - barrier): a 128 x 128 tile with 8 x
// 8 sums a thread (4 16-byte shared-memory reads per 64 FFMAs in place of 3
// per 32), the operands in a ring of EX_STAGES cp.async stages (mix by
// 4-byte copies, stored k-major: its rows are not 16-byte aligned when ND
// is odd), and the tile's epilogue from shared memory, as the tensor-core
// kernel's. Measured on an H100 at K6's shapes over an f32 table: 10.2-10.6
// ms against the plain loop's 11.4-11.7 (cuBLAS fp32: 8.2; the FFMA bound:
// 5.9); 8- and 32-row
// stages and one block per SM without spills read the same within 5%, so
// the feed is no longer what holds it back.
constexpr int EX_BK = 16;
constexpr int EX_STAGES = 3;
constexpr int EX_A_LD = TC_BM + 4;  // f32 per k row of the mix stage
constexpr int EX_A_BYTES = EX_BK * EX_A_LD * 4;
constexpr int EX_B_BYTES = EX_BK * CSUB * 4;
constexpr int EX_STAGE_BYTES = EX_A_BYTES + EX_B_BYTES;
constexpr int EX_SMEM_BYTES = EX_STAGES * EX_STAGE_BYTES > TC_TILE_BYTES
                                  ? EX_STAGES * EX_STAGE_BYTES
                                  : TC_TILE_BYTES;

__device__ __forceinline__ void cp_async4(uint32_t dst, const void* src, bool ok) {
  const int n = ok ? 4 : 0;
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(dst),
               "l"(src), "r"(n)
               : "memory");
}

template <bool ENTRIES, int HST>
__global__ void __launch_bounds__(TC_THREADS, 2)
heavy_dense_exact_kernel(const float* __restrict__ mix,
                         const float* __restrict__ table, const Lists lists,
                         const Entries ent, const Outs out, int Q, int ND,
                         long long n_slots, int n_qblk) {
  static_assert(TC_THREADS == 256, "16 x 16 threads of 8 x 8 sums");
  extern __shared__ __align__(128) unsigned char tc_smem[];
  const int tid = threadIdx.x;
  const int n_tc = (n_qblk + 1) / 2;
  const int qb2 = blockIdx.x % n_tc;
  const long long sub = blockIdx.x / n_tc;
  const int q0 = qb2 * TC_BM;
  const long long d0 = sub * CSUB;
  bool dense_lo, dense_hi;
  if (!dense_halves(lists, q0, Q, dense_lo, dense_hi)) return;

  const uint32_t ring = smem_addr(tc_smem);
  auto load_stage = [&](int slot, int kt) {
    const int k0 = kt * EX_BK;
    const uint32_t sa = ring + slot * EX_STAGE_BYTES;
    const uint32_t sb = sa + EX_A_BYTES;
#pragma unroll
    for (int i = 0; i < TC_BM * EX_BK / TC_THREADS; ++i) {
      const int c = tid + i * TC_THREADS;
      const int m = c / EX_BK;  // neighbouring threads along a mix row
      const int k = c % EX_BK;
      const bool ok = q0 + m < Q && k0 + k < ND;
      cp_async4(sa + (k * EX_A_LD + m) * 4,
                mix + (ok ? (long long)(q0 + m) * ND + k0 + k : 0), ok);
    }
#pragma unroll
    for (int i = 0; i < EX_BK * CSUB / 4 / TC_THREADS; ++i) {
      const int c = tid + i * TC_THREADS;
      const int r = c >> 5;  // CSUB / 4 = 32 chunks a row
      const int ch = c & 31;
      const bool ok = k0 + r < ND;
      cp_async16(sb + (r * CSUB + ch * 4) * 4,
                 table + (long long)(ok ? k0 + r : 0) * n_slots + d0 + ch * 4, ok);
    }
  };

  // queries ty * 8 .. + 7; docs tx * 4 .. + 3 and 64 + tx * 4 .. + 3, so
  // that 16 lanes read 256 contiguous bytes of a table row
  const int tx = tid & 15;
  const int ty = tid >> 4;
  float acc[8][8];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;

  const int n_k = (ND + EX_BK - 1) / EX_BK;
#pragma unroll
  for (int s = 0; s < EX_STAGES - 1; ++s) {
    if (s < n_k) load_stage(s, s);
    asm volatile("cp.async.commit_group;\n" ::: "memory");
  }
  for (int kt = 0; kt < n_k; ++kt) {
    asm volatile("cp.async.wait_group %0;\n" ::"n"(EX_STAGES - 2) : "memory");
    __syncthreads();
    if (kt + EX_STAGES - 1 < n_k)
      load_stage((kt + EX_STAGES - 1) % EX_STAGES, kt + EX_STAGES - 1);
    asm volatile("cp.async.commit_group;\n" ::: "memory");
    const float* As = reinterpret_cast<const float*>(
        tc_smem + (kt % EX_STAGES) * EX_STAGE_BYTES);
    const float* Bs = As + EX_A_BYTES / 4;
#pragma unroll
    for (int kk = 0; kk < EX_BK; ++kk) {
      const float4 a0 = *reinterpret_cast<const float4*>(As + kk * EX_A_LD + ty * 8);
      const float4 a1 =
          *reinterpret_cast<const float4*>(As + kk * EX_A_LD + ty * 8 + 4);
      const float4 b0 = *reinterpret_cast<const float4*>(Bs + kk * CSUB + tx * 4);
      const float4 b1 =
          *reinterpret_cast<const float4*>(Bs + kk * CSUB + 64 + tx * 4);
      const float a[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
      const float b[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
  }
  asm volatile("cp.async.wait_all;\n" ::: "memory");
  __syncthreads();  // the ring is free: stage the tile in its memory

  float* Ts = reinterpret_cast<float*>(tc_smem);
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    float* p = Ts + (ty * 8 + i) * TC_T_LD + tx * 4;
    *reinterpret_cast<float4*>(p) =
        make_float4(acc[i][0], acc[i][1], acc[i][2], acc[i][3]);
    *reinterpret_cast<float4*>(p + 64) =
        make_float4(acc[i][4], acc[i][5], acc[i][6], acc[i][7]);
  }
  staged_epilogue<ENTRIES, HST, false>(Ts, ent, out, dense_lo, dense_hi, q0, Q,
                                       sub, n_slots);
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

// K2: out[u, :] = table[ids[u], :] converted to OutT. Pure data movement,
// bound by device memory bandwidth: each step moves one 16-byte vector of
// the source row (4 f32 values), neighbouring threads on neighbouring
// addresses, rows spread over gridDim.y. Row ids are clamped to the table,
// as the JAX caller clips them before its gather. InT/OutT: f32/bf16 only;
// the same-type gathers (K3) are gather_rows_unrolled_kernel's.
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
      store4(dst + 4 * i, __ldg(reinterpret_cast<const float4*>(src) + i));
    }
  }
}

// K3 on this card: the same-type gathers are byte copies, bound by device
// memory (each row read once and written once), so a design can only try to
// keep enough bytes in flight per SM with as few instructions as possible.
// On an H100 this kernel, a copy of one 16-byte load per step, a
// shared-memory ring of cp.async.bulk copies (tried, 1-5% slower, not kept)
// and index_select move the sparse and fused paths' rows (272-448 rows of
// 2-4 MB) within 2% of each other, at about 85% of the card's memory rate:
// the copy is at what the memory system gives a kernel that reads and writes
// at once, not at what a thread can keep in flight.
//
// The register path of the same copy: each thread starts UNROLL independent
// 16-byte loads (read-only path, not allocated in L1) before its first store,
// so UNROLL times as many bytes are in flight per thread as in a copy of
// one load per step, and stores them streaming (evict-first), so the copy
// does not push the table rows that later kernels of the batch read out of L2.
constexpr int GATHER_UNROLL = 8;

__device__ __forceinline__ uint4 ld_stream16(const uint4* p) {
  uint4 v;
  asm volatile("ld.global.nc.L1::no_allocate.v4.u32 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(v.x), "=r"(v.y), "=r"(v.z), "=r"(v.w)
               : "l"(p));
  return v;
}

__global__ void __launch_bounds__(256)
gather_rows_unrolled_kernel(const int* __restrict__ ids,
                            const uint4* __restrict__ table,
                            uint4* __restrict__ out, int n_ids, int n_rows,
                            long long nv) {
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (int u = blockIdx.y; u < n_ids; u += gridDim.y) {
    int r = ids[u];
    r = r < 0 ? 0 : (r >= n_rows ? n_rows - 1 : r);
    const uint4* src = table + (long long)r * nv;
    uint4* dst = out + (long long)u * nv;
    long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
    for (; i + (GATHER_UNROLL - 1) * stride < nv; i += GATHER_UNROLL * stride) {
      uint4 v[GATHER_UNROLL];
#pragma unroll
      for (int j = 0; j < GATHER_UNROLL; ++j) v[j] = ld_stream16(src + i + j * stride);
#pragma unroll
      for (int j = 0; j < GATHER_UNROLL; ++j) __stcs(dst + i + j * stride, v[j]);
    }
    for (; i < nv; i += stride) __stcs(dst + i, ld_stream16(src + i));
  }
}

struct HeavyArgs {
  const float* mix;
  const __nv_bfloat16* mixb;  // mix_lists' bf16 rows [Q, ND_pad], or null
  int ND_pad;
  const void* table;
  Lists lists;
  Entries ent;
  Outs out;
  int Q;
  int ND;
  long long n_slots;
};

// Opts a kernel into `bytes` (over 48 KB) of dynamic shared memory on the
// current device. cudaFuncSetAttribute acts on the current device only, so
// each kernel asks once per device: `asked` holds a bit per device (a
// device past 63 asks at every launch).
template <typename Kernel>
bool size_smem(Kernel kernel, int bytes, unsigned long long* asked) {
  int dev = 0;
  if (cudaGetDevice(&dev) != cudaSuccess) return false;
  const unsigned long long bit = dev < 64 ? 1ull << dev : 0ull;
  if (bit && (*asked & bit)) return true;
  if (cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           bytes) != cudaSuccess)
    return false;
  *asked |= bit;
  return true;
}

// The gather kernel, then a dense kernel, over grids of the same tiles; each
// computes the tiles of its own q-blocks and leaves the others at once. The
// tensor-core kernel needs more than 48 KB of shared memory, which each of
// its instantiations asks for once per device.
template <bool FAST, typename TabT, bool ENTRIES, int HST, bool VARIANT>
void launch_heavy(const HeavyArgs& a, cudaStream_t stream) {
  const int n_qblk = (a.Q + BM - 1) / BM;
  const unsigned int n_sub = static_cast<unsigned int>(a.n_slots / CSUB);
  const unsigned int grid = n_sub * n_qblk;
  const TabT* table = static_cast<const TabT*>(a.table);
  heavy_gather_kernel<FAST, TabT, ENTRIES, HST, VARIANT>
      <<<grid, THREADS, 0, stream>>>(table, a.lists, a.ent, a.out, a.Q,
                                     a.n_slots, n_qblk);
  if (cudaPeekAtLastError() != cudaSuccess) return;
  if constexpr (FAST || sizeof(TabT) == 2) {
    auto kernel = heavy_dense_tc_kernel<TabT, ENTRIES, HST, VARIANT>;
    static unsigned long long asked = 0;
    if (!size_smem(kernel, TC_SMEM_BYTES, &asked)) return;
    kernel<<<n_sub * ((n_qblk + 1) / 2), TC_THREADS, TC_SMEM_BYTES, stream>>>(
        a.mixb, a.ND_pad, table, a.lists, a.ent, a.out, a.Q, a.ND, a.n_slots,
        n_qblk);
  } else {
    static_assert(!VARIANT, "P6 is the one-pass (bf16 operand) product");
    auto kernel = heavy_dense_exact_kernel<ENTRIES, HST>;
    static unsigned long long asked = 0;
    if (!size_smem(kernel, EX_SMEM_BYTES, &asked)) return;
    kernel<<<n_sub * ((n_qblk + 1) / 2), TC_THREADS, EX_SMEM_BYTES, stream>>>(
        a.mix, table, a.lists, a.ent, a.out, a.Q, a.ND, a.n_slots, n_qblk);
  }
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
// silently cut. Here any window length gives the exact result, by a
// one-pass threshold select. k2 rounds of a block-wide arg-max (one block a
// query, a 64-bit key) would make k2 dependent rounds, each rereading the
// window and crossing two barriers;
// at the serving operands (512 windows of 384 entries on average, k2 = 32)
// that is a latency chain of 32 rounds, bound neither by bytes (0.8 MB,
// below one launch at 3.35 TB/s) nor by arithmetic. What bounds any kernel
// here is launch latency and the chain of dependent barrier steps, so this
// one takes a fixed handful of steps whatever k2 is. One 256-thread block
// owns one query:
//   1. each entry maps to its value key: the float's bits for a positive
//      value (order-preserving) and 0 for a dead one (<= 0, NaN). The keys of
//      a window of up to SEL_TILE entries are staged in shared memory; a
//      longer window is reread from device memory or L2 on each pass. The
//      live entries are counted.
//   2. With more than k2 live, the k2-th largest key is radix-selected 8
//      bits a pass from the top: a shared-memory histogram of the keys that
//      share the prefix found so far, a scan from the top bin, and the bin
//      that holds the k2-th. It stops after a pass whose bin is taken whole.
//   3. Every key whose prefix is above the selected one is a winner. The
//      keys equal to it (equal values, once all 32 bits are fixed) are taken
//      in window order up to the count still missing, by a block prefix
//      count over flags in window order: the lowest-index tie rule without
//      a 64-bit key in the passes.
//   4. The <= k2 winners, in shared memory as (value key, inverted index),
//      are ordered by (value desc, index asc) by a rank count and written,
//      with zeros past them.
constexpr int SELECT_THREADS = 256;
constexpr int SELECT_WARPS = SELECT_THREADS / 32;
constexpr int SEL_TILE = 4096;    // window keys staged in shared memory
constexpr int SEL_K2_MAX = 1024;  // winners held in shared memory
constexpr int SEL_BINS = 256;     // 8 bits a radix pass, one bin a thread
static_assert(SEL_BINS == SELECT_THREADS, "one histogram bin per thread");

__device__ __forceinline__ unsigned int sel_value_key(float v) {
  return v > 0.f ? __float_as_uint(v) : 0u;
}

__device__ __forceinline__ unsigned long long sel_winner(unsigned int key,
                                                         long long i) {
  return (static_cast<unsigned long long>(key) << 32) |
         (0xFFFFFFFFu - static_cast<unsigned int>(i));
}

// Inclusive prefix sum of v over the block by thread index, and the block's
// total. One barrier: the caller alternates `part` (SELECT_WARPS ints) between
// consecutive scans, so no thread overwrites a buffer another still reads.
__device__ __forceinline__ int sel_scan(int v, int* part, int& total) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const int o = __shfl_up_sync(0xffffffffu, v, off);
    if (lane >= off) v += o;
  }
  if (lane == 31) part[warp] = v;
  __syncthreads();
  int before = 0;
  total = 0;
#pragma unroll
  for (int w = 0; w < SELECT_WARPS; ++w) {
    const int p = part[w];
    before += w < warp ? p : 0;
    total += p;
  }
  return v + before;
}

__global__ void __launch_bounds__(SELECT_THREADS)
per_query_select_kernel(const float* __restrict__ scores,
                        const long long* __restrict__ bounds, long long n,
                        int k2, float* __restrict__ vals,
                        long long* __restrict__ gidx) {
  __shared__ unsigned int keys[SEL_TILE];
  __shared__ int hist[2][SEL_BINS];
  __shared__ unsigned long long win[SEL_K2_MAX];
  __shared__ int part[2][SELECT_WARPS];
  __shared__ int pick[3];  // selected bin, keys above it, keys in it
  __shared__ int n_above;
  const int tid = threadIdx.x;
  const int q = blockIdx.x;
  long long s = bounds[q];
  long long e = bounds[q + 1];
  s = s < 0 ? 0 : (s > n ? n : s);
  e = e < s ? s : (e > n ? n : e);
  const long long len = e - s;
  const float* w = scores + s;
  const bool staged = len <= SEL_TILE;
  auto key_at = [&](long long i) {
    return staged ? keys[i] : sel_value_key(w[i]);
  };
  int scans = 0;  // alternates part[] between consecutive scans

  // 1. stage the keys, count the live ones. A staged window's loads are
  // all issued before the first is used: one memory latency, not one per
  // entry a thread holds (a window of 3,370 entries is 14 a thread).
  int live = 0;
  if (staged) {
    float v[SEL_TILE / SELECT_THREADS];
#pragma unroll
    for (int j = 0; j < SEL_TILE / SELECT_THREADS; ++j) {
      const int i = tid + j * SELECT_THREADS;
      v[j] = i < len ? w[i] : 0.f;
    }
#pragma unroll
    for (int j = 0; j < SEL_TILE / SELECT_THREADS; ++j) {
      const int i = tid + j * SELECT_THREADS;
      const unsigned int k = sel_value_key(v[j]);
      if (i < len) keys[i] = k;
      live += k != 0u;
    }
  } else {
    for (long long i = tid; i < len; i += SELECT_THREADS)
      live += sel_value_key(w[i]) != 0u;
  }
  hist[0][tid] = 0;
  if (tid == 0) n_above = 0;
  sel_scan(live, part[scans++ & 1], live);  // its barrier publishes all three
  const int n_win = live < k2 ? live : k2;

  // 2. the k2-th largest key's prefix; tie_need of the keys that share it
  // are winners, out of tie_count
  unsigned int prefix = 0u, mask = 0u;
  int tie_need = n_win, tie_count = live;
  if (live > k2) {
    int rem = k2;
    for (int pass = 0, shift = 24; shift >= 0; ++pass, shift -= 8) {
      int* h = hist[pass & 1];
      for (long long i = tid; i < len; i += SELECT_THREADS) {
        const unsigned int k = key_at(i);
        if (k != 0u && (k & mask) == prefix) atomicAdd(&h[(k >> shift) & 0xFF], 1);
      }
      // the next pass's histogram, last read before the previous barrier
      hist[(pass + 1) & 1][tid] = 0;
      __syncthreads();
      const int bin = SEL_BINS - 1 - tid;  // thread 0 holds the top bin
      const int c = h[bin];
      int total;
      const int incl = sel_scan(c, part[scans++ & 1], total);
      if (incl - c < rem && incl >= rem) {
        pick[0] = bin;
        pick[1] = incl - c;
        pick[2] = c;
      }
      __syncthreads();
      rem -= pick[1];
      tie_count = pick[2];
      prefix |= static_cast<unsigned int>(pick[0]) << shift;
      mask |= 0xFFu << shift;
      if (tie_count == rem) break;  // the bin is taken whole
    }
    tie_need = rem;
  }

  // 3. the winners: every key above the prefix, and the keys that share it,
  // all of them or (a tie cut, once all 32 bits are fixed) the first
  // tie_need in window order
  const bool cut = tie_count > tie_need;
  for (long long i = tid; i < len; i += SELECT_THREADS) {
    const unsigned int k = key_at(i);
    if (k == 0u) continue;
    const unsigned int m = k & mask;
    if (m > prefix || (!cut && m == prefix))
      win[atomicAdd(&n_above, 1)] = sel_winner(k, i);
  }
  if (cut) {
    const int base = n_win - tie_need;  // the slots after the keys above
    int taken = 0;
    for (long long i0 = 0; i0 < len && taken < tie_need; i0 += SELECT_THREADS) {
      const long long i = i0 + tid;
      const int f = i < len && key_at(i) == prefix;
      int total;
      const int r = taken + sel_scan(f, part[scans++ & 1], total) - 1;
      if (f && r < tie_need) win[base + r] = sel_winner(prefix, i);
      taken += total;
    }
  }
  __syncthreads();

  // 4. rank each winner by (value desc, index asc); zeros past them
  const long long row = static_cast<long long>(q) * k2;
  for (int j = tid; j < k2; j += SELECT_THREADS) {
    if (j < n_win) {
      const unsigned long long kj = win[j];
      int rank = 0;
      for (int m = 0; m < n_win; ++m) rank += win[m] > kj;
      vals[row + rank] = __uint_as_float(static_cast<unsigned int>(kj >> 32));
      gidx[row + rank] =
          s + (0xFFFFFFFFu - static_cast<unsigned int>(kj & 0xFFFFFFFFull));
    } else {
      vals[row + j] = 0.f;
      gidx[row + j] = 0;
    }
  }
}

// P1-P5, the lowering probes of benchmarks/mosaic_probe.py: five tiny
// kernels that checked which operations Mosaic could lower for the unified
// kernel (K5) on the TPU. On Hopper each is a plain kernel over f32 tensors,
// held against its PyTorch version by
// nextsearch_tpu_torch/benchmarks/kernel_probe.py. P2-P5 are bound by launch
// latency at the probe's shapes (at most 128 x 1024 outputs).
constexpr int PTS = 16;  // output tile edge of the transpose

// P1: o[Q, T] = a[Q, W] . b[T, W]^T, an f32 FFMA dot, every output summed
// along W in ascending order by one thread. What bounds it is instruction
// rate, not bytes (2.9 MB, resident in L2) or FFMA rate (134 MFLOP): the
// design feeds more FMAs per shared-memory load and keeps the loads ahead of
// the arithmetic (2.5x the rate of a kernel with one output per thread and
// two shared loads per FMA, with the same bits).
//   - A block owns a 32 x 32 output tile (128 blocks for the probe's 128 x
//     1024 outputs, one per SM) with 128 threads of 4 x 2 outputs each, rows
//     8 apart and columns 16 apart: a thread's step over 4 contraction values
//     is 6 16-byte shared loads for 32 FMAs, the four a-loads broadcast
//     within a warp and the b-loads of 8 consecutive lanes on 8 rows whose
//     padded stride (36 floats) puts them in distinct bank groups.
//   - Both operands are W-contiguous, so the tiles come in as 16-byte
//     cp.async copies ([row][k] as they lie in memory) in a ring of
//     NT_STAGES stages of 32 contraction values: one barrier per step and up
//     to three steps of copies in flight. Rows past Q or T and values past W
//     are zero-filled by size-0 copies; W not a multiple of 4 (rows then not
//     16-byte aligned) takes 4-byte copies (VEC = false).
constexpr int NT_BM = 32;       // a rows (queries) per block
constexpr int NT_BN = 32;       // b rows (outputs columns) per block
constexpr int NT_BK = 32;       // contraction values per stage
constexpr int NT_LD = NT_BK + 4;  // padded shared-memory row, in floats
constexpr int NT_STAGES = 4;
constexpr int NT_THREADS = 128;
constexpr int NT_TQ = 4;        // outputs per thread along q, 8 apart
constexpr int NT_TT = 2;        // outputs per thread along t, 16 apart

template <bool VEC>
__global__ void __launch_bounds__(NT_THREADS)
nt_dot_tiled_kernel(const float* __restrict__ a, const float* __restrict__ b,
                    float* __restrict__ o, int Q, int T, int W) {
  __shared__ __align__(16) float As[NT_STAGES][NT_BM][NT_LD];
  __shared__ __align__(16) float Bs[NT_STAGES][NT_BN][NT_LD];
  const int tid = threadIdx.x;
  const int q0 = blockIdx.y * NT_BM;
  const int t0 = blockIdx.x * NT_BN;
  const int tq = tid / 16;  // 0..7
  const int tt = tid % 16;  // 0..15
  const int n_steps = (W + NT_BK - 1) / NT_BK;

  auto load = [&](int step) {
    const int stage = step % NT_STAGES;
    const int w0 = step * NT_BK;
    constexpr int PER = VEC ? 4 : 1;           // floats per copy
    constexpr int CPR = NT_BK / PER;           // copies per row
    constexpr int HALF = NT_BM * CPR;          // copies of one operand's tile
    for (int c = tid; c < 2 * HALF; c += NT_THREADS) {
      const bool is_b = c >= HALF;
      const int cc = is_b ? c - HALF : c;
      const int r = cc / CPR;
      const int kc = (cc % CPR) * PER;
      const int w = w0 + kc;
      const int row = (is_b ? t0 : q0) + r;
      const bool ok = row < (is_b ? T : Q) && w < W;
      const float* base = is_b ? b : a;
      const float* src = ok ? base + (long long)row * W + w : base;
      const uint32_t dst = smem_addr(is_b ? &Bs[stage][r][kc] : &As[stage][r][kc]);
      if constexpr (VEC)
        cp_async16(dst, src, ok);
      else
        cp_async4(dst, src, ok);
    }
  };

  float acc[NT_TQ][NT_TT];
#pragma unroll
  for (int i = 0; i < NT_TQ; ++i)
#pragma unroll
    for (int j = 0; j < NT_TT; ++j) acc[i][j] = 0.f;

  for (int s = 0; s < NT_STAGES - 1; ++s) {
    if (s < n_steps) load(s);
    asm volatile("cp.async.commit_group;\n" ::: "memory");
  }
  for (int step = 0; step < n_steps; ++step) {
    asm volatile("cp.async.wait_group %0;\n" ::"n"(NT_STAGES - 2) : "memory");
    __syncthreads();
    // the stage read in the previous step is free now: refill it
    if (step + NT_STAGES - 1 < n_steps) load(step + NT_STAGES - 1);
    asm volatile("cp.async.commit_group;\n" ::: "memory");
    const int stage = step % NT_STAGES;
#pragma unroll
    for (int kk = 0; kk < NT_BK; kk += 4) {
      float4 av[NT_TQ], bv[NT_TT];
#pragma unroll
      for (int i = 0; i < NT_TQ; ++i)
        av[i] = *reinterpret_cast<const float4*>(&As[stage][tq + 8 * i][kk]);
#pragma unroll
      for (int j = 0; j < NT_TT; ++j)
        bv[j] = *reinterpret_cast<const float4*>(&Bs[stage][tt + 16 * j][kk]);
#pragma unroll
      for (int i = 0; i < NT_TQ; ++i)
#pragma unroll
        for (int j = 0; j < NT_TT; ++j) {
          float c = acc[i][j];
          c = fmaf(av[i].x, bv[j].x, c);
          c = fmaf(av[i].y, bv[j].y, c);
          c = fmaf(av[i].z, bv[j].z, c);
          c = fmaf(av[i].w, bv[j].w, c);
          acc[i][j] = c;
        }
    }
  }
  asm volatile("cp.async.wait_all;\n" ::: "memory");
#pragma unroll
  for (int i = 0; i < NT_TQ; ++i)
#pragma unroll
    for (int j = 0; j < NT_TT; ++j) {
      const int q = q0 + tq + 8 * i;
      const int t = t0 + tt + 16 * j;
      if (q < Q && t < T) o[(long long)q * T + t] = acc[i][j];
    }
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
// (wq[w], wd[w]) == (q, d) of wv[w], repeated (q, d) entries added in entry
// order, as the one-hot product's contraction does. One thread per output
// cell, each walking all W entries, would make 67M compares at the probe's
// shapes (Q 128, T 1024, W 512) to place 512 values, where the job is bound
// by the bytes of the 512 KB output.
// Here one block owns a band of output rows (one row of 1,024 cells at the
// probe's shapes, so 128 blocks): it zero-fills the band with 16-byte
// stores, compacts the entries that fall in the band into shared memory in
// entry order (each thread counts four consecutive entries, one block scan
// places them), and the thread holding a cell's first entry sums that
// cell's entries in entry order and stores the sum once. Work per block is
// O(W) plus the band's entries squared, not O(W) per cell.
constexpr int WIN_MAX = 1024;
constexpr int WIN_THREADS = 256;
constexpr int WIN_PER_THREAD = WIN_MAX / WIN_THREADS;
constexpr int WIN_BAND_CELLS = 1024;  // output cells a block zero-fills, at least

__global__ void __launch_bounds__(WIN_THREADS)
window_band_kernel(const int* __restrict__ wq, const float* __restrict__ wv,
                   const int* __restrict__ wd, float* __restrict__ o, int Q,
                   int T, int W, int rows) {
  __shared__ long long cell[WIN_MAX];
  __shared__ float val[WIN_MAX];
  __shared__ int part[WIN_THREADS / 32];
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int r0 = blockIdx.x * rows;
  const int r1 = r0 + rows < Q ? r0 + rows : Q;
  // zero-fill cells [z0, z1): scalar head and tail, 16-byte stores between
  const long long z0 = static_cast<long long>(r0) * T;
  const long long z1 = static_cast<long long>(r1) * T;
  const long long a0 = ((z0 + 3) & ~3LL) < z1 ? ((z0 + 3) & ~3LL) : z1;
  const long long a1 = a0 + ((z1 - a0) & ~3LL);
  if (tid < a0 - z0) o[z0 + tid] = 0.f;
  if (tid < z1 - a1) o[a1 + tid] = 0.f;
  for (long long i = a0 / 4 + tid; i < a1 / 4; i += WIN_THREADS)
    reinterpret_cast<float4*>(o)[i] = make_float4(0.f, 0.f, 0.f, 0.f);
  // the band's entries, in entry order: thread t holds entries 4t .. 4t + 3
  auto in_band = [&](int w) {
    if (w >= W) return false;
    const int q = wq[w];
    const int d = wd[w];
    return q >= r0 && q < r1 && d >= 0 && d < T;
  };
  int c = 0;
#pragma unroll
  for (int j = 0; j < WIN_PER_THREAD; ++j) c += in_band(tid * WIN_PER_THREAD + j);
  int pos = c;
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const int x = __shfl_up_sync(0xffffffffu, pos, off);
    if (lane >= off) pos += x;
  }
  if (lane == 31) part[warp] = pos;
  __syncthreads();
  int m = 0;
#pragma unroll
  for (int x = 0; x < WIN_THREADS / 32; ++x) {
    pos += x < warp ? part[x] : 0;
    m += part[x];
  }
  pos -= c;  // exclusive
#pragma unroll
  for (int j = 0; j < WIN_PER_THREAD; ++j) {
    const int w = tid * WIN_PER_THREAD + j;
    if (in_band(w)) {
      cell[pos] = static_cast<long long>(wq[w]) * T + wd[w];
      val[pos] = wv[w];
      ++pos;
    }
  }
  __syncthreads();  // the band list, and the zero fill before the sums
  for (int j = tid; j < m; j += WIN_THREADS) {
    const long long cj = cell[j];
    bool first = true;
    for (int i = 0; i < j && first; ++i) first = cell[i] != cj;
    if (!first) continue;
    float acc = 0.f;
    for (int i = j; i < m; ++i)
      if (cell[i] == cj) acc += val[i];
    o[cj] = acc;
  }
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

// ------------------------------------------------------------ score epilogue
//
// score_epilogue_kernel ports what XLA fuses after the fused mode's dot in
// the reference's jitted launch (nextsearch_tpu/ops/bm25.py:300-301 and
// :358-359, and tiled_topk's tile max at :232; no Pallas kernel): over the
// [Q, N] pass-1 scores S and the heavy product H (f32, torch.matmul's
// output), S += H in place, found[q] += the count of S > 0 after the add,
// and tile_max[q, t] = the max of each `chunk`-doc tile of a row. With
// bf16 S it rounds as the reference does: H to bf16 first
// (heavy_scores(..., dtype=bf16)), then the bf16 sum, both to nearest
// even. Without H it only counts and takes maxima (exact and fast mode).
//
// Bound by bytes: nothing is reused, so the least traffic is S read, H
// read and S written once, 6.15 GB at Q 512 x n_slots 1,001,472 with f32
// scores (1.84 ms at 3.35 TB/s; 4.1 GB with bf16 S). The eager passes this
// replaces (a cast where S is bf16, the add, a bool array and its int32
// sum for `found`, the tile max) read or write the array five or six
// times; one pass that touches each byte once is the whole design.
//
// One warp per (row, chunk of `chunk` docs), eight warps a block: a
// block's warps take consecutive chunks of a row. 16-byte loads and stores
// over the chunk's body, EPI_UNROLL of each in flight per lane, a scalar
// head and tail where a chunk does not start or end on 16 bytes (odd N),
// and all-scalar where the caller's pointers are not 16-byte aligned
// (vec_ok = 0). The chunk's max is a warp reduction; its count one
// atomicAdd into found, which the caller zeroes: integer sums, so the
// result does not depend on the order of the warps. Scores are finite and
// >= 0 (positive BM25 contributions), so fmaxf is the reference's max.
constexpr int EPI_THREADS = 256;
constexpr int EPI_WARPS = EPI_THREADS / 32;
constexpr int EPI_UNROLL = 4;

__device__ __forceinline__ float epi_float(float x) { return x; }
__device__ __forceinline__ float epi_float(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void epi_store(float* p, float x) { *p = x; }
__device__ __forceinline__ void epi_store(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16_rn(x);  // exact: x is a bf16 value
}

// s + h as the reference rounds it: the f32 sum; in bf16, h rounded to
// bf16, then the sum rounded, both to nearest even.
__device__ __forceinline__ float epi_add(float s, float h) { return s + h; }
__device__ __forceinline__ __nv_bfloat16 epi_add(__nv_bfloat16 s, float h) {
  return __float2bfloat16_rn(__bfloat162float(s) +
                             __bfloat162float(__float2bfloat16_rn(h)));
}

template <typename T, bool ADD>
__device__ __forceinline__ void epi_scalar(T* __restrict__ s,
                                           const float* __restrict__ h,
                                           long long i, int& cnt, float& mx) {
  T v = s[i];
  if (ADD) {
    v = epi_add(v, h[i]);
    s[i] = v;
  }
  const float f = epi_float(v);
  cnt += f > 0.f;
  mx = fmaxf(mx, f);
}

template <typename T, bool ADD>
__global__ void __launch_bounds__(EPI_THREADS)
score_epilogue_kernel(T* __restrict__ s, const float* __restrict__ h, int Q,
                      long long N, long long chunk, long long n_chunks,
                      T* __restrict__ tile_max, int* __restrict__ found,
                      int vec_ok) {
  constexpr int VEC = 16 / sizeof(T);  // S entries per 16-byte vector
  constexpr int HV = VEC / 4;          // H float4s per S vector
  const int lane = threadIdx.x & 31;
  const long long w = static_cast<long long>(blockIdx.x) * EPI_WARPS +
                      (threadIdx.x >> 5);
  if (w >= static_cast<long long>(Q) * n_chunks) return;  // the whole warp
  const long long r = w / n_chunks;
  const long long c = w - r * n_chunks;
  const long long g0 = r * N + c * chunk;
  const long long g1 = r * N + (c + 1 < n_chunks ? (c + 1) * chunk : N);
  // the 16-byte body [a0, a1); every entry outside it is scalar
  long long a0 = g1, a1 = g1;
  if (vec_ok) {
    a0 = (g0 + VEC - 1) / VEC * VEC;
    if (a0 > g1) a0 = g1;
    a1 = a0 + (g1 - a0) / VEC * VEC;
  }
  int cnt = 0;
  float mx = __int_as_float(0xff800000);  // -inf
  for (long long i = g0 + lane; i < a0; i += 32) epi_scalar<T, ADD>(s, h, i, cnt, mx);
  for (long long i = a1 + lane; i < g1; i += 32) epi_scalar<T, ADD>(s, h, i, cnt, mx);
  uint4* sv = reinterpret_cast<uint4*>(s + a0);
  const float4* hv = reinterpret_cast<const float4*>(h + (ADD ? a0 : 0));
  const long long nv = (a1 - a0) / VEC;
  for (long long j0 = lane; j0 < nv; j0 += 32 * EPI_UNROLL) {
    uint4 x[EPI_UNROLL];
    float4 y[EPI_UNROLL][HV];
#pragma unroll
    for (int u = 0; u < EPI_UNROLL; ++u) {
      const long long j = j0 + u * 32;
      if (j < nv) {
        x[u] = sv[j];
        if (ADD) {
#pragma unroll
          for (int k = 0; k < HV; ++k) y[u][k] = __ldcs(hv + j * HV + k);
        }
      }
    }
#pragma unroll
    for (int u = 0; u < EPI_UNROLL; ++u) {
      const long long j = j0 + u * 32;
      if (j < nv) {
        T* e = reinterpret_cast<T*>(&x[u]);
        const float* f = reinterpret_cast<const float*>(&y[u][0]);
#pragma unroll
        for (int k = 0; k < VEC; ++k) {
          if (ADD) e[k] = epi_add(e[k], f[k]);
          const float v = epi_float(e[k]);
          cnt += v > 0.f;
          mx = fmaxf(mx, v);
        }
        if (ADD) sv[j] = x[u];
      }
    }
  }
  cnt = static_cast<int>(__reduce_add_sync(0xffffffffu, static_cast<unsigned>(cnt)));
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
  if (lane == 0) {
    if (cnt) atomicAdd(found + r, cnt);
    if (tile_max != nullptr) epi_store(tile_max + w, mx);
  }
}

template <typename T>
void launch_score_epilogue(void* s, const float* h, int Q, long long N,
                           long long chunk, long long n_chunks, void* tile_max,
                           int* found, int vec_ok, unsigned int blocks,
                           cudaStream_t st) {
  T* sp = static_cast<T*>(s);
  T* tm = static_cast<T*>(tile_max);
  if (h != nullptr)
    score_epilogue_kernel<T, true><<<blocks, EPI_THREADS, 0, st>>>(
        sp, h, Q, N, chunk, n_chunks, tm, found, vec_ok);
  else
    score_epilogue_kernel<T, false><<<blocks, EPI_THREADS, 0, st>>>(
        sp, h, Q, N, chunk, n_chunks, tm, found, vec_ok);
}

}  // namespace

// mixb (null for none) takes the rounded rows as bf16 [Q, ND_pad], ND_pad >=
// ND a multiple of 32; only with round_bf16.
extern "C" int ns_mix_lists(const float* mix, int round_bf16, int Q, int ND,
                            int L, int* count, int* cols, float* vals,
                            void* mixb, int ND_pad, void* stream) {
  if (L > GATHER_CUT) return static_cast<int>(cudaErrorInvalidValue);
  if (mixb != nullptr && (!round_bf16 || ND_pad < ND || ND_pad % TC_BK))
    return static_cast<int>(cudaErrorInvalidValue);
  __nv_bfloat16* mb = static_cast<__nv_bfloat16*>(mixb);
  const int threads = 256;  // 8 rows per block
  const unsigned int blocks = static_cast<unsigned int>((Q + 7) / 8);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (round_bf16)
    mix_lists_kernel<true><<<blocks, threads, 0, s>>>(mix, Q, ND, L, count, cols,
                                                      vals, mb, ND_pad);
  else
    mix_lists_kernel<false><<<blocks, threads, 0, s>>>(mix, Q, ND, L, count,
                                                       cols, vals, nullptr, 0);
  return static_cast<int>(cudaGetLastError());
}

// The product launches take lists of at most GATHER_CUT entries, and, where
// the tensor-core kernel may run (bf16 operands), the padded bf16 mix.
bool valid_shapes(int Q, int L, int ND, bool bf16_operands, const void* mixb,
                  int ND_pad) {
  if (Q <= 0 || L < 0 || L > GATHER_CUT) return false;
  if (!bf16_operands) return true;
  return mixb != nullptr && ND_pad >= ND && ND_pad % TC_BK == 0;
}

// Every product entry point takes the mix lists of ns_mix_lists (lcnt,
// lcol, lval, capacity L), made with the rounding the product applies, and
// its bf16 rows (mixb, ND_pad; null and 0 in f32-exact mode).
extern "C" int ns_heavy_fused3(const float* mix, const void* table,
                               int table_bf16, int fast, int h_bf16_up,
                               const int* lcnt, const int* lcol,
                               const float* lval, int L, const void* mixb,
                               int ND_pad, void* h, float* smax, float* cnt,
                               int Q, int ND, long long n_slots,
                               void* stream) {
  if (!valid_shapes(Q, L, ND, fast || table_bf16, mixb, ND_pad))
    return static_cast<int>(cudaErrorInvalidValue);
  const HeavyArgs a{mix, static_cast<const __nv_bfloat16*>(mixb), ND_pad, table, Lists{lcnt, lcol, lval, L},
                    Entries{nullptr, nullptr, nullptr, nullptr},
                    Outs{h, smax, cnt, nullptr, 1, EPI_FULL}, Q, ND, n_slots};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (h_bf16_up)
    dispatch_heavy<false, H_BF16_UP, false>(a, table_bf16, fast, s);
  else
    dispatch_heavy<false, H_F32, false>(a, table_bf16, fast, s);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int ns_unified_fused(const float* mix, const void* table,
                                int table_bf16, int fast, const int* lcnt,
                                const int* lcol, const float* lval, int L,
                                const void* mixb, int ND_pad,
                                const int* ent_doc, const int* ent_q,
                                const float* ent_val, const int* ent_off,
                                float* totals, float* smax, float* cnt, int Q,
                                int ND, long long n_slots, void* stream) {
  if (!valid_shapes(Q, L, ND, fast || table_bf16, mixb, ND_pad))
    return static_cast<int>(cudaErrorInvalidValue);
  const HeavyArgs a{mix, static_cast<const __nv_bfloat16*>(mixb), ND_pad, table, Lists{lcnt, lcol, lval, L},
                    Entries{ent_doc, ent_q, ent_val, ent_off},
                    Outs{totals, smax, cnt, nullptr, 1, EPI_FULL}, Q, ND,
                    n_slots};
  dispatch_heavy<true, H_F32, false>(a, table_bf16, fast,
                                     static_cast<cudaStream_t>(stream));
  return static_cast<int>(cudaGetLastError());
}

// P6. epi is EPI_FULL, EPI_NONE or EPI_REDUCED; under EPI_REDUCED cnt_s
// (zeroed [tiles_pad, Q]) and part ([n_sub * ceil(Q / 64)]) are scratch and
// cnt stays as the caller filled it.
extern "C" int ns_heavy_variant(const float* mix, const void* table,
                                int table_bf16, int h_bf16_rn, int store_h,
                                int epi, const int* lcnt, const int* lcol,
                                const float* lval, int L, const void* mixb,
                                int ND_pad, void* h, float* smax, float* cnt,
                                float* cnt_s, float* part, int Q, int ND,
                                long long n_slots, void* stream) {
  if (!valid_shapes(Q, L, ND, true, mixb, ND_pad))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const HeavyArgs a{mix, static_cast<const __nv_bfloat16*>(mixb), ND_pad, table, Lists{lcnt, lcol, lval, L},
                    Entries{nullptr, nullptr, nullptr, nullptr},
                    Outs{h, smax, epi == EPI_REDUCED ? cnt_s : cnt, part,
                         store_h, epi},
                    Q, ND, n_slots};
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

// The same-type (K3) copies run gather_rows_unrolled_kernel, the converting
// gather (K2) gather_rows_kernel.
extern "C" int ns_gather_rows(const int* ids, const void* table, int in_bf16,
                              void* out, int out_bf16, int n_ids, int n_rows,
                              long long n_slots, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (in_bf16 && !out_bf16)
    return static_cast<int>(cudaErrorInvalidValue);  // bf16 -> f32 unused
  if (n_ids <= 0) return static_cast<int>(cudaErrorInvalidValue);
  const int threads = 256;
  const long long nv = n_slots / (in_bf16 ? 8 : 4);  // 16-byte vectors
  long long bx = (nv + threads * 8 - 1) / (threads * 8);
  if (bx < 1) bx = 1;
  const unsigned int gy = static_cast<unsigned int>(n_ids < 65535 ? n_ids : 65535);
  const dim3 grid(static_cast<unsigned int>(bx), gy);
  if ((in_bf16 != 0) == (out_bf16 != 0)) {
    gather_rows_unrolled_kernel<<<grid, threads, 0, s>>>(
        ids, static_cast<const uint4*>(table), static_cast<uint4*>(out), n_ids,
        n_rows, nv);
  } else {
    gather_rows_kernel<float, __nv_bfloat16><<<grid, threads, 0, s>>>(
        ids, static_cast<const float*>(table), static_cast<__nv_bfloat16*>(out),
        n_ids, n_rows, n_slots);
  }
  return static_cast<int>(cudaGetLastError());
}

// per_query_select_kernel writes every slot and takes k2 <= SEL_K2_MAX.
extern "C" int ns_per_query_topk(const float* scores, const long long* bounds,
                                 long long n, int n_queries, int k2,
                                 float* vals, long long* gidx, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (n_queries <= 0 || k2 < 1 || k2 > SEL_K2_MAX)
    return static_cast<int>(cudaErrorInvalidValue);
  per_query_select_kernel<<<n_queries, SELECT_THREADS, 0, s>>>(
      scores, bounds, n, k2, vals, gidx);
  return static_cast<int>(cudaGetLastError());
}

// scores [Q, N] (f32, or bf16 where scores_bf16), heavy f32 [Q, N] or null
// for the count and maxima alone; tile_max [Q, N / chunk] in the scores'
// type, or null, and then N need not be a multiple of chunk; found int32
// [Q], zeroed by the caller. vec_ok != 0: scores and heavy are 16-byte
// aligned.
extern "C" int ns_score_epilogue(void* scores, const float* heavy,
                                 int scores_bf16, int Q, long long N,
                                 long long chunk, void* tile_max, int* found,
                                 int vec_ok, void* stream) {
  if (Q <= 0 || N <= 0 || chunk <= 0 || (tile_max != nullptr && N % chunk))
    return static_cast<int>(cudaErrorInvalidValue);
  const long long n_chunks = (N + chunk - 1) / chunk;
  const long long blocks = (Q * n_chunks + EPI_WARPS - 1) / EPI_WARPS;
  if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const unsigned int b = static_cast<unsigned int>(blocks);
  if (scores_bf16)
    launch_score_epilogue<__nv_bfloat16>(scores, heavy, Q, N, chunk, n_chunks,
                                         tile_max, found, vec_ok, b, s);
  else
    launch_score_epilogue<float>(scores, heavy, Q, N, chunk, n_chunks,
                                 tile_max, found, vec_ok, b, s);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int ns_probe_nt_dot(const float* a, const float* b, float* o, int Q,
                               int T, int W, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const dim3 grid((T + NT_BN - 1) / NT_BN, (Q + NT_BM - 1) / NT_BM);
  if (W % 4 == 0)
    nt_dot_tiled_kernel<true><<<grid, NT_THREADS, 0, s>>>(a, b, o, Q, T, W);
  else
    nt_dot_tiled_kernel<false><<<grid, NT_THREADS, 0, s>>>(a, b, o, Q, T, W);
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
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (W > WIN_MAX || Q <= 0 || T <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const int rows = (WIN_BAND_CELLS + T - 1) / T;
  window_band_kernel<<<(Q + rows - 1) / rows, WIN_THREADS, 0, s>>>(
      wq, wv, wd, o, Q, T, W, rows);
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
