// Hand-written Hopper (sm_90a) flash attention: causal, sliding-window or
// non-causal attention with an fp32 online softmax, for the LM's prefill.
//
// Replaces the Pallas TPU kernel src/repro/kernels/attention.py:
// _flash_kernel (wrapper flash_attention). It computes what that kernel
// computes: s = q.k^T * scale in fp32; valid = kpos < S, and when causal
// also kpos <= qpos and kpos > qpos - window; a running max m, normalizer l
// and accumulator acc in fp32 over key tiles, p = valid ? exp(s - m) : 0;
// out = acc / max(l, 1e-20), stored in the input's type.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3
//        -fmad=false -shared -Xcompiler -fPIC  (repro_torch/kernels/_build.py)
// The C entry points at the end take device pointers and a stream, launch
// on that stream, and return cudaGetLastError() after the launch. The dot
// products use explicit fmaf, so -fmad=false does not split them.
//
// Design. The TPU grid (heads, q-blocks, kv-blocks) carries m, l and acc in
// VMEM from one sequential kv step to the next; Hopper blocks run in no
// order, so here one CTA owns one (batch*head, 64-row q tile) and loops over
// the key tiles itself, with m, l and acc in registers. 256 threads form a
// 16 x 16 grid (ty, tx): thread (ty, tx) holds the scores of rows ty + 16 i
// and keys tx + 16 j (i, j < 4), and the output columns VEC * tx + 16 VEC g
// + e of the same four rows. The CTA's Q tile stays in shared memory for
// the whole loop (the scale multiplies the fp32 scores); each key tile is
// staged in shared memory as K, the scores and p are formed, p goes to
// shared memory, and the same buffer is then refilled with the tile's V for
// acc += p V. Everything is converted to fp32 on load. Row maxima and sums
// are reduced over the 16 threads of a row with warp shuffles. Tiles that
// the causal or window mask leaves wholly invalid for the CTA's rows are
// skipped: such a tile would give p == 0 and corr == 1 and leave m, l and
// acc as they are. The ragged edge (rows and keys >= S) is masked here,
// without padding copies. The q tiles are walked last to first, so the
// CTAs with the most key tiles start first.
//
// Layout. The kernel takes element strides for (batch, seq, head) of q, k,
// v and o, with the head_dim axis contiguous, so the same launcher serves
// the public (H, S, hd) layout and the model's (B, S, H, hd) layout without
// a transpose copy. Query head h reads kv head h / G (G = heads / kv_heads,
// h = kv * G + g as in repro/models/layers/attention.py).
//
// Bound on this card. At the served prefill shape (B = 8, S = 2048, 16
// heads, 8 kv heads, head_dim 128, bf16, causal) the work is 2 S^2 hd B H
// ~ 1.37e11 flop per call (q.k^T and p.V over the causal half), 0.139 ms
// at the tensor cores' 989 TFLOP/s bf16, against ~201 MB of q, k, v and o,
// 0.060 ms at 3.35 TB/s: the operations bind. This kernel runs them on the
// fp32 CUDA cores (67 TFLOP/s), so it cannot take less than about 2 ms a
// call. No (type, head_dim) is served by it any more: it stays as the
// yardstick that chip_smoke.py times in turns with the tensor-core kernels
// on the same inputs, and holds against its own plain version.
//
// Two tensor-core kernels follow, each with a header that says how:
// flash_attention_wgmma_kernel serves bf16 at head_dim 32, 64, 128 and 320
// -- the served LMs' prefills (qwen3-1.7b at 128, gemma3-4b at 320) and
// the reduced configs' (32) -- with wgmma on bf16 tiles;
// flash_attention_tf32_kernel serves fp32 at head_dim 32, 64, 128 and 320
// with wgmma on TF32 tiles, each fp32 product formed as three TF32
// products (3xTF32). Both bring K and V in by TMA through a ring of
// shared-memory stages, one producer warp feeding two consumer warpgroups
// of 64 query rows each (at fp32 head_dim 320: the same 64 rows, half of
// head_dim each).
#include <cuda.h>  // CUtensorMap and its enums; the encoder is reached
                   // through cudaGetDriverEntryPoint, so no -lcuda
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstddef>
#include <cstdint>
#include <type_traits>

namespace {

constexpr int kBQ = 64;         // query rows per CTA
constexpr int kBK = 64;         // keys per tile
constexpr int kThreads = 256;   // a 16 x 16 thread grid
constexpr float kNeg = -1e30f;  // the reference's NEG

template <int HD>
struct Tile {
  // Row strides (floats) of the shared tiles. HD + 4 keeps float4 rows
  // aligned and puts the 8 rows a quarter warp reads on distinct banks.
  static constexpr int LD = HD + 4;
  static constexpr int LDP = kBK + 4;
  // Output columns per thread come in runs of VEC contiguous floats.
  static constexpr int VEC = (HD % 64 == 0) ? 4 : 2;
  static constexpr int GROUPS = HD / (16 * VEC);
  static constexpr int COLS = GROUPS * VEC;
  static constexpr size_t kSmem =
      sizeof(float) * ((size_t)kBQ * LD + (size_t)kBK * LD + (size_t)kBQ * LDP);
  static_assert(HD % (16 * VEC) == 0, "head_dim must split over 16 threads");
};

struct Strides {
  long long qb, qs, qh, kb, ks, kh, vb, vs, vh, ob, os, oh;
};

__device__ __forceinline__ float4 load4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

__device__ __forceinline__ float4 load4(const __nv_bfloat16* p) {
  const uint2 u = *reinterpret_cast<const uint2*>(p);
  const float2 a = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.x));
  const float2 b = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.y));
  return make_float4(a.x, a.y, b.x, b.y);
}

template <int VEC>
__device__ __forceinline__ void store_vec(float* p, const float* x) {
  if constexpr (VEC == 4) {
    *reinterpret_cast<float4*>(p) = make_float4(x[0], x[1], x[2], x[3]);
  } else {
    *reinterpret_cast<float2*>(p) = make_float2(x[0], x[1]);
  }
}

template <int VEC>
__device__ __forceinline__ void store_vec(__nv_bfloat16* p, const float* x) {
  const __nv_bfloat162 a = __floats2bfloat162_rn(x[0], x[1]);
  if constexpr (VEC == 4) {
    const __nv_bfloat162 b = __floats2bfloat162_rn(x[2], x[3]);
    uint2 u;
    u.x = *reinterpret_cast<const uint32_t*>(&a);
    u.y = *reinterpret_cast<const uint32_t*>(&b);
    *reinterpret_cast<uint2*>(p) = u;
  } else {
    *reinterpret_cast<__nv_bfloat162*>(p) = a;
  }
}

// Rows [row0, row0 + rows) of a (seq, HD) slice with row stride `stride`
// (elements) into a shared tile of row stride LD, as fp32; rows >= seq are
// zero.
template <int HD, typename T>
__device__ __forceinline__ void load_tile(float* dst, const T* src,
                                          long long stride, int row0,
                                          int rows, int seq) {
  constexpr int kV4 = HD / 4;
  for (int i = threadIdx.x; i < rows * kV4; i += kThreads) {
    const int r = i / kV4;
    const int c = (i - r * kV4) * 4;
    float4 val = make_float4(0.f, 0.f, 0.f, 0.f);
    if (row0 + r < seq) val = load4(src + (long long)(row0 + r) * stride + c);
    *reinterpret_cast<float4*>(dst + r * Tile<HD>::LD + c) = val;
  }
}

__device__ __forceinline__ float row_max(float x) {
#pragma unroll
  for (int off = 8; off > 0; off >>= 1)
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, off));
  return x;
}

__device__ __forceinline__ float row_sum(float x) {
#pragma unroll
  for (int off = 8; off > 0; off >>= 1)
    x += __shfl_xor_sync(0xffffffffu, x, off);
  return x;
}

template <int HD, typename T>
__global__ void __launch_bounds__(kThreads, HD <= 128 ? 2 : 1)
    flash_attention_kernel(const T* __restrict__ q, const T* __restrict__ k,
                           const T* __restrict__ v, T* __restrict__ o,
                           int seq, int heads, int group, Strides st,
                           int window, int causal, float scale) {
  using TL = Tile<HD>;
  extern __shared__ float4 smem4[];
  float* qs = reinterpret_cast<float*>(smem4);
  float* kvs = qs + kBQ * TL::LD;
  float* ps = kvs + kBK * TL::LD;

  const int b = blockIdx.x / heads;
  const int h = blockIdx.x - b * heads;
  const int hk = h / group;
  const int q0 = (int)(gridDim.y - 1 - blockIdx.y) * kBQ;
  const int tx = threadIdx.x & 15;
  const int ty = threadIdx.x >> 4;
  const T* kb = k + b * st.kb + hk * st.kh;
  const T* vb = v + b * st.vb + hk * st.vh;

  load_tile<HD>(qs, q + b * st.qb + h * st.qh, st.qs, q0, kBQ, seq);

  float m[4], l[4], acc[4][TL::COLS];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = kNeg;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < TL::COLS; ++c) acc[i][c] = 0.f;
  }

  // Key tiles that hold a valid key for some row of this CTA.
  int lo = 0, hi = seq;
  if (causal) {
    hi = min(seq, q0 + kBQ);
    const long long first = (long long)q0 - window + 1;
    lo = first > 0 ? (int)first : 0;
  }
  for (int kv0 = lo / kBK * kBK; kv0 < hi; kv0 += kBK) {
    __syncthreads();  // the previous tile's readers of kvs and ps are done
    load_tile<HD>(kvs, kb, st.ks, kv0, kBK, seq);
    __syncthreads();

    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
#pragma unroll 4
    for (int d = 0; d < HD; d += 4) {
      float4 qa[4], ka[4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        qa[i] = *reinterpret_cast<const float4*>(qs + (ty + 16 * i) * TL::LD + d);
#pragma unroll
      for (int j = 0; j < 4; ++j)
        ka[j] = *reinterpret_cast<const float4*>(kvs + (tx + 16 * j) * TL::LD + d);
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          s[i][j] = fmaf(qa[i].x, ka[j].x, s[i][j]);
          s[i][j] = fmaf(qa[i].y, ka[j].y, s[i][j]);
          s[i][j] = fmaf(qa[i].z, ka[j].z, s[i][j]);
          s[i][j] = fmaf(qa[i].w, ka[j].w, s[i][j]);
        }
    }

#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int qpos = q0 + ty + 16 * i;
      bool valid[4];
      float mx = kNeg;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int kpos = kv0 + tx + 16 * j;
        valid[j] = kpos < seq &&
                   (!causal || (kpos <= qpos && kpos > qpos - window));
        s[i][j] = valid[j] ? s[i][j] * scale : kNeg;
        mx = fmaxf(mx, s[i][j]);
      }
      const float m_new = fmaxf(m[i], row_max(mx));
      const float corr = expf(m[i] - m_new);
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float p = valid[j] ? expf(s[i][j] - m_new) : 0.f;
        ps[(ty + 16 * i) * TL::LDP + tx + 16 * j] = p;
        sum += p;
      }
      l[i] = l[i] * corr + row_sum(sum);
      m[i] = m_new;
#pragma unroll
      for (int c = 0; c < TL::COLS; ++c) acc[i][c] *= corr;
    }

    __syncthreads();  // K is read and p is complete: the buffer takes V
    load_tile<HD>(kvs, vb, st.vs, kv0, kBK, seq);
    __syncthreads();

#pragma unroll 2
    for (int c = 0; c < kBK; c += 4) {
      float4 pa[4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        pa[i] = *reinterpret_cast<const float4*>(ps + (ty + 16 * i) * TL::LDP + c);
#pragma unroll
      for (int cc = 0; cc < 4; ++cc) {
        const float* vrow = kvs + (c + cc) * TL::LD + TL::VEC * tx;
#pragma unroll
        for (int g = 0; g < TL::GROUPS; ++g) {
          float vv[TL::VEC];
          if constexpr (TL::VEC == 4) {
            const float4 t = *reinterpret_cast<const float4*>(vrow + 64 * g);
            vv[0] = t.x; vv[1] = t.y; vv[2] = t.z; vv[3] = t.w;
          } else {
            const float2 t = *reinterpret_cast<const float2*>(vrow + 32 * g);
            vv[0] = t.x; vv[1] = t.y;
          }
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            const float p = cc == 0 ? pa[i].x : cc == 1 ? pa[i].y
                          : cc == 2 ? pa[i].z : pa[i].w;
#pragma unroll
            for (int e = 0; e < TL::VEC; ++e)
              acc[i][g * TL::VEC + e] = fmaf(p, vv[e], acc[i][g * TL::VEC + e]);
          }
        }
      }
    }
  }

  T* ob = o + b * st.ob + h * st.oh;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int qpos = q0 + ty + 16 * i;
    if (qpos >= seq) continue;
    const float denom = fmaxf(l[i], 1e-20f);
    T* orow = ob + (long long)qpos * st.os + TL::VEC * tx;
#pragma unroll
    for (int g = 0; g < TL::GROUPS; ++g) {
      float out[TL::VEC];
#pragma unroll
      for (int e = 0; e < TL::VEC; ++e) out[e] = acc[i][g * TL::VEC + e] / denom;
      store_vec<TL::VEC>(orow + 16 * TL::VEC * g, out);
    }
  }
}

template <int HD, typename T>
cudaError_t launch_typed(const void* q, const void* k, const void* v, void* o,
                         int batch, int seq, int heads, int group,
                         const Strides& st, int window, int causal,
                         float scale, cudaStream_t stream) {
  auto kernel = flash_attention_kernel<HD, T>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)Tile<HD>::kSmem);
  if (err != cudaSuccess) return err;
  const dim3 grid((unsigned)(batch * heads), (unsigned)((seq + kBQ - 1) / kBQ));
  kernel<<<grid, kThreads, Tile<HD>::kSmem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), seq, heads, group, st,
      window, causal, scale);
  return cudaGetLastError();
}

template <int HD, typename T>
cudaError_t occupancy_typed(int* threads, int* smem, int* regs, int* ctas) {
  auto kernel = flash_attention_kernel<HD, T>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)Tile<HD>::kSmem);
  if (err != cudaSuccess) return err;
  cudaFuncAttributes attr;
  err = cudaFuncGetAttributes(&attr, kernel);
  if (err != cudaSuccess) return err;
  *threads = kThreads;
  *smem = (int)Tile<HD>::kSmem;
  *regs = attr.numRegs;
  return cudaOccupancyMaxActiveBlocksPerMultiprocessor(ctas, kernel, kThreads,
                                                       Tile<HD>::kSmem);
}

// Calls F<HD, T>() for the supported head_dims and the two types.
#define ATTENTION_DISPATCH(F, hd, bf16, ...)                                 \
  switch (hd) {                                                              \
    case 32:                                                                 \
      return bf16 ? F<32, __nv_bfloat16>(__VA_ARGS__) : F<32, float>(__VA_ARGS__); \
    case 64:                                                                 \
      return bf16 ? F<64, __nv_bfloat16>(__VA_ARGS__) : F<64, float>(__VA_ARGS__); \
    case 128:                                                                \
      return bf16 ? F<128, __nv_bfloat16>(__VA_ARGS__)                       \
                  : F<128, float>(__VA_ARGS__);                              \
    case 320:                                                                \
      return bf16 ? F<320, __nv_bfloat16>(__VA_ARGS__)                       \
                  : F<320, float>(__VA_ARGS__);                              \
  }                                                                          \
  return cudaErrorInvalidValue;

// ---------------------------------------------------------------------------
// flash_attention_wgmma_kernel: bf16 at head_dim 32, 64, 128 and 320, on
// the tensor cores
// ---------------------------------------------------------------------------
//
// Computes what flash_attention_kernel computes (same masks, same
// `valid ? exp(s - m) : 0`, same acc / max(l, 1e-20), scale on the fp32
// scores, GQA by h / G, (batch, seq, head) element strides) for bf16 q, k,
// v at head_dim 32, 64, 128 and 320, and replaces the same TPU kernel
// (src/repro/kernels/attention.py: _flash_kernel).
//
// Precision. s = q.k^T is a wgmma with bf16 operands and an fp32
// accumulator: a product of two bf16 values is exact in fp32, so only the
// order of the sum differs from the reference's fp32 product. acc += p.V
// splits the fp32 p in two bf16 parts, p_hi = bf16(p) and p_lo = bf16(p -
// p_hi), and runs two wgmmas into the same fp32 accumulator: about 16
// significant bits of p instead of a single bf16's 8, for 1.5x the tensor
// work of one pass. l sums the fp32 p, as the reference does.
//
// The CTA. 384 threads: warpgroup 0 is the producer (setmaxnreg down; one
// thread issues every TMA load), warpgroups 1 and 2 are consumers
// (setmaxnreg up). Grid (batch * heads, ceil(S / BM)); the q tiles are
// walked last to first, so the CTAs with the most key tiles start first.
//
// Instances (WgCfg<HD, BN, STAGES>, one per head_dim; BN is
// kernels/attention.py::WGMMA_KERNEL_KEYS): BM = 128 query rows a CTA, 64
// per consumer warpgroup.
// - hd 32 (the reduced configs): BN = 128 keys a tile; 2 stages, chosen
//   by an A/B of tiles on the card (PERF.md); setmaxnreg 40 / 232. A row
//   of 32 bf16 is 64 bytes: one box a row, under the 64-byte swizzle,
//   Q.K^T in two k16 steps, p.V one m64n32k16 wgmma a key step. (A
//   zero-padded 64-column box under the 128-byte swizzle needs no new
//   layout, but runs twice the products.)
// - hd 64 and 128: BN = 128 keys a tile; 2 stages; setmaxnreg 40 / 232.
// - hd 320: BN = 48; 2 stages: Q 80 KB + 2 x 60 KB of K and V. The
//   accumulator, 64 x 320 fp32 over 128 threads, is 160 registers a
//   thread; s takes 24 at this tile and the p fragments 24 + 24;
//   setmaxnreg 24 / 240 (128 x 24 + 256 x 240 registers). p.V runs as an
//   n256 and an n64 wgmma: wgmma takes N <= 256, and V, read MN-major
//   through the 128-byte swizzle, splits only at a 64-column box. A 64-key
//   tile leaves no shared memory for two stages (240 KB); 32 keys ran
//   slower, and so did head_dim split between the two consumers over the
//   same 64 query rows with 64-key tiles (PERF.md).
//
// Loads. The producer loads the CTA's Q tile once, then each key tile's K
// and V (BN keys) into a ring of STAGES shared-memory stages, through 4-D
// tensor maps (hd, head, seq, batch; byte strides from the launcher's
// element strides) with the 128-byte swizzle. A bf16 row of 64 elements is
// 128 bytes, so a tile is HD / 64 boxes of 64 columns (at hd 32 one box of
// 32 columns, 64 bytes, under the 64-byte swizzle). K and V have a
// "full" mbarrier each per stage (the producer's expect_tx, TMA's complete
// transaction count) and an "empty" one each, which takes the 256 consumer
// threads' arrivals once they are done with that tile: K as soon as its
// s-product is done, V after its p.V, so the next K is in flight while a
// tile's V is still in use. Rows at or past S arrive as zeros; the mask
// still drops keys with kpos >= S (a zero K row scores 0, not -inf).
//
// Products. s (64 x BN per warpgroup) is an SS wgmma m64nBNk16 over
// head_dim in steps of 16: Q (A) and K (B) both K-major in the swizzled
// tiles, a step of 16 columns being 32 bytes within a 128-byte swizzle row,
// and a new box every 64 columns. p.V is an RS wgmma m64nNk16 over the
// keys, N = 64 per box of head_dim, at most 256: p goes from the s
// accumulator's register layout straight into the A-operand layout
// (registers 8kk..8kk+7 of s are the A fragment of key step kk, packed as
// bf16 pairs), and V is the B operand read MN-major (transposed) from the
// same swizzled tiles: a key step is 16 rows of 128 bytes, and the next
// 64-column box of head_dim lies one box further on (the descriptor's
// leading byte offset).
//
// Softmax. Scale and mask are applied in fp32 on the accumulator
// fragments (thread lane holds rows lane / 4 and lane / 4 + 8 of its
// warp's 16, columns 8 j + 2 (lane % 4) + {0, 1}), in the log2 domain (the
// scale times log2 e multiplies the scores once; p = 2^(x - m) on MUFU.EX2);
// row maxima are reduced over the 4 threads of a row with shuffles, row
// sums are kept per thread and reduced once at the end. Key tiles wholly
// outside a warpgroup's causal or window range are skipped by that
// warpgroup (it still waits on and releases their stages, so the ring
// stays in step); tiles wholly inside it skip the mask.
//
// Overlap within a warpgroup. For each tile after its first, a consumer
// issues the tile's s-product and then the previous tile's p.V products,
// waits for the s-product alone, and runs the tile's softmax while p.V
// still runs on the tensor cores; then it waits for p.V, rescales acc and
// splits the new p into the fragments.
//
// Overlap between the warpgroups (ping-pong). The two consumers take
// turns to issue their wgmmas, through two named barriers, so that one's
// softmax runs while the other's products occupy the tensor cores.
//
// Not done yet (later work, see PERF.md): a persistent scheduler for the
// tail of the causal grid; a TMA store of the output; the masked half of
// the diagonal tile that the first consumer computes and discards.

template <int HD_, int BN, int STAGES>
struct WgCfg {
  static constexpr bool kFp32 = false;          // bf16 q, k, v and o
  static constexpr bool kPrepared = false;      // wgmma reads K, V as landed
  static constexpr bool kSplit = false;         // each consumer: all of hd
  static constexpr int kThreads = 384;         // producer + two consumers
  static constexpr int HD = HD_;
  static constexpr int kBN = BN;                // keys per tile
  static constexpr int kStages = STAGES;        // K/V ring depth
  static constexpr int kBM = 128;               // query rows per CTA
  // columns of a box: 64 (128 bytes, the 128-byte swizzle), or the whole
  // 32-column row (64 bytes, the 64-byte swizzle) at hd 32
  static constexpr int kBoxCols = HD < 64 ? HD : 64;
  static constexpr int kRowBytes = 2 * kBoxCols;  // a box row; its swizzle
  static constexpr int kBoxes = HD / kBoxCols;  // boxes per row
  static constexpr int kAcc = HD / 2;           // accumulator floats a thread
  static constexpr int kProducerRegs = HD > 128 ? 24 : 40;
  static constexpr int kConsumerRegs = HD > 128 ? 240 : 232;
  static constexpr int kQBox = kBM * kRowBytes;  // bytes of one Q box
  static constexpr int kKVBox = kBN * kRowBytes;  // bytes of one K or V box
  static constexpr int kQBytes = kBoxes * kQBox;
  static constexpr int kTileBytes = kBoxes * kKVBox;
  static constexpr int kVOffset = kTileBytes;   // a stage: K, then V
  static constexpr int kStageBytes = 2 * kTileBytes;
  static constexpr int kBarOffset = kQBytes + kStages * kStageBytes;
  static constexpr int kBars = 1 + 4 * kStages;  // q; k/v full, k/v empty
  // + 1024: the tiles start on a 1024-byte boundary (the swizzle atom)
  static constexpr int kSmem = kBarOffset + 8 * kBars + 1024;
  static_assert((HD == 32 || HD % 64 == 0) && BN % 16 == 0 && BN <= 256,
                "wgmma kernel: head_dim 32 or in boxes of 64, keys in steps "
                "of 16");
  static_assert(kBoxes <= 8, "p.V in at most two wgmmas of N <= 256");
  static_assert(kSmem <= 232448, "227 KB of shared memory a block");
};

using WgHd32 = WgCfg<32, 128, 2>;
using WgHd64 = WgCfg<64, 128, 2>;
using WgHd128 = WgCfg<128, 128, 2>;
using WgHd320 = WgCfg<320, 48, 2>;

// Calls F<C>(...) for the instance C of head_dim hd.
#define WGMMA_DISPATCH(F, hd, ...)                \
  if ((hd) == 32) return F<WgHd32>(__VA_ARGS__);   \
  if ((hd) == 64) return F<WgHd64>(__VA_ARGS__);   \
  if ((hd) == 128) return F<WgHd128>(__VA_ARGS__); \
  if ((hd) == 320) return F<WgHd320>(__VA_ARGS__); \
  return cudaErrorInvalidValue;

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(bar),
               "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(
                   bar), "r"(bytes) : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" ::"r"(bar)
               : "memory");
}

__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done) : "r"(bar), "r"(parity) : "memory");
  } while (!done);
}

// One box of a 4-D tensor map into shared memory, completing on `bar`.
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map,
                                         uint32_t bar, int c0, int c1, int c2,
                                         int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%2, %3, %4, %5}], [%6];" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(c2),
      "r"(c3), "r"(bar)
      : "memory");
}

// wgmma shared-memory descriptor of a layout under the SW-byte swizzle
// (128, 64 or 32; rows of SW bytes, 8-row groups SW * 8 bytes apart):
// start address, leading and stride byte offsets, all in 16-byte units,
// and the swizzle mode in bits 62-63 (1: 128 bytes, 2: 64, 3: 32).
template <int SW>
__device__ __forceinline__ uint64_t sw_desc(uint32_t addr, uint32_t lbo,
                                            uint32_t sbo) {
  static_assert(SW == 128 || SW == 64 || SW == 32, "a wgmma swizzle mode");
  constexpr uint64_t kMode = SW == 128 ? 1 : SW == 64 ? 2 : 3;
  return (uint64_t)((addr & 0x3FFFF) >> 4) |
         ((uint64_t)((lbo >> 4) & 0x3FFF) << 16) |
         ((uint64_t)((sbo >> 4) & 0x3FFF) << 32) | (kMode << 62);
}

// Named barrier `id` over the two consumer warpgroups (256 threads).
__device__ __forceinline__ void bar_sync(int id) {
  asm volatile("bar.sync %0, 256;" ::"r"(id) : "memory");
}
__device__ __forceinline__ void bar_arrive(int id) {
  asm volatile("bar.arrive %0, 256;" ::"r"(id) : "memory");
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
}
// Wait until at most N of this warpgroup's committed groups are pending.
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;" ::"n"(N) : "memory");
}
// Keep the compiler from moving reads of an accumulator above the wait.
template <int N>
__device__ __forceinline__ void fence_regs(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// d[OFF, OFF + N) of an accumulator, as an array of its own.
template <int N, int OFF, int M>
__device__ __forceinline__ auto part(float (&d)[M]) -> float (&)[N] {
  static_assert(OFF + N <= M, "accumulator part out of range");
  return *reinterpret_cast<float(*)[N]>(&d[OFF]);
}

#define WG_D4 "{%0, %1, %2, %3}"
#define WG_D8 "{%0, %1, %2, %3, %4, %5, %6, %7}"
#define WG_D16 \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}"
#define WG_D24                                                              \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, " \
  "%16, %17, %18, %19, %20, %21, %22, %23}"
#define WG_D32                                                              \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, " \
  "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, "  \
  "%30, %31}"
#define WG_D64                                                              \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, " \
  "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, "  \
  "%30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, "  \
  "%44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, "  \
  "%58, %59, %60, %61, %62, %63}"
#define WG_D80                                                               \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "  \
  "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, "   \
  "%30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, "   \
  "%44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, "   \
  "%58, %59, %60, %61, %62, %63, %64, %65, %66, %67, %68, %69, %70, %71, "   \
  "%72, %73, %74, %75, %76, %77, %78, %79}"
#define WG_D128                                                             \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, " \
  "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, "  \
  "%30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, "  \
  "%44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, "  \
  "%58, %59, %60, %61, %62, %63, %64, %65, %66, %67, %68, %69, %70, %71, "  \
  "%72, %73, %74, %75, %76, %77, %78, %79, %80, %81, %82, %83, %84, %85, "  \
  "%86, %87, %88, %89, %90, %91, %92, %93, %94, %95, %96, %97, %98, %99, "  \
  "%100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110, "      \
  "%111, %112, %113, %114, %115, %116, %117, %118, %119, %120, %121, "      \
  "%122, %123, %124, %125, %126, %127}"
#define WG_F8(d, i)                                                     \
  "+f"(d[i]), "+f"(d[i + 1]), "+f"(d[i + 2]), "+f"(d[i + 3]),           \
      "+f"(d[i + 4]), "+f"(d[i + 5]), "+f"(d[i + 6]), "+f"(d[i + 7])
#define WG_F4(d) "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
#define WG_F8A(d) WG_F8(d, 0)
#define WG_F16(d) WG_F8(d, 0), WG_F8(d, 8)
#define WG_F24(d) WG_F8(d, 0), WG_F8(d, 8), WG_F8(d, 16)
#define WG_F32(d) WG_F24(d), WG_F8(d, 24)
#define WG_F64(d) \
  WG_F32(d), WG_F8(d, 32), WG_F8(d, 40), WG_F8(d, 48), WG_F8(d, 56)
#define WG_F80(d) WG_F64(d), WG_F8(d, 64), WG_F8(d, 72)
#define WG_F128(d)                                                      \
  WG_F64(d), WG_F8(d, 64), WG_F8(d, 72), WG_F8(d, 80), WG_F8(d, 88),    \
      WG_F8(d, 96), WG_F8(d, 104), WG_F8(d, 112), WG_F8(d, 120)

// d (+)= A.B^T, m64nNk16 with N = 2 * (the size of d): A (64 x 16) and B
// (N x 16) K-major in shared memory; `accumulate` 0 overwrites d. IA, IB,
// IP: the operand numbers of the two descriptors and the flag.
#define WG_SS(N, D, F, IA, IB, IP)                                          \
  __device__ __forceinline__ void wgmma_ss(float(&d)[N / 2], uint64_t da,    \
                                           uint64_t db, int accumulate) {    \
    asm volatile("{\n.reg .pred p;\nsetp.ne.b32 p, %" #IP ", 0;\n"          \
                 "wgmma.mma_async.sync.aligned.m64n" #N                      \
                 "k16.f32.bf16.bf16 " D ", %" #IA ", %" #IB                  \
                 ", p, 1, 1, 0, 0;\n}\n"                                     \
                 : F(d)                                                      \
                 : "l"(da), "l"(db), "r"(accumulate));                      \
  }
WG_SS(48, WG_D24, WG_F24, 24, 25, 26)
WG_SS(128, WG_D64, WG_F64, 64, 65, 66)

// d += A.B, m64nNk16 with N = 2 * (the size of d): A (64 x 16) from
// registers as bf16 pairs, B (16 x N) MN-major in shared memory. I0..I3,
// IB, IP: the operand numbers of the A registers, the descriptor and the
// flag.
#define WG_RS(N, D, F, I0, I1, I2, I3, IB, IP)                              \
  __device__ __forceinline__ void wgmma_rs(float(&d)[N / 2],                 \
                                           const uint32_t(&a)[4],            \
                                           uint64_t db) {                    \
    asm volatile("{\n.reg .pred p;\nsetp.ne.b32 p, %" #IP ", 0;\n"          \
                 "wgmma.mma_async.sync.aligned.m64n" #N                      \
                 "k16.f32.bf16.bf16 " D ", {%" #I0 ", %" #I1 ", %" #I2       \
                 ", %" #I3 "}, %" #IB ", p, 1, 1, 1;\n}\n"                   \
                 : F(d)                                                      \
                 : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db),      \
                   "r"(1));                                                  \
  }
WG_RS(32, WG_D16, WG_F16, 16, 17, 18, 19, 20, 21)
WG_RS(64, WG_D32, WG_F32, 32, 33, 34, 35, 36, 37)
WG_RS(128, WG_D64, WG_F64, 64, 65, 66, 67, 68, 69)
WG_RS(256, WG_D128, WG_F128, 128, 129, 130, 131, 132, 133)

__device__ __forceinline__ uint32_t bf16_pair(float a, float b) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(a, b);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// (a, b) -> bf16 pairs hi = bf16(a, b) and lo = bf16(a - hi.a, b - hi.b)
__device__ __forceinline__ void split_pair(float a, float b, uint32_t& hi,
                                           uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(a, b);
  const float2 hf = __bfloat1622float2(h);
  hi = *reinterpret_cast<const uint32_t*>(&h);
  lo = bf16_pair(a - hf.x, b - hf.y);
}

// 2^x (MUFU.EX2); x <= 0 here, so flushing subnormals to zero only drops
// a p below 2^-126, against a row sum l >= 1.
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// Where this thread's scores live in a tile: rows row[0], row[1] and, for
// accumulator register 4 j + e, row row[e / 2] and key kv0 + 8 j + col +
// e % 2.
struct Frag {
  int row[2];
  int col;
};

// One online-softmax step on a tile's scores (BN keys), in the log2 domain
// (x = s * scale * log2 e, so exp(s * scale - m) = 2^(x - m / log2 e)): the
// masked scores, the row max over the 4 threads of a row, corr = 2^(m -
// m_new), and p = valid ? 2^(x - m_new) : 0 in place of the scores; l
// (this thread's part of the row sums) becomes l * corr + sum p. `full`:
// every key of the tile is valid for every row, no mask.
//
// A masked score is -1e30, so 2^(x - m_new) is 0 on it unless m_new is
// still -1e30, which happens only when every key of the row so far is
// masked; then p is 0 on the whole row. That is the reference's `where`
// on p, taken once per row.
template <int BN>
__device__ __forceinline__ void softmax_step(float (&sc)[BN / 2], float (&m)[2],
                                             float (&l)[2], float (&corr)[2],
                                             const Frag& f, int kv0, bool full,
                                             int seq, int causal, int window,
                                             float scale_log2) {
  float mx[2] = {m[0], m[1]};
  if (full) {
#pragma unroll
    for (int j = 0; j < BN / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        sc[4 * j + e] *= scale_log2;
        mx[e >> 1] = fmaxf(mx[e >> 1], sc[4 * j + e]);
      }
  } else {
    // key kv0 + f.col + c of the tile, c = 8 j + e % 2, is valid for row
    // r iff c < seq - kv0 - f.col and, when causal, lo[r] < c <= hi[r]
    const int cols = seq - kv0 - f.col;
    int hi[2], lo[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      hi[r] = causal ? f.row[r] - kv0 - f.col : BN;
      lo[r] = causal ? hi[r] - window : -1;
    }
#pragma unroll
    for (int j = 0; j < BN / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int c = 8 * j + (e & 1);
        const int r = e >> 1;
        const bool ok = c < cols && c <= hi[r] && c > lo[r];
        const float x = ok ? sc[4 * j + e] * scale_log2 : kNeg;
        sc[4 * j + e] = x;
        mx[r] = fmaxf(mx[r], x);
      }
  }
  bool none[2];  // no valid key in the row yet
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
    mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
    corr[r] = ex2(m[r] - mx[r]);
    m[r] = mx[r];
    l[r] *= corr[r];
    none[r] = mx[r] == kNeg;
  }
#pragma unroll
  for (int j = 0; j < BN / 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const float p = none[e >> 1] ? 0.f : ex2(sc[4 * j + e] - m[e >> 1]);
      sc[4 * j + e] = p;
      l[e >> 1] += p;
    }
}

// p (fp32, accumulator layout) -> the A-operand fragments of the p.V
// wgmmas, p_hi = bf16(p) and p_lo = bf16(p - p_hi): key step kk is the
// accumulator registers 8 kk .. 8 kk + 7 as four bf16 pairs.
template <int BN>
__device__ __forceinline__ void split_fragments(const float (&sc)[BN / 2],
                                                uint32_t (&ph)[BN / 16][4],
                                                uint32_t (&pl)[BN / 16][4]) {
#pragma unroll
  for (int kk = 0; kk < BN / 16; ++kk)
#pragma unroll
    for (int r = 0; r < 4; ++r)
      split_pair(sc[8 * kk + 2 * r], sc[8 * kk + 2 * r + 1], ph[kk][r],
                 pl[kk][r]);
}

// s = Q.K^T for this warpgroup's 64 rows against a K tile (one group):
// k16 steps of 32 bytes within a box row (kRowBytes: 128, or 64 at hd
// 32, whose whole row is two steps under the 64-byte swizzle), a new box
// every kRowBytes / 32 steps.
// At hd 320 the two bases pass through an empty asm, so that the compiler
// computes the 20 k-steps' descriptors at each tile, next to their wgmmas:
// hoisted out of the tile loop, beside the 160-register accumulator, they
// spilled, and the kernel ran slower.
template <class C>
__device__ __forceinline__ void issue_qk(float (&sc)[C::kBN / 2],
                                         uint32_t q_rows, uint32_t k_tile) {
  constexpr int kRow = C::kRowBytes, kSteps = kRow / 32;
  if constexpr (C::HD > 128) asm volatile("" : "+r"(q_rows), "+r"(k_tile));
#pragma unroll
  for (int kk = 0; kk < C::HD / 16; ++kk) {
    const uint32_t step = (kk % kSteps) * 32;  // 16 columns in a row
    wgmma_ss(sc,
             sw_desc<kRow>(q_rows + (kk / kSteps) * C::kQBox + step, 16,
                           8 * kRow),
             sw_desc<kRow>(k_tile + (kk / kSteps) * C::kKVBox + step, 16,
                           8 * kRow),
             kk > 0);
  }
}

// acc += p_hi.V + p_lo.V over a V tile (one group), in at most two wgmmas
// a key step (N <= 256 each): head_dim boxes [0, N0) and [N0, kBoxes), a
// box being kBoxCols columns (kBoxCols / 2 accumulator floats a thread).
template <class C>
__device__ __forceinline__ void issue_pv(float (&acc)[C::kAcc],
                                         const uint32_t (&ph)[C::kBN / 16][4],
                                         const uint32_t (&pl)[C::kBN / 16][4],
                                         uint32_t v_tile) {
  constexpr int NB = C::kBoxes, kRow = C::kRowBytes, F = C::kBoxCols / 2;
  constexpr int N0 = NB < 4 ? NB : 4;  // boxes of the first wgmma
#pragma unroll
  for (int kk = 0; kk < C::kBN / 16; ++kk) {
    const uint32_t rows = v_tile + kk * 16 * kRow;
    const uint64_t dv = sw_desc<kRow>(rows, C::kKVBox, 8 * kRow);
    wgmma_rs(part<F * N0, 0>(acc), ph[kk], dv);
    wgmma_rs(part<F * N0, 0>(acc), pl[kk], dv);
    if constexpr (NB > N0) {
      const uint64_t dv1 =
          sw_desc<kRow>(rows + N0 * C::kKVBox, C::kKVBox, 8 * kRow);
      wgmma_rs(part<F * (NB - N0), F * N0>(acc), ph[kk], dv1);
      wgmma_rs(part<F * (NB - N0), F * N0>(acc), pl[kk], dv1);
    }
  }
}

__device__ __forceinline__ void store_pair(__nv_bfloat16* p, float a, float b) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(a, b);
}
__device__ __forceinline__ void store_pair(float* p, float a, float b) {
  *reinterpret_cast<float2*>(p) = make_float2(a, b);
}

// Rows f.row[r] < seq of o (this head's rows, row stride os) take acc / l:
// register 4 j + 2 r + {0, 1} is row f.row[r], column col0 + 8 j + f.col +
// {0, 1} (col0: the warpgroup's first column, 0 unless head_dim is split).
template <class C, typename T>
__device__ __forceinline__ void store_rows(const float (&acc)[C::kAcc],
                                           const float (&l)[2], const Frag& f,
                                           T* o, long long os, int seq,
                                           int col0) {
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    if (f.row[r] >= seq) continue;
    const float denom = fmaxf(l[r], 1e-20f);
    T* orow = o + (long long)f.row[r] * os + col0 + f.col;
#pragma unroll
    for (int j = 0; j < C::kAcc / 4; ++j)
      store_pair(orow + 8 * j, acc[4 * j + 2 * r] / denom,
                 acc[4 * j + 2 * r + 1] / denom);
  }
}

// A CTA's shared memory in both tensor-core kernels, from its 1024-byte
// aligned base: the Q tile, the ring of key-tile stages, and the
// mbarriers, per stage s: K and V landed (TMA); K and V ready for the
// consumers (the landed barriers themselves in the bf16 kernel, the prep
// warps' own in the tf32 kernel); K and V released by both consumers.
// Every address is the base plus a constant, so only the base stays in a
// register.
template <class C>
struct Ring {
  uint32_t base;
  __device__ __forceinline__ uint32_t q() const { return base; }
  __device__ __forceinline__ uint32_t stage(int s) const {
    return base + C::kQBytes + s * C::kStageBytes;
  }
  __device__ __forceinline__ uint32_t q_full() const {
    return base + C::kBarOffset;
  }
  __device__ __forceinline__ uint32_t k_full(int s) const {
    return q_full() + 8 + 8 * s;
  }
  __device__ __forceinline__ uint32_t v_full(int s) const {
    return k_full(s) + 8 * C::kStages;
  }
  __device__ __forceinline__ uint32_t k_empty(int s) const {
    return v_full(s) + 8 * C::kStages;
  }
  __device__ __forceinline__ uint32_t v_empty(int s) const {
    return k_empty(s) + 8 * C::kStages;
  }
  __device__ __forceinline__ uint32_t k_ready(int s) const {
    return C::kPrepared ? v_empty(s) + 8 * C::kStages : k_full(s);
  }
  __device__ __forceinline__ uint32_t v_ready(int s) const {
    return C::kPrepared ? k_ready(s) + 8 * C::kStages : v_full(s);
  }
};

template <class C>
__device__ __forceinline__ Ring<C> make_ring(const uint8_t* smem_raw) {
  return {(smem_addr(smem_raw) + 1023u) & ~1023u};
}

// Thread 0: every barrier of the ring, before the CTA's __syncthreads.
template <class C>
__device__ __forceinline__ void init_ring(const Ring<C>& r) {
  mbar_init(r.q_full(), 1);
#pragma unroll
  for (int s = 0; s < C::kStages; ++s) {
    mbar_init(r.k_full(s), 1);
    mbar_init(r.v_full(s), 1);
    mbar_init(r.k_empty(s), 2 * 128);
    mbar_init(r.v_empty(s), 2 * 128);
    if constexpr (C::kPrepared) {
      mbar_init(r.k_ready(s), C::kKPrepThreads);
      mbar_init(r.v_ready(s), C::kVPrepThreads);
    }
  }
  asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
}

// The CTA's tile of query rows (q0: the q tiles are walked last to first,
// so the CTAs with the most key tiles start first) and its key tiles
// [t_begin, t_end): those that hold a valid key for one of its rows.
struct Tiles {
  int q0, t_begin, t_end;
};

template <class C>
__device__ __forceinline__ Tiles key_tiles(int seq, int causal, int window) {
  const int q0 = (int)(gridDim.y - 1 - blockIdx.y) * C::kBM;
  int lo = 0, hi = seq;
  if (causal) {
    hi = min(seq, q0 + C::kBM);
    const long long first = (long long)q0 - window + 1;
    lo = first > 0 ? (int)first : 0;
  }
  return {q0, lo / C::kBN, (hi + C::kBN - 1) / C::kBN};
}

// Thread 0 of the producer warpgroup: the CTA's Q tile once, then key tile
// t's K and V into ring slot i = t - t_begin (stage i % kStages, V
// kVOffset bytes after K), each once both consumers released the slot's
// previous tile. Boxes of kBoxCols columns (128 bytes) of head_dim.
template <class C>
__device__ __forceinline__ void load_tiles(const CUtensorMap* tq,
                                           const CUtensorMap* tk,
                                           const CUtensorMap* tv,
                                           const Ring<C>& r, const Tiles& tl,
                                           int h, int hk, int b) {
  mbar_expect_tx(r.q_full(), C::kQBytes);
#pragma unroll
  for (int c = 0; c < C::kBoxes; ++c)
    tma_load(r.q() + c * C::kQBox, tq, r.q_full(), C::kBoxCols * c, h,
             tl.q0, b);
  for (int t = tl.t_begin, i = 0; t < tl.t_end; ++t, ++i) {
    const int s = i % C::kStages;
    // the first lap finds the stage free (the parity of the phase before
    // the barrier's first)
    const uint32_t parity = ((uint32_t)(i / C::kStages) & 1u) ^ 1u;
    const uint32_t ks = r.stage(s);
    mbar_wait(r.k_empty(s), parity);
    mbar_expect_tx(r.k_full(s), C::kTileBytes);
#pragma unroll
    for (int c = 0; c < C::kBoxes; ++c)
      tma_load(ks + c * C::kKVBox, tk, r.k_full(s), C::kBoxCols * c, hk,
               t * C::kBN, b);
    mbar_wait(r.v_empty(s), parity);
    mbar_expect_tx(r.v_full(s), C::kTileBytes);
#pragma unroll
    for (int c = 0; c < C::kBoxes; ++c)
      tma_load(ks + C::kVOffset + c * C::kKVBox, tv, r.v_full(s),
               C::kBoxCols * c, hk, t * C::kBN, b);
  }
}

// Probes of the tf32 kernel, for chip_smoke.py --tile-ab's account of where
// the hd-32 instance's time goes; set at build time only, and wrong by
// design: bit 0 drops the consumers' softmax and split of p on every tile
// after a warpgroup's first (the fragments and acc keep their values, corr
// = 1), bit 1 the prep warps' splits of K and V (they only signal).
#ifndef TF32_PROBE
#define TF32_PROBE 0
#endif
constexpr int kProbe = TF32_PROBE;

// One consumer warpgroup (cw = 0 or 1, query rows q0 + 64 cw ..; with
// C::kSplit both take rows q0 .. q0 + 63, and columns cw * HD / 2 ..) of
// either tensor-core kernel, after its Q tile landed: the online softmax
// over the CTA's key tiles, the products issued through `prod` --
// prod.qk(sc, stage) the s-product against a stage's K, prod.combine(sc,
// n) the sum of the two warpgroups' halves of s (n: the tile's parity;
// nothing without kSplit), prod.pv(acc, stage) acc += p.V against its V
// with the fragments prod.split(p) made -- and this warpgroup's part of o
// stored.
template <class C, class Products, typename T>
__device__ __forceinline__ void consume(Products& prod, const Ring<C>& r,
                                        const Tiles& tl, T* o, long long os,
                                        int seq, int causal, int window,
                                        float scale) {
  constexpr int BN = C::kBN, kStages = C::kStages;
  const int t_begin = tl.t_begin, t_end = tl.t_end;
  const int cw = threadIdx.x / 128 - 1;  // 0 or 1
  const int lane = threadIdx.x & 31;
  const int r0 = tl.q0 + (C::kSplit ? 0 : 64 * cw);  // its first row
  const int warp_row = r0 + 16 * ((threadIdx.x & 127) >> 5) + (lane >> 2);
  const Frag f{{warp_row, warp_row + 8}, 2 * (lane & 3)};
  const float scale_log2 = scale * 1.4426950408889634f;

  // This warpgroup's own tiles [w_begin, w_end) of the CTA's: those
  // with a valid key for one of its rows. It still waits on and releases
  // the others, so the ring stays in step.
  int w_begin = t_begin, w_end = t_end;
  if (r0 >= seq) {
    w_begin = w_end = t_end;
  } else if (causal) {
    const long long first = (long long)r0 - window + 1;
    w_begin = max(t_begin, first > 0 ? (int)(first / BN) : 0);
    w_end = min(t_end, (r0 + 63) / BN + 1);
  }
  // every key of tile t is valid for every row of the warpgroup
  auto full_tile = [&](int t) {
    const int kv0 = t * BN;
    return kv0 + BN <= seq &&
           (!causal || (kv0 + BN - 1 <= r0 && kv0 >= r0 + 64 - window));
  };
  // Turns: the two consumers issue their wgmmas in alternation (named
  // barriers 1 and 2), so one's softmax runs beside the other's
  // products. Each takes one turn per tile of the CTA and one more for
  // its last p.V, t_end - t_begin + 1 in all; consumer 1 lets consumer 0
  // go first and gives back no turn after its last. With kSplit the two
  // meet at every tile to sum s, and take no turns.
  const int turns = t_end - t_begin + 1;
  int turn = 0;
  auto turn_begin = [&]() {
    if constexpr (!C::kSplit) bar_sync(1 + cw);
  };
  auto turn_end = [&]() {
    if constexpr (!C::kSplit)
      if (++turn < turns || cw == 0) bar_arrive(2 - cw);
  };
  if (!C::kSplit && cw == 1) bar_arrive(1);
  auto pass = [&](int i) {  // wait on and release ring slot i unused
    const int s = i % kStages;
    const uint32_t parity = (uint32_t)(i / kStages) & 1u;
    mbar_wait(r.k_ready(s), parity);
    mbar_arrive(r.k_empty(s));
    mbar_wait(r.v_ready(s), parity);
    mbar_arrive(r.v_empty(s));
    turn_begin();
    turn_end();
  };

  float m[2] = {kNeg, kNeg};
  float l[2] = {0.f, 0.f};  // this thread's part of the row sums
  float corr[2];
  float acc[C::kAcc];
#pragma unroll
  for (int i = 0; i < C::kAcc; ++i) acc[i] = 0.f;

  int i = 0;  // ring slot of tile t_begin + i
  for (; i < w_begin - t_begin; ++i) pass(i);
  if (w_begin < w_end) {
    float sc[BN / 2];
    // first tile: s, then p
    {
      const int s = i % kStages;
      const uint32_t parity = (uint32_t)(i / kStages) & 1u;
      mbar_wait(r.k_ready(s), parity);
      turn_begin();
      wgmma_fence();
      prod.qk(sc, r.stage(s));
      wgmma_commit();
      turn_end();
      wgmma_wait<0>();
      fence_regs(sc);
      mbar_arrive(r.k_empty(s));
      prod.combine(sc, 0);
      softmax_step<BN>(sc, m, l, corr, f, w_begin * BN, full_tile(w_begin),
                       seq, causal, window, scale_log2);
      prod.split(sc);
    }
    // Each later tile: its s-product and the previous tile's p.V run on
    // the tensor cores while this tile's softmax runs; acc is rescaled
    // and the new p takes the fragments once p.V is done.
    for (int t = w_begin + 1; t < w_end; ++t) {
      const int sp = i % kStages;
      const uint32_t pp = (uint32_t)(i / kStages) & 1u;
      ++i;
      const int s = i % kStages;
      const uint32_t parity = (uint32_t)(i / kStages) & 1u;
      mbar_wait(r.k_ready(s), parity);
      mbar_wait(r.v_ready(sp), pp);
      turn_begin();
      wgmma_fence();
      prod.qk(sc, r.stage(s));
      wgmma_commit();
      prod.pv(acc, r.stage(sp));
      wgmma_commit();
      turn_end();
      wgmma_wait<1>();  // the s-product
      fence_regs(sc);
      mbar_arrive(r.k_empty(s));
      prod.combine(sc, (t - w_begin) & 1);
      constexpr bool kBare = C::kFp32 && (kProbe & 1);
      if constexpr (kBare)
        corr[0] = corr[1] = 1.f;
      else
        softmax_step<BN>(sc, m, l, corr, f, t * BN, full_tile(t), seq,
                         causal, window, scale_log2);
      wgmma_wait<0>();  // the previous p.V
      fence_regs(acc);
      mbar_arrive(r.v_empty(sp));
#pragma unroll
      for (int j = 0; j < C::kAcc / 4; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[4 * j + e] *= corr[e >> 1];
      if constexpr (!kBare) prod.split(sc);
    }
    // the last tile's p.V
    const int s = i % kStages;
    mbar_wait(r.v_ready(s), (uint32_t)(i / kStages) & 1u);
    turn_begin();
    wgmma_fence();
    prod.pv(acc, r.stage(s));
    wgmma_commit();
    turn_end();
    wgmma_wait<0>();
    fence_regs(acc);
    mbar_arrive(r.v_empty(s));
    ++i;
  }
  for (; i < t_end - t_begin; ++i) pass(i);
  if (!C::kSplit && turn < turns) {  // no p.V of its own: an empty turn
    turn_begin();
    turn_end();
  }

#pragma unroll
  for (int k = 0; k < 2; ++k) {
    l[k] += __shfl_xor_sync(0xffffffffu, l[k], 1);
    l[k] += __shfl_xor_sync(0xffffffffu, l[k], 2);
  }
  store_rows<C>(acc, l, f, o, os, seq, C::kSplit ? cw * 2 * C::kAcc : 0);
}

// The bf16 kernel's products: Q (this warpgroup's 64 rows at q_rows) and
// K from shared memory, p split into the bf16 fragments ph, pl.
template <class C>
struct Bf16Products {
  uint32_t q_rows;
  uint32_t ph[C::kBN / 16][4], pl[C::kBN / 16][4];
  __device__ __forceinline__ void qk(float (&sc)[C::kBN / 2], uint32_t st) {
    issue_qk<C>(sc, q_rows, st);
  }
  __device__ __forceinline__ void pv(float (&acc)[C::kAcc], uint32_t st) {
    issue_pv<C>(acc, ph, pl, st + C::kVOffset);
  }
  __device__ __forceinline__ void split(const float (&sc)[C::kBN / 2]) {
    split_fragments<C::kBN>(sc, ph, pl);
  }
  __device__ __forceinline__ void combine(float (&)[C::kBN / 2], int) {}
};

template <class C>
__global__ void __launch_bounds__(C::kThreads, 1)
    flash_attention_wgmma_kernel(const __grid_constant__ CUtensorMap tq,
                                 const __grid_constant__ CUtensorMap tk,
                                 const __grid_constant__ CUtensorMap tv,
                                 __nv_bfloat16* __restrict__ o, int seq,
                                 int heads, int group, long long ob,
                                 long long os, long long oh, int window,
                                 int causal, float scale) {
  extern __shared__ uint8_t smem_raw[];
  const Ring<C> ring = make_ring<C>(smem_raw);
  const int b = blockIdx.x / heads;
  const int h = blockIdx.x - b * heads;
  const Tiles tiles = key_tiles<C>(seq, causal, window);
  if (threadIdx.x == 0) init_ring<C>(ring);
  __syncthreads();

  if (threadIdx.x < 128) {
    // ---- producer warpgroup: one thread issues every load ----
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;" ::"n"(
        C::kProducerRegs));
    if (threadIdx.x == 0)
      load_tiles<C>(&tq, &tk, &tv, ring, tiles, h, h / group, b);
  } else {
    // ---- consumer warpgroups: 64 query rows each ----
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;" ::"n"(
        C::kConsumerRegs));
    Bf16Products<C> prod;
    prod.q_rows = ring.q() + (threadIdx.x / 128 - 1) * 64 * C::kRowBytes;
    mbar_wait(ring.q_full(), 0);
    consume<C>(prod, ring, tiles, o + b * ob + h * oh, os, seq, causal,
               window, scale);
  }
}

// ---------------------------------------------------------------------------
// flash_attention_tf32_kernel: fp32 at head_dim 32, 64, 128 and 320, on
// the tensor cores as three TF32 products (3xTF32)
// ---------------------------------------------------------------------------
//
// Computes what flash_attention_kernel computes (same masks, same
// `valid ? exp(s - m) : 0`, same acc / max(l, 1e-20), scale on the fp32
// scores, GQA by h / G, (batch, seq, head) element strides) for fp32 q, k,
// v and o at head_dim 32, 64, 128 and 320, and replaces the same TPU kernel
// (src/repro/kernels/attention.py: _flash_kernel, whose products take fp32
// operands).
//
// Bound on this card. At the served shape in fp32 (B = 8, S = 2048, 16
// heads, 8 kv heads, head_dim 128, causal) q.k^T and p.V are 1.375e11 flop;
// as three TF32 products each, 4.1e11 flop, 0.833 ms at the tensor cores'
// 495 TFLOP/s TF32, against 2.05 ms for the same work in fp32 on the CUDA
// cores (67 TFLOP/s) and 0.120 ms for the 403 MB of q, k, v and o at 3.35
// TB/s: the tensor operations bind, and this kernel puts them on wgmma.
//
// Precision. A TF32 operand keeps 10 of fp32's 23 fraction bits, and which
// 13 bits the hardware drops from a raw fp32 value is not specified, so no
// fp32 value enters a product unsplit: x_hi = tf32(x) and x_lo = tf32(x -
// x_hi), rounded as cvt.rna.tf32.f32 rounds (the subtraction is exact in
// fp32; the rounding is done on the integer units, tf32_rna), and a product
// a.b is a_hi.b_hi + a_hi.b_lo + a_lo.b_hi into one fp32 accumulator, the
// lo.lo term dropped: about 21 significant bits of each operand, for both
// s = q.k^T and acc += p.V. The softmax (max, exp, l, the rescale) stays
// fp32 on the CUDA cores, as in the other kernels; l sums the unsplit p.
//
// The CTA. 512 threads, grid (batch * heads, ceil(S / 128)), q tiles
// walked last to first, as in flash_attention_wgmma_kernel. Warpgroup 0
// (setmaxnreg down): thread 0 issues every TMA load, warps 1-3 split each
// landed K tile. Warpgroup 3 (setmaxnreg down) transposes and splits each
// landed V tile, beside them: the prep of a tile is 8,192 floats of CUDA-
// core work, and with K and V prepared in turn by three warps it held the
// consumers back. Warpgroups 1 and 2 (setmaxnreg up) are the consumers, 64
// query rows each; they run the bf16 kernel's loop (consume), with its
// ping-pong, its overlap of a tile's softmax with the products, and its
// skipping of key tiles outside a warpgroup's causal or window range.
//
// Operands. wgmma reads 32-bit operands from shared memory K-major only
// (there is no transpose bit):
// - s = Q.K^T: Q (A) and K (B) have head_dim contiguous, which TMA lands
//   K-major with the 128-byte swizzle (32 floats a row; head_dim in boxes
//   of 32 columns). Each consumer splits its 64 rows of Q once: Q_hi stays
//   in registers as the A fragments of an RS wgmma (HD / 2 registers a
//   thread), Q_lo replaces the raw Q in shared memory. The prep warps
//   split each K tile into K_hi, in place, and K_lo, a plane of the same
//   layout. Per k8 step: RS(Q_hi, K_hi) + RS(Q_hi, K_lo) + SS(Q_lo, K_hi),
//   m64nBNk8.
// - acc += p.V: keys, the reduction axis, are V's rows, so the prep warps
//   transpose each landed V tile into the planes V^T_hi and V^T_lo
//   (head_dim rows of BN keys, 128-byte swizzle, a box every 32 keys); TMA
//   cannot transpose. p comes straight from the s accumulator: thread lane
//   holds keys 8 j + 2 t + {0, 1} (t = lane % 4), and a k8 step's A
//   fragment wants columns t and t + 4. The prep warps store each group of
//   8 keys in V^T's planes in the order 0, 2, 4, 6, 1, 3, 5, 7, so column t
//   is key 2 t and column t + 4 key 2 t + 1: the fragment is registers d0,
//   d2, d1, d3 of s, split into p_hi and p_lo, with no shuffle. Per k8
//   step: RS(p_hi, V^T_hi) + RS(p_hi, V^T_lo) + RS(p_lo, V^T_hi), m64nHDk8.
//
// Budget (Tf32Cfg). Shared memory: Q_lo, 128 rows x HD floats; STAGES (2;
// 4 at hd 32) stages of K_hi, K_lo, raw V, V^T_hi and V^T_lo, BN x HD
// floats each; 1 + 6 STAGES mbarriers. At hd 128 with 32-key tiles 64 KB +
// 2 x 80 KB = 224 KB (230,504 bytes with the barriers and the swizzle
// alignment, of 232,448); at hd 64 with 64-key tiles 32 KB + 2 x 80 KB =
// 192 KB; at hd 32 16 KB + 4 x 40 KB = 176 KB. Consumer registers (setmaxnreg
// 232, warpgroups 0 and 3 24): Q_hi HD / 2, acc HD / 2, s BN / 2 and the
// p_hi and p_lo fragments BN / 2 each (s of a tile is formed while the
// previous tile's fragments feed p.V) -- 176 at hd 128, 160 at hd 64,
// 128 at hd 32.
//
// Head_dim 32 (the reduced configs in fp32). A row of 32 floats is one
// 128-byte box, the swizzle atom Q and K land in; Q_hi is 16 registers a
// thread (kQSteps = 4 k8 steps), acc 16, and p.V runs at m64n32k8. Q_lo
// takes 16 KB and a stage BN x 640 bytes (five planes of BN rows of 128
// bytes; V^T's key boxes, HD rows of 32 keys, fill one plane), so the
// tile and the ring's depth can be traded: BN = 64 at 2, 3 or 4 stages,
// or 128 at 2 (TF32_HD32_KEYS, TF32_HD32_STAGES; chip_smoke.py
// --tile-ab builds each and times them in turns). 64 keys at 4 stages
// ran fastest, 2 and 3 stages within 1% of it; 128 keys spill (s, p_hi
// and p_lo alone take 192 registers) and 32 keys ran 20% slower (PERF.md).
// Per score the consumers do as much CUDA-core work (mask, max, exp, the
// split of p) as at hd 128 against a quarter of the tensor work, and here
// that work adds to the products' time instead of hiding behind them: a
// build without the softmax and split of p (TF32_PROBE) takes 60% of the
// time, and without the prep of K and V too 49%, its products then at 1.2
// x the 3xTF32 bound (PERF.md).
//
// Head_dim 320 (gemma3-4b; kSplit). Q_hi of 64 rows (160 registers a
// thread) beside a 64 x 320 accumulator (160 more) does not fit a thread,
// and Q_lo of 128 rows alone takes 160 KB. So the CTA takes 64 query rows,
// and its two consumer warpgroups split head_dim instead of rows: each
// holds Q_hi of its 160 columns (80 registers) and acc of its 160 output
// columns (80), forms its half of s = Q.K^T over its columns, and the two
// halves meet in shared memory: each warpgroup stores its fragments (a
// thread's 4 floats, the same positions in both), one named barrier over
// both, and each adds the other's, half 0 + half 1 in both (fp32 addition
// commutes, so both hold the same bits of s and run the same softmax,
// with the same m, l and p). Each then runs p.V against its 160 columns of
// V^T (m64n160k8). Shared memory: Q_lo 64 x 320 floats (80 KB) and 3
// stages of 8-key tiles, each four planes of 8 x 320 floats (K_hi, K_lo,
// V^T_hi, V^T_lo: 40 KB; V lands in the V^T_lo plane, and the V-prep warps
// transpose it in place, box by box: a 32-column box of 8 keys is 1 KB of
// V and 1 KB of V^T, whose rows are 8 keys, 32 bytes, under the 32-byte
// swizzle), the exchange of s (2 tiles x 2 warpgroups x 128 threads x 16
// bytes: 8 KB), 19 mbarriers: 214,168 bytes. 8 keys is the largest tile
// two stages fit (16 keys: 240 KB), and three stages ran faster than two
// (an A/B on the card; PERF.md). At 8 keys a tile the small s-wgmmas
// dominate, so Q_hi.K_hi and Q_hi.K_lo run as one n16 wgmma
// (tf32_qk_paired): two wgmmas a k8 step, not three. Registers: consumers
// 224 (Q_hi 80, acc 80, s 16, p 8), the V-prep warpgroup 40 (a box's 8
// floats a lane), the load and K-prep warpgroup 24. The plain version
// sums s over the two halves as the kernel does (kernels/attention.py:
// TF32_SPLIT_HEAD_DIMS).

template <int HD_, int BN, int STAGES = 2, bool SPLIT = false>
struct Tf32Cfg {
  static constexpr bool kFp32 = true;           // fp32 q, k, v and o
  static constexpr bool kPrepared = true;       // prep warps split K, V
  static constexpr bool kSplit = SPLIT;         // consumers split head_dim
  static constexpr int kKPrepThreads = 96;      // warps 1-3 of warpgroup 0
  static constexpr int kVPrepThreads = 128;     // warpgroup 3
  static constexpr int HD = HD_;
  static constexpr int kBN = BN;                // keys per tile
  static constexpr int kStages = STAGES;        // K/V ring depth
  static constexpr int kBM = SPLIT ? 64 : 128;  // query rows per CTA
  static constexpr int kBoxes = HD / 32;        // 32-column boxes of a row
  static constexpr int kBoxCols = 32;           // 128 bytes of fp32
  static constexpr int kCols = SPLIT ? HD / 2 : HD;  // a consumer's columns
  static constexpr int kQSteps = kCols / 8;     // its k8 steps of Q.K^T
  static constexpr int kAcc = kCols / 2;        // accumulator floats a thread
  // a V^T row of a key box: 32 keys (128 bytes, the 128-byte swizzle), or
  // the tile's 8 keys (32 bytes, the 32-byte swizzle) with kSplit
  static constexpr int kVTRow = (BN < 32 ? BN : 32) * 4;
  static constexpr int kKeyBoxes = BN * 4 / kVTRow;  // key boxes of V^T
  static constexpr int kThreads = 512;          // loads + prep, 2 consumers
  // 2 x 128 x 24 + 2 x 128 x 232 = 65,536 registers; at 40 / 216 the hd
  // 128 consumers spilled 56 bytes. kSplit: 128 x (24 + 40) + 256 x 224,
  // the V-prep warpgroup holding a box of V in registers.
  static constexpr int kProducerRegs = 24;
  static constexpr int kVPrepRegs = SPLIT ? 40 : 24;
  static constexpr int kConsumerRegs = (65536 / 128 - kProducerRegs -
                                        kVPrepRegs) / 2;
  static constexpr int kQBox = kBM * 128;       // bytes of one Q box
  static constexpr int kKVBox = BN * 128;       // bytes of one K or V box
  static constexpr int kVTBox = HD * kVTRow;    // bytes of one V^T key box
  static constexpr int kQBytes = kBoxes * kQBox;
  static constexpr int kTileBytes = kBoxes * kKVBox;  // a plane: BN x HD
  // a stage: K_hi (K as it landed), K_lo, then V, V^T_hi, V^T_lo; with
  // kSplit V^T_hi, V^T_lo, V landing in the V^T_lo plane
  static constexpr int kVOffset = (SPLIT ? 3 : 2) * kTileBytes;
  static constexpr int kVTOffset = (SPLIT ? 2 : 3) * kTileBytes;
  static constexpr int kStageBytes = (SPLIT ? 4 : 5) * kTileBytes;
  // kSplit: the halves of s, per tile parity and warpgroup, 16 bytes a
  // thread (BN / 2 floats)
  static constexpr int kXOffset = kQBytes + kStages * kStageBytes;
  static constexpr int kXBytes = SPLIT ? 2 * 2 * 128 * (BN / 2) * 4 : 0;
  static constexpr int kBarOffset = kXOffset + kXBytes;
  // q; per stage: k/v landed, k/v prepared, k/v released
  static constexpr int kBars = 1 + 6 * kStages;
  // + 1024: the tiles start on a 1024-byte boundary (the swizzle atom)
  static constexpr int kSmem = kBarOffset + 8 * kBars + 1024;
  static_assert(HD % 32 == 0 && kCols <= 256 && BN <= 256,
                "tf32 kernel: head_dim in boxes of 32, N <= 256");
  static_assert(SPLIT ? BN == 8 && HD % 64 == 0 : BN % 32 == 0,
                "tf32 kernel: 32-key boxes of V^T, or 8-key tiles when "
                "head_dim is split");
  static_assert(kKeyBoxes * kVTBox == kTileBytes, "V^T fills one plane");
  static_assert(kSmem <= 232448, "227 KB of shared memory a block");
  static_assert(kConsumerRegs % 8 == 0 && kVPrepRegs % 8 == 0,
                "setmaxnreg takes multiples of 8");
};

// The hd-32 instance's tile (keys per tile and stages), set at build time
// only by the A/B of tiles (chip_smoke.py --tile-ab); the default is the
// A/B's fastest and kernels/attention.py's TF32_KERNEL_KEYS[32].
#ifndef TF32_HD32_KEYS
#define TF32_HD32_KEYS 64
#endif
#ifndef TF32_HD32_STAGES
#define TF32_HD32_STAGES 4
#endif

using Tf32Hd32 = Tf32Cfg<32, TF32_HD32_KEYS, TF32_HD32_STAGES>;
using Tf32Hd64 = Tf32Cfg<64, 64>;
using Tf32Hd128 = Tf32Cfg<128, 32>;
using Tf32Hd320 = Tf32Cfg<320, 8, 3, true>;

// Calls F<C>(...) for the instance C of head_dim hd.
#define TF32_DISPATCH(F, hd, ...)                   \
  if ((hd) == 32) return F<Tf32Hd32>(__VA_ARGS__);   \
  if ((hd) == 64) return F<Tf32Hd64>(__VA_ARGS__);   \
  if ((hd) == 128) return F<Tf32Hd128>(__VA_ARGS__); \
  if ((hd) == 320) return F<Tf32Hd320>(__VA_ARGS__); \
  return cudaErrorInvalidValue;

// Generic-proxy writes to shared memory made visible to the async proxy
// (wgmma's operand reads); the writer fences before it signals.
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
}

__device__ __forceinline__ float4 lds128(uint32_t a) {
  float4 v;
  asm volatile("ld.shared.v4.f32 {%0, %1, %2, %3}, [%4];"
               : "=f"(v.x), "=f"(v.y), "=f"(v.z), "=f"(v.w)
               : "r"(a)
               : "memory");
  return v;
}
__device__ __forceinline__ void sts128(uint32_t a, const uint32_t (&x)[4]) {
  asm volatile("st.shared.v4.b32 [%0], {%1, %2, %3, %4};" ::"r"(a),
               "r"(x[0]), "r"(x[1]), "r"(x[2]), "r"(x[3])
               : "memory");
}
__device__ __forceinline__ float lds32(uint32_t a) {
  float v;
  asm volatile("ld.shared.f32 %0, [%1];" : "=f"(v) : "r"(a) : "memory");
  return v;
}
__device__ __forceinline__ void sts32(uint32_t a, uint32_t x) {
  asm volatile("st.shared.b32 [%0], %1;" ::"r"(a), "r"(x) : "memory");
}

// fp32 x rounded to TF32 as cvt.rna.tf32.f32 rounds it (to nearest, ties
// away from zero), on the integer units: half of the 13 dropped bits is
// added to the magnitude's bit pattern, and they are cleared. The same
// kernel with cvt.rna was slower at the served shape.
__device__ __forceinline__ uint32_t tf32_rna(float x) {
  return (__float_as_uint(x) + 0x1000u) & 0xFFFFE000u;
}

// x -> hi = tf32(x), lo = tf32(x - hi), as the bit patterns wgmma takes.
__device__ __forceinline__ void split_tf32(float x, uint32_t& hi,
                                           uint32_t& lo) {
  hi = tf32_rna(x);
  lo = tf32_rna(x - __uint_as_float(hi));
}

// d (+)= A.B^T on TF32 operands, m64nNk8 with N = 2 * (the size of d): A
// (64 x 8) and B (N x 8) K-major in shared memory; `accumulate` 0
// overwrites d.
#define TF_SS(N, D, F, IA, IB, IP)                                          \
  __device__ __forceinline__ void tf32_ss(float(&d)[N / 2], uint64_t da,     \
                                          uint64_t db, int accumulate) {     \
    asm volatile("{\n.reg .pred p;\nsetp.ne.b32 p, %" #IP ", 0;\n"          \
                 "wgmma.mma_async.sync.aligned.m64n" #N                      \
                 "k8.f32.tf32.tf32 " D ", %" #IA ", %" #IB                   \
                 ", p, 1, 1;\n}\n"                                           \
                 : F(d)                                                      \
                 : "l"(da), "l"(db), "r"(accumulate));                      \
  }
TF_SS(8, WG_D4, WG_F4, 4, 5, 6)
TF_SS(32, WG_D16, WG_F16, 16, 17, 18)
TF_SS(64, WG_D32, WG_F32, 32, 33, 34)
TF_SS(128, WG_D64, WG_F64, 64, 65, 66)

// d (+)= A.B^T on TF32 operands, m64nNk8: A (64 x 8) from registers, the
// fragment of rows lane / 4 and lane / 4 + 8 of each warp's 16, columns
// lane % 4 and lane % 4 + 4 (a[0..3]: (r, c), (r + 8, c), (r, c + 4),
// (r + 8, c + 4)); B (N x 8) K-major in shared memory.
#define TF_RS(N, D, F, I0, I1, I2, I3, IB, IP)                              \
  __device__ __forceinline__ void tf32_rs(float(&d)[N / 2],                  \
                                          const uint32_t(&a)[4],             \
                                          uint64_t db, int accumulate) {     \
    asm volatile("{\n.reg .pred p;\nsetp.ne.b32 p, %" #IP ", 0;\n"          \
                 "wgmma.mma_async.sync.aligned.m64n" #N                      \
                 "k8.f32.tf32.tf32 " D ", {%" #I0 ", %" #I1 ", %" #I2        \
                 ", %" #I3 "}, %" #IB ", p, 1, 1;\n}\n"                      \
                 : F(d)                                                      \
                 : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db),      \
                   "r"(accumulate));                                         \
  }
TF_RS(8, WG_D4, WG_F4, 4, 5, 6, 7, 8, 9)
TF_RS(16, WG_D8, WG_F8A, 8, 9, 10, 11, 12, 13)
TF_RS(32, WG_D16, WG_F16, 16, 17, 18, 19, 20, 21)
TF_RS(64, WG_D32, WG_F32, 32, 33, 34, 35, 36, 37)
TF_RS(128, WG_D64, WG_F64, 64, 65, 66, 67, 68, 69)
TF_RS(160, WG_D80, WG_F80, 80, 81, 82, 83, 84, 85)

// This warpgroup's 64 rows and kCols columns of the landed Q tile (at
// q_rows, row stride 128 bytes within each 32-column box): Q_hi into qh,
// the A fragments of its k8 steps of Q.K^T, and Q_lo written back in
// place.
template <class C>
__device__ __forceinline__ void prep_q(uint32_t (&qh)[C::kQSteps][4],
                                       uint32_t q_rows) {
  const int lane = threadIdx.x & 31;
  const int row = 16 * ((threadIdx.x & 127) >> 5) + (lane >> 2);
#pragma unroll
  for (int kk = 0; kk < C::kQSteps; ++kk)
#pragma unroll
    for (int a = 0; a < 4; ++a) {
      const int r = row + 8 * (a & 1);
      const int col = 8 * kk + (lane & 3) + 4 * (a >> 1);
      const uint32_t addr = q_rows + (col / 32) * C::kQBox + r * 128 +
                            ((((col & 31) >> 2) ^ (r & 7)) << 4) +
                            ((col & 3) << 2);
      uint32_t lo;
      split_tf32(lds32(addr), qh[kk][a], lo);
      sts32(addr, lo);
    }
}

// A landed K tile (at k) -> K_hi in place and K_lo at k + kTileBytes, in
// the same layout. pt: this K-prep thread, 0 .. kKPrepThreads - 1.
template <class C>
__device__ __forceinline__ void prep_k(uint32_t k, int pt) {
  for (int i = pt; i < C::kTileBytes / 16; i += C::kKPrepThreads) {
    const uint32_t a = k + 16 * i;
    const float4 x = lds128(a);
    uint32_t hi[4], lo[4];
    split_tf32(x.x, hi[0], lo[0]);
    split_tf32(x.y, hi[1], lo[1]);
    split_tf32(x.z, hi[2], lo[2]);
    split_tf32(x.w, hi[3], lo[3]);
    sts128(a, hi);
    sts128(a + C::kTileBytes, lo);
  }
}

// A landed V tile (at v: BN rows of keys, head_dim in 32-column boxes) ->
// V^T_hi at vt and V^T_lo at vt + kTileBytes: row d of key box kb holds
// keys 32 kb .. 32 kb + 31, each group of 8 in the order 0, 2, 4, 6, 1, 3,
// 5, 7. V-prep warp w takes the items (key box, 4 columns) w, w + 4, ...;
// its lanes, the box's 32 keys, read one float4 each (8 distinct 16-byte
// chunks a quarter warp, through the swizzle) and write one 128-byte V^T
// row a column.
template <class C>
__device__ __forceinline__ void prep_v(uint32_t v, uint32_t vt, int w,
                                       int lane) {
  constexpr int kGroups = C::HD / 4;
  // the lane's key's column in a V^T row
  const int c = (lane & 24) | ((lane & 1) << 2) | ((lane & 7) >> 1);
  for (int item = w; item < C::kKeyBoxes * kGroups;
       item += C::kVPrepThreads / 32) {
    const int kb = item / kGroups;
    const int g = item - kb * kGroups;  // columns 4 g .. 4 g + 3
    const int key = 32 * kb + lane;
    const float4 x = lds128(v + (g / 8) * C::kKVBox + key * 128 +
                            (((g & 7) ^ (lane & 7)) << 4));
    const float xs[4] = {x.x, x.y, x.z, x.w};
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int d = 4 * g + e;
      const uint32_t a = vt + kb * C::kVTBox + d * 128 +
                         ((((c >> 2) ^ (d & 7)) << 4) | ((c & 3) << 2));
      uint32_t hi, lo;
      split_tf32(xs[e], hi, lo);
      sts32(a, hi);
      sts32(a + C::kTileBytes, lo);
    }
  }
}

// A landed 8-key V tile (at v: 8 rows of keys, head_dim in 32-column
// boxes of 1 KB under the 128-byte swizzle) -> V^T_hi at vt and V^T_lo in
// place of V: row d of V^T holds column d's 8 keys, 32 bytes under the
// 32-byte swizzle, in the order 0, 2, 4, 6, 1, 3, 5, 7. Box c of V holds
// columns 32 c .. 32 c + 31, and so do V^T's rows in the same 1 KB, so a
// box transposes alone: V-prep warp w reads boxes w, w + 4, ... whole into
// registers (two float4 a lane), then writes them back.
template <class C>
__device__ __forceinline__ void prep_v8(uint32_t v, uint32_t vt, int w,
                                        int lane) {
  for (int box = w; box < C::kBoxes; box += C::kVPrepThreads / 32) {
    const uint32_t b = box * 1024;
    float4 x[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int i = lane + 32 * h;  // 16-byte chunk of the box
      const int key = i >> 3, g = i & 7;
      x[h] = lds128(v + b + key * 128 + ((g ^ key) << 4));
    }
    __syncwarp();
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int i = lane + 32 * h;
      const int key = i >> 3, g = i & 7;
      const int c = ((key & 1) << 2) | (key >> 1);  // the key's column
      const float xs[4] = {x[h].x, x[h].y, x[h].z, x[h].w};
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int d = 4 * g + e;  // row of V^T within the box
        const uint32_t a = b + d * 32 +
                           ((((c >> 2) ^ (d >> 2)) & 1) << 4) + ((c & 3) << 2);
        uint32_t hi, lo;
        split_tf32(xs[e], hi, lo);
        sts32(vt + a, hi);
        sts32(v + a, lo);
      }
    }
  }
}

// s = Q.K^T, three TF32 products per k8 step, for this warpgroup's 64 rows
// and kCols columns (Q_hi in qh, Q_lo at q_lo) against a prepared K tile
// (K_hi at k_tile, K_lo one plane on).
template <class C>
__device__ __forceinline__ void tf32_qk(float (&sc)[C::kBN / 2],
                                        const uint32_t (&qh)[C::kQSteps][4],
                                        uint32_t q_lo, uint32_t k_tile) {
#pragma unroll
  for (int kk = 0; kk < C::kQSteps; ++kk) {
    const uint32_t step = (kk % 4) * 32;  // 8 columns in a swizzle row
    const uint32_t k = k_tile + (kk / 4) * C::kKVBox + step;
    const uint64_t k_hi = sw_desc<128>(k, 16, 1024);
    tf32_rs(sc, qh[kk], k_hi, kk > 0);
    tf32_rs(sc, qh[kk], sw_desc<128>(k + C::kTileBytes, 16, 1024), 1);
    tf32_ss(sc, sw_desc<128>(q_lo + (kk / 4) * C::kQBox + step, 16, 1024),
            k_hi, 1);
  }
}

// kSplit: the same products, two wgmmas a k8 step. Q_hi against K_hi and
// K_lo is one m64n16k8 wgmma whose B operand is the K_hi box's 8 rows and
// then the K_lo box's 8 (the stride between 8-row groups being one plane,
// kTileBytes), into s2 (columns 0-7 Q_hi.K_hi, 8-15 Q_hi.K_lo); Q_lo.K_hi
// runs into sl. s = (s2[0..3] + s2[4..7]) + sl once they are done
// (Tf32Products::combine): the sum _product_3xtf32 forms.
template <class C>
__device__ __forceinline__ void tf32_qk_paired(
    float (&s2)[8], float (&sl)[4], const uint32_t (&qh)[C::kQSteps][4],
    uint32_t q_lo, uint32_t k_tile) {
  static_assert(C::kBN == 8, "a pair of 8-key boxes is one n16 operand");
#pragma unroll
  for (int kk = 0; kk < C::kQSteps; ++kk) {
    const uint32_t step = (kk % 4) * 32;  // 8 columns in a swizzle row
    const uint32_t k = k_tile + (kk / 4) * C::kKVBox + step;
    tf32_rs(s2, qh[kk], sw_desc<128>(k, 16, C::kTileBytes), kk > 0);
    tf32_ss(sl, sw_desc<128>(q_lo + (kk / 4) * C::kQBox + step, 16, 1024),
            sw_desc<128>(k, 16, 1024), kk > 0);
  }
}

// acc += p.V, three TF32 products per k8 step of keys: p_hi, p_lo
// fragments against V^T_hi (at vt: this warpgroup's kCols rows) and V^T_lo
// (one plane on); a k8 step is 32 bytes of a V^T row of kVTRow bytes.
template <class C>
__device__ __forceinline__ void tf32_pv(float (&acc)[C::kAcc],
                                        const uint32_t (&ph)[C::kBN / 8][4],
                                        const uint32_t (&pl)[C::kBN / 8][4],
                                        uint32_t vt) {
  constexpr int kRow = C::kVTRow, kSteps = kRow / 32;
#pragma unroll
  for (int kk = 0; kk < C::kBN / 8; ++kk) {
    const uint32_t v = vt + (kk / kSteps) * C::kVTBox + (kk % kSteps) * 32;
    const uint64_t v_hi = sw_desc<kRow>(v, 16, 8 * kRow);
    tf32_rs(acc, ph[kk], v_hi, 1);
    tf32_rs(acc, ph[kk], sw_desc<kRow>(v + C::kTileBytes, 16, 8 * kRow), 1);
    tf32_rs(acc, pl[kk], v_hi, 1);
  }
}

// p (fp32, accumulator layout) -> the A fragments of the p.V k8 steps,
// p_hi and p_lo: step kk is registers 4 kk, 4 kk + 2, 4 kk + 1, 4 kk + 3
// (keys 2 t and 2 t + 1 of rows r and r + 8; V^T's key order matches).
template <int BN>
__device__ __forceinline__ void tf32_fragments(const float (&sc)[BN / 2],
                                               uint32_t (&ph)[BN / 8][4],
                                               uint32_t (&pl)[BN / 8][4]) {
#pragma unroll
  for (int kk = 0; kk < BN / 8; ++kk) {
    split_tf32(sc[4 * kk], ph[kk][0], pl[kk][0]);
    split_tf32(sc[4 * kk + 2], ph[kk][1], pl[kk][1]);
    split_tf32(sc[4 * kk + 1], ph[kk][2], pl[kk][2]);
    split_tf32(sc[4 * kk + 3], ph[kk][3], pl[kk][3]);
  }
}

// The tf32 kernel's products: Q_hi in registers (the A fragments of its k8
// steps), Q_lo at q_lo (this warpgroup's 64 rows, from its first column's
// box), K_hi and K_lo from a prepared stage (k_col: the byte offset of its
// first column's box), p split into the TF32 fragments ph, pl against
// V^T_hi and V^T_lo (kVTOffset bytes into the stage, vt_row: the offset
// of its first row). With kSplit, x is the exchange of s (kXOffset).
template <class C>
struct Tf32Products {
  uint32_t q_lo, k_col, vt_row, x;
  uint32_t qh[C::kQSteps][4];
  uint32_t ph[C::kBN / 8][4], pl[C::kBN / 8][4];
  float s2[8], sl[4];  // kSplit's accumulators of s
  __device__ __forceinline__ void qk(float (&sc)[C::kBN / 2], uint32_t st) {
    if constexpr (C::kSplit)
      tf32_qk_paired<C>(s2, sl, qh, q_lo, st + k_col);
    else
      tf32_qk<C>(sc, qh, q_lo, st + k_col);
  }
  __device__ __forceinline__ void pv(float (&acc)[C::kAcc], uint32_t st) {
    tf32_pv<C>(acc, ph, pl, st + C::kVTOffset + vt_row);
  }
  __device__ __forceinline__ void split(const float (&sc)[C::kBN / 2]) {
    tf32_fragments<C::kBN>(sc, ph, pl);
  }
  // kSplit: this warpgroup's half of s from its accumulators, then s =
  // (warpgroup 0's half) + (warpgroup 1's half), the same bits in both.
  // Slot n (the tile's parity) of each warpgroup is written again two
  // tiles on, after the barrier of the tile between, which the other
  // passes only once it has read the slot.
  __device__ __forceinline__ void combine(float (&sc)[C::kBN / 2], int n) {
    if constexpr (C::kSplit) {
      static_assert(C::kBN / 2 == 4, "one 16-byte fragment a thread");
      fence_regs(s2);
      fence_regs(sl);
#pragma unroll
      for (int e = 0; e < 4; ++e) sc[e] = (s2[e] + s2[4 + e]) + sl[e];
      const int cw = threadIdx.x / 128 - 1;
      const uint32_t t = 16 * (threadIdx.x & 127);
      const uint32_t mine[4] = {__float_as_uint(sc[0]), __float_as_uint(sc[1]),
                                __float_as_uint(sc[2]),
                                __float_as_uint(sc[3])};
      sts128(x + (2 * n + cw) * 2048 + t, mine);
      bar_sync(5);
      const float4 other = lds128(x + (2 * n + 1 - cw) * 2048 + t);
      sc[0] += other.x;
      sc[1] += other.y;
      sc[2] += other.z;
      sc[3] += other.w;
    }
  }
};

template <class C>
__global__ void __launch_bounds__(C::kThreads, 1)
    flash_attention_tf32_kernel(const __grid_constant__ CUtensorMap tq,
                                const __grid_constant__ CUtensorMap tk,
                                const __grid_constant__ CUtensorMap tv,
                                float* __restrict__ o, int seq, int heads,
                                int group, long long ob, long long os,
                                long long oh, int window, int causal,
                                float scale) {
  extern __shared__ uint8_t smem_raw[];
  const Ring<C> ring = make_ring<C>(smem_raw);
  const int b = blockIdx.x / heads;
  const int h = blockIdx.x - b * heads;
  const Tiles tiles = key_tiles<C>(seq, causal, window);
  if (threadIdx.x == 0) init_ring<C>(ring);
  __syncthreads();

  // A stage is loaded again only once both consumers released it, which
  // they do after its ready barrier: the prep warps' reads and writes of a
  // stage are done before TMA refills it.
  if (threadIdx.x < 128) {
    // ---- warpgroup 0: thread 0 loads, warps 1-3 prepare K ----
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;" ::"n"(
        C::kProducerRegs));
    if (threadIdx.x == 0) {
      load_tiles<C>(&tq, &tk, &tv, ring, tiles, h, h / group, b);
    } else if (threadIdx.x >= 32) {
      for (int i = 0; i < tiles.t_end - tiles.t_begin; ++i) {
        const int s = i % C::kStages;
        mbar_wait(ring.k_full(s), (uint32_t)(i / C::kStages) & 1u);
        if constexpr (!(kProbe & 2))
          prep_k<C>(ring.stage(s), threadIdx.x - 32);
        fence_proxy_async();
        mbar_arrive(ring.k_ready(s));
      }
    }
  } else if (threadIdx.x >= 384) {
    // ---- warpgroup 3: prepares V, beside the K-prep warps ----
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;" ::"n"(
        C::kVPrepRegs));
    for (int i = 0; i < tiles.t_end - tiles.t_begin; ++i) {
      const int s = i % C::kStages;
      const uint32_t st = ring.stage(s);
      mbar_wait(ring.v_full(s), (uint32_t)(i / C::kStages) & 1u);
      if constexpr (kProbe & 2)
        ;
      else if constexpr (C::kSplit)
        prep_v8<C>(st + C::kVOffset, st + C::kVTOffset,
                   (threadIdx.x >> 5) & 3, threadIdx.x & 31);
      else
        prep_v<C>(st + C::kVOffset, st + C::kVTOffset,
                  (threadIdx.x >> 5) & 3, threadIdx.x & 31);
      fence_proxy_async();
      mbar_arrive(ring.v_ready(s));
    }
  } else {
    // ---- consumer warpgroups: 64 query rows each (kSplit: the same 64
    // rows, HD / 2 columns each) ----
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;" ::"n"(
        C::kConsumerRegs));
    const int cw = threadIdx.x / 128 - 1;
    // Q: Q_hi to registers, Q_lo in place, once; this warpgroup's rows
    // (kSplit: columns) only, so a barrier over its own 128 threads (3 or
    // 4) orders Q_lo's writes before its wgmmas read them.
    Tf32Products<C> prod;
    const int box0 = C::kSplit ? cw * C::kCols / 32 : 0;  // first column's
    prod.q_lo = ring.q() + (C::kSplit ? box0 * C::kQBox : cw * 64 * 128);
    prod.k_col = box0 * C::kKVBox;
    prod.vt_row = C::kSplit ? cw * C::kCols * C::kVTRow : 0;
    prod.x = ring.base + C::kXOffset;
    mbar_wait(ring.q_full(), 0);
    prep_q<C>(prod.qh, prod.q_lo);
    fence_proxy_async();
    asm volatile("bar.sync %0, 128;" ::"r"(3 + cw) : "memory");
    consume<C>(prod, ring, tiles, o + b * ob + h * oh, os, seq, causal,
               window, scale);
  }
}

#undef TF_SS
#undef TF_RS
#undef WG_D4
#undef WG_D8
#undef WG_D16
#undef WG_F4
#undef WG_F8A
#undef WG_F16
#undef WG_SS
#undef WG_RS
#undef WG_D24
#undef WG_D32
#undef WG_D64
#undef WG_D80
#undef WG_D128
#undef WG_F8
#undef WG_F24
#undef WG_F32
#undef WG_F64
#undef WG_F80
#undef WG_F128

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                 void*, const cuuint64_t*, const cuuint64_t*,
                                 const cuuint32_t*, const cuuint32_t*,
                                 CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled from the driver, through the runtime.
EncodeTiled tensor_map_encoder() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault,
                                &found) == cudaSuccess &&
        found == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// The 4-D map (head_dim, head, seq, batch) of a bf16 or fp32 tensor with
// element strides sb, ss, sh (head_dim contiguous), boxes of `cols`
// columns x `rows` rows, under the swizzle of the box row's bytes (128: 64
// bf16 or 32 fp32 columns; 64: bf16 at hd 32); reads past S are zeros.
cudaError_t make_tensor_map(CUtensorMap* map, const void* ptr, bool fp32,
                            int hd, int heads, int seq, int batch,
                            long long sb, long long ss, long long sh,
                            int cols, int rows) {
  const EncodeTiled encode = tensor_map_encoder();
  if (encode == nullptr) return cudaErrorNotSupported;
  const long long size = fp32 ? 4 : 2;
  cuuint64_t dims[4] = {(cuuint64_t)hd, (cuuint64_t)heads, (cuuint64_t)seq,
                        (cuuint64_t)batch};
  cuuint64_t strides[3] = {(cuuint64_t)(size * sh), (cuuint64_t)(size * ss),
                           (cuuint64_t)(size * sb)};
  cuuint32_t box[4] = {(cuuint32_t)cols, 1, (cuuint32_t)rows, 1};
  if (cols * size != 128 && cols * size != 64) return cudaErrorInvalidValue;
  cuuint32_t elem[4] = {1, 1, 1, 1};
  const CUresult r = encode(
      map,
      fp32 ? CU_TENSOR_MAP_DATA_TYPE_FLOAT32 : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16,
      4, const_cast<void*>(ptr), dims, strides, box, elem,
      CU_TENSOR_MAP_INTERLEAVE_NONE,
      cols * size == 128 ? CU_TENSOR_MAP_SWIZZLE_128B
                         : CU_TENSOR_MAP_SWIZZLE_64B,
      CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
      CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

// The tensor-core kernel of instance C: flash_attention_tf32_kernel for a
// Tf32Cfg, flash_attention_wgmma_kernel for a WgCfg.
template <class C>
auto tensor_core_kernel() {
  if constexpr (C::kFp32)
    return flash_attention_tf32_kernel<C>;
  else
    return flash_attention_wgmma_kernel<C>;
}

template <class C>
cudaError_t launch_wgmma(const void* q, const void* k, const void* v, void* o,
                         int batch, int seq, int heads, int kv_heads,
                         const Strides& st, int window, int causal,
                         float scale, cudaStream_t stream) {
  using T = std::conditional_t<C::kFp32, float, __nv_bfloat16>;
  if ((seq + C::kBM - 1) / C::kBM > 65535) return cudaErrorInvalidValue;
  CUtensorMap tq, tk, tv;
  cudaError_t err =
      make_tensor_map(&tq, q, C::kFp32, C::HD, heads, seq, batch, st.qb,
                      st.qs, st.qh, C::kBoxCols, C::kBM);
  if (err == cudaSuccess)
    err = make_tensor_map(&tk, k, C::kFp32, C::HD, kv_heads, seq, batch,
                          st.kb, st.ks, st.kh, C::kBoxCols, C::kBN);
  if (err == cudaSuccess)
    err = make_tensor_map(&tv, v, C::kFp32, C::HD, kv_heads, seq, batch,
                          st.vb, st.vs, st.vh, C::kBoxCols, C::kBN);
  if (err != cudaSuccess) return err;
  auto kernel = tensor_core_kernel<C>();
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             C::kSmem);
  if (err != cudaSuccess) return err;
  const dim3 grid((unsigned)(batch * heads),
                  (unsigned)((seq + C::kBM - 1) / C::kBM));
  kernel<<<grid, C::kThreads, C::kSmem, stream>>>(
      tq, tk, tv, static_cast<T*>(o), seq, heads, heads / kv_heads, st.ob,
      st.os, st.oh, window, causal, scale);
  return cudaGetLastError();
}

template <class C>
cudaError_t occupancy_wgmma(int* threads, int* smem, int* regs, int* ctas) {
  auto kernel = tensor_core_kernel<C>();
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, C::kSmem);
  if (err != cudaSuccess) return err;
  cudaFuncAttributes attr;
  err = cudaFuncGetAttributes(&attr, kernel);
  if (err != cudaSuccess) return err;
  *threads = C::kThreads;
  *smem = C::kSmem;
  *regs = attr.numRegs;
  return cudaOccupancyMaxActiveBlocksPerMultiprocessor(ctas, kernel,
                                                       C::kThreads, C::kSmem);
}

}  // namespace

extern "C" {

const char* attention_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

// q: (batch, seq, heads, head_dim) and k, v, o: (batch, seq, kv_heads or
// heads, head_dim) addressed through the element strides given, head_dim
// contiguous; bf16 != 0 for bfloat16 tensors, else float32.
int flash_attention(const void* q, const void* k, const void* v, void* o,
                    int batch, int seq, int heads, int kv_heads, int head_dim,
                    long long qb, long long qs, long long qh, long long kb,
                    long long ks, long long kh, long long vb, long long vs,
                    long long vh, long long ob, long long os, long long oh,
                    int window, int causal, float scale, int bf16,
                    void* stream) {
  if (batch < 0 || seq < 0 || heads < 1 || kv_heads < 1 ||
      heads % kv_heads != 0 || window < 1 ||
      (long long)batch * heads > 0x7fffffffLL ||
      (seq + kBQ - 1) / kBQ > 65535)
    return cudaErrorInvalidValue;
  if (batch == 0 || seq == 0) return cudaSuccess;
  const Strides st{qb, qs, qh, kb, ks, kh, vb, vs, vh, ob, os, oh};
  const int group = heads / kv_heads;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  ATTENTION_DISPATCH(launch_typed, head_dim, bf16, q, k, v, o, batch, seq,
                     heads, group, st, window, causal, scale, s)
}

// The tensor-core kernel: bf16 q, k, v and o (bf16 must be 1) at head_dim
// 32, 64, 128 or 320, the arguments as for flash_attention. Every stride must
// be a multiple of 8 elements (16 bytes) and every base 16-byte aligned, as
// TMA needs; a tensor map the driver refuses returns cudaErrorInvalidValue.
int flash_attention_wgmma(const void* q, const void* k, const void* v,
                          void* o, int batch, int seq, int heads,
                          int kv_heads, int head_dim, long long qb,
                          long long qs, long long qh, long long kb,
                          long long ks, long long kh, long long vb,
                          long long vs, long long vh, long long ob,
                          long long os, long long oh, int window, int causal,
                          float scale, int bf16, void* stream) {
  if (batch < 0 || seq < 0 || heads < 1 || kv_heads < 1 ||
      heads % kv_heads != 0 || window < 1 || bf16 != 1 ||
      (long long)batch * heads > 0x7fffffffLL)
    return cudaErrorInvalidValue;
  if (batch == 0 || seq == 0) return cudaSuccess;
  const Strides st{qb, qs, qh, kb, ks, kh, vb, vs, vh, ob, os, oh};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  WGMMA_DISPATCH(launch_wgmma, head_dim, q, k, v, o, batch, seq, heads,
                 kv_heads, st, window, causal, scale, s)
}

// The 3xTF32 tensor-core kernel: fp32 q, k, v and o (bf16 must be 0) at
// head_dim 32, 64, 128 or 320, the arguments as for flash_attention. Every
// stride must be a multiple of 4 elements (16 bytes) and every base 16-byte
// aligned, as TMA needs; a tensor map that cuTensorMapEncodeTiled refuses
// returns cudaErrorInvalidValue.
int flash_attention_tf32(const void* q, const void* k, const void* v, void* o,
                         int batch, int seq, int heads, int kv_heads,
                         int head_dim, long long qb, long long qs,
                         long long qh, long long kb, long long ks,
                         long long kh, long long vb, long long vs,
                         long long vh, long long ob, long long os,
                         long long oh, int window, int causal, float scale,
                         int bf16, void* stream) {
  if (batch < 0 || seq < 0 || heads < 1 || kv_heads < 1 ||
      heads % kv_heads != 0 || window < 1 || bf16 != 0 ||
      (long long)batch * heads > 0x7fffffffLL)
    return cudaErrorInvalidValue;
  if (batch == 0 || seq == 0) return cudaSuccess;
  const Strides st{qb, qs, qh, kb, ks, kh, vb, vs, vh, ob, os, oh};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  TF32_DISPATCH(launch_wgmma, head_dim, q, k, v, o, batch, seq, heads,
                kv_heads, st, window, causal, scale, s)
}

// Launch configuration of kernel 0 (flash_attention_kernel, any head_dim,
// bf16 or fp32), 1 (flash_attention_wgmma_kernel, head_dim 32, 64, 128 or
// 320, bf16 == 1) or 2 (flash_attention_tf32_kernel, head_dim 32, 64, 128
// or 320, bf16 == 0): threads per CTA, dynamic shared memory in bytes,
// registers per thread, CTAs per SM.
int attention_occupancy(int kernel, int head_dim, int bf16, int unused,
                        int* threads, int* smem, int* regs, int* ctas) {
  (void)unused;
  if (kernel == 1) {
    if (bf16 != 1) return cudaErrorInvalidValue;
    WGMMA_DISPATCH(occupancy_wgmma, head_dim, threads, smem, regs, ctas)
  }
  if (kernel == 2) {
    if (bf16 != 0) return cudaErrorInvalidValue;
    TF32_DISPATCH(occupancy_wgmma, head_dim, threads, smem, regs, ctas)
  }
  if (kernel != 0) return cudaErrorInvalidValue;
  ATTENTION_DISPATCH(occupancy_typed, head_dim, bf16, threads, smem, regs,
                     ctas)
}

}  // extern "C"
