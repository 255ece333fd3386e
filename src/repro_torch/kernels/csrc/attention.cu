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
// call; wgmma, TMA and warp specialisation are later work.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstddef>
#include <cstdint>

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

// Launch configuration of the kernel for (head_dim, bf16): threads per CTA,
// dynamic shared memory in bytes, registers per thread, CTAs per SM.
int attention_occupancy(int kernel, int head_dim, int bf16, int unused,
                        int* threads, int* smem, int* regs, int* ctas) {
  (void)unused;
  if (kernel != 0) return cudaErrorInvalidValue;
  ATTENTION_DISPATCH(occupancy_typed, head_dim, bf16, threads, smem, regs,
                     ctas)
}

}  // extern "C"
