// Hand-written Hopper (sm_90a) kernels for the exact tier: the batched
// cyclic NTT and the fused modular polynomial products, single-limb and RNS.
// One radix-2 Montgomery Stockham routine serves all three.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3
//        -shared -Xcompiler -fPIC  (repro_torch/kernels/_build.py)
// The C entry points at the end take device pointers and a stream, launch on
// that stream, and return cudaGetLastError() after the launch.
//
// Data layout: rows of n residues mod q (uint32 words; the wrappers hold
// them in int32 tensors, q < 2^31), row stride n, n a power of two. RNS
// stacks are (k, B, n): limb-major. The Stockham autosort state of a row is
// A(L, r) with L * r = n, element (l, j) at l * r + j, and column j of A is
// the length-L NTT of x[j :: r], as in stockham.cu. No bit-reversal pass.
//
// Arithmetic: q is an odd prime < 2^31, so a + b < 2^32 and 2q < 2^32.
// Twiddles are in Montgomery form (w^k * 2^32 mod q), so a butterfly
// multiply is one REDC with the 32x32->64-bit product of the hardware
// (the TPU kernel builds that product from 16-bit limbs, which CUDA does not
// need). Every value leaves a function as a canonical residue in [0, q), so
// the kernels agree bit for bit with their plain int64 versions
// (repro_torch/kernels/ntt.py) and with the numpy reference.
//
// Where the rows live: as in stockham.cu. A CTA holds its rows in two
// ping-pong buffers: 8n bytes per transformed row, 16n per product (both
// operands' spectra side by side). While that fits the 227 KB a CTA may opt
// into, the rows stay in dynamic shared memory for every sweep: up to
// n = 16384 for the NTT and n = 8192 for the products. Longer rows (the
// service takes up to n = 2^19 and beyond) run the very same loop on a
// device-memory ping-pong scratch that the wrapper allocates, one slice per
// CTA; __syncthreads() orders those global accesses within the CTA, and the
// scratch is read through plain (coherent) loads. The wrapper
// (repro_torch/kernels/ntt.py: ntt_cta_rows) decides which path runs and
// passes scratch == nullptr for the shared-memory one.
//
// Bound on this card: 32-bit integer operations. A butterfly is one
// Montgomery REDC (the two halves of the 64-bit product, the multiply for m,
// one high-half multiply, the carry and the final subtract) plus a modular
// add and subtract: about 15 integer operations, while each residue crosses
// device memory only on load and store. A product at n = 65536 does
// 3 * 16 * n/2 butterflies per row against 12 bytes of device memory per
// point, about 30 operations per byte; the card does about 5 32-bit integer
// operations per byte it moves (64 results per SM per clock, against
// 3.35 TB/s), so the integer units, not the bytes, set the least time.
#include <cuda_runtime.h>

#include <cstddef>
#include <cstdint>

namespace {

constexpr int kMaxThreads = 1024;
constexpr size_t kStaticSmemBytes = 48 * 1024;

// A modulus and its Montgomery multiplier qinv = -q^-1 mod 2^32.
struct Mod {
  uint32_t q;
  uint32_t qinv;
};

// a * b * 2^-32 mod q for a, b < q. t = (a b + m q) / 2^32 with m chosen so
// the low word cancels: hi(a b) + hi(m q) + carry, where the carry of
// lo(a b) + lo(m q) == 0 mod 2^32 is 1 exactly when lo(a b) != 0. t < 2q.
__device__ __forceinline__ uint32_t mont_mul(uint32_t a, uint32_t b, Mod m) {
  const uint64_t ab = (uint64_t)a * b;
  const uint32_t lo = (uint32_t)ab;
  const uint32_t k = lo * m.qinv;
  const uint32_t t =
      (uint32_t)(ab >> 32) + __umulhi(k, m.q) + (lo != 0u ? 1u : 0u);
  return t >= m.q ? t - m.q : t;
}

__device__ __forceinline__ uint32_t add_mod(uint32_t a, uint32_t b,
                                            uint32_t q) {
  const uint32_t s = a + b;
  return s >= q ? s - q : s;
}

__device__ __forceinline__ uint32_t sub_mod(uint32_t a, uint32_t b,
                                            uint32_t q) {
  return a >= b ? a - b : a + q - b;
}

// One radix-2 sweep over `rows` rows: A(L, r) -> A(2L, r/2), lr = log2 r.
// Twiddle of column block l: w[l * n / 2L] = w[l * r/2]. One thread per
// butterfly.
__device__ void ntt_stage(const uint32_t* src, uint32_t* dst, int rows,
                          int log2n, int L, int lr,
                          const uint32_t* __restrict__ w, Mod m) {
  const int lh = lr - 1;
  const int half = 1 << lh;
  const int per_row = 1 << (log2n - 1);
  const int total = rows * per_row;
  for (int idx = threadIdx.x; idx < total; idx += blockDim.x) {
    const size_t base = (size_t)(idx >> (log2n - 1)) << log2n;
    const int j = idx & (per_row - 1);
    const int l = j >> lh;
    const int col = j & (half - 1);
    const int ie = (l << lr) + col;
    const uint32_t e = src[base + ie];
    const uint32_t t = mont_mul(src[base + ie + half], w[l * half], m);
    const int oe = (l << lh) + col;
    dst[base + oe] = add_mod(e, t, m.q);
    dst[base + oe + (L << lh)] = sub_mod(e, t, m.q);
  }
}

// Every sweep of an n-point cyclic NTT over `rows` rows, starting in `a` and
// ping-ponging with `b`. The caller has synchronised after filling `a`. On
// return `a` holds the result and `b` the other buffer. `w` is the master
// table of the forward root, or of its inverse for an inverse transform;
// the n^-1 scale is the caller's.
__device__ void ntt_sweeps(uint32_t*& a, uint32_t*& b, int rows, int log2n,
                           const uint32_t* __restrict__ w, Mod m) {
  int L = 1;
  for (int lr = log2n; lr > 0; --lr) {
    ntt_stage(a, b, rows, log2n, L, lr, w, m);
    __syncthreads();
    uint32_t* const t = a;
    a = b;
    b = t;
    L <<= 1;
  }
}

// The CTA's two ping-pong buffers of `slots` rows each: in dynamic shared
// memory, or in this CTA's slice of the device-memory scratch (CTAs are
// numbered over the whole (batch block, limb) grid).
__device__ __forceinline__ void cta_buffers(uint32_t* smem, uint32_t* scratch,
                                            int slots, int log2n, uint32_t*& a,
                                            uint32_t*& b) {
  const size_t plane = (size_t)slots << log2n;
  const size_t cta = (size_t)blockIdx.y * gridDim.x + blockIdx.x;
  uint32_t* mem = scratch ? scratch + cta * 2 * plane : smem;
  a = mem;
  b = mem + plane;
}

// The fused product of `rows` operand pairs (pointers at the CTA's first
// row): load and reduce mod q, psi twist (negacyclic), both forward NTTs in
// one batched pass over 2*rows rows, the pointwise product with one operand
// hopped into the Montgomery domain by r2, the inverse NTT, and the untwist
// by psi^-j n^-1 (n^-1 alone for the cyclic product) on the way out.
__device__ void polymul_rows(const uint32_t* __restrict__ a_in,
                             const uint32_t* __restrict__ b_in,
                             uint32_t* __restrict__ c,
                             const uint32_t* __restrict__ wf,
                             const uint32_t* __restrict__ wi,
                             const uint32_t* __restrict__ twist,
                             const uint32_t* __restrict__ untwist,
                             uint32_t* a, uint32_t* b, int rows, int log2n,
                             Mod m, uint32_t r2, bool negacyclic) {
  const int mask = (1 << log2n) - 1;
  const int count = rows << log2n;
  for (int k = threadIdx.x; k < count; k += blockDim.x) {
    uint32_t va = a_in[k] % m.q;
    uint32_t vb = b_in[k] % m.q;
    if (negacyclic) {
      const uint32_t t = twist[k & mask];
      va = mont_mul(va, t, m);
      vb = mont_mul(vb, t, m);
    }
    a[k] = va;
    a[count + k] = vb;
  }
  __syncthreads();
  ntt_sweeps(a, b, 2 * rows, log2n, wf, m);
  for (int k = threadIdx.x; k < count; k += blockDim.x) {
    a[k] = mont_mul(mont_mul(a[k], r2, m), a[count + k], m);
  }
  __syncthreads();
  ntt_sweeps(a, b, rows, log2n, wi, m);
  for (int k = threadIdx.x; k < count; k += blockDim.x) {
    c[k] = mont_mul(a[k], untwist[k & mask], m);
  }
}

// Kernel 7 -- replaces repro/kernels/ntt.py::_ntt_kernel (ntt_batched).
// Batched cyclic NTT, or inverse NTT scaled by n^-1 (`scale` is n^-1 in
// Montgomery form, folded into the write-out as one REDC). Bound: integer
// operations once the row stays on chip (log2 n butterflies per point
// against 8 bytes of device memory per point). Design: every sweep stays in
// shared memory while the row fits (n <= 16384); input reduced mod q on load.
__global__ void __launch_bounds__(kMaxThreads)
ntt_kernel(const uint32_t* __restrict__ x, uint32_t* __restrict__ y,
           const uint32_t* __restrict__ w, uint32_t* scratch, int batch,
           int log2n, uint32_t q, uint32_t qinv, uint32_t scale, int inverse,
           int block) {
  extern __shared__ __align__(16) uint32_t smem[];
  uint32_t *a, *b;
  cta_buffers(smem, scratch, block, log2n, a, b);
  const Mod m{q, qinv};
  const int row0 = blockIdx.x * block;
  const int rows = min(block, batch - row0);
  const size_t off = (size_t)row0 << log2n;
  const int count = rows << log2n;
  for (int k = threadIdx.x; k < count; k += blockDim.x) {
    a[k] = x[off + k] % q;
  }
  __syncthreads();
  ntt_sweeps(a, b, rows, log2n, w, m);
  for (int k = threadIdx.x; k < count; k += blockDim.x) {
    y[off + k] = inverse ? mont_mul(a[k], scale, m) : a[k];
  }
}

// Kernel 6 -- replaces repro/kernels/ntt.py::_ntt_polymul_kernel
// (ntt_polymul). Exact product mod (x^n + 1, q), or x^n - 1: twist, two
// NTTs, pointwise product, inverse NTT and untwist in one residency. Bound:
// integer operations (three transforms' butterflies against 12 bytes of
// device memory per point). Design: the spectra never leave the CTA while a
// product row fits shared memory (n <= 8192); the twist and the untwist ride
// the load and the write-out, so they cost no pass of their own.
__global__ void __launch_bounds__(kMaxThreads)
ntt_polymul_kernel(const uint32_t* __restrict__ a_in,
                   const uint32_t* __restrict__ b_in,
                   uint32_t* __restrict__ c, const uint32_t* __restrict__ wf,
                   const uint32_t* __restrict__ wi,
                   const uint32_t* __restrict__ twist,
                   const uint32_t* __restrict__ untwist, uint32_t* scratch,
                   int batch, int log2n, uint32_t q, uint32_t qinv,
                   uint32_t r2, int negacyclic, int block) {
  extern __shared__ __align__(16) uint32_t smem[];
  uint32_t *a, *b;
  cta_buffers(smem, scratch, 2 * block, log2n, a, b);
  const int row0 = blockIdx.x * block;
  const int rows = min(block, batch - row0);
  const size_t off = (size_t)row0 << log2n;
  polymul_rows(a_in + off, b_in + off, c + off, wf, wi, twist, untwist, a, b,
               rows, log2n, Mod{q, qinv}, r2, negacyclic != 0);
}

// Kernel 8 -- replaces repro/kernels/ntt.py::_rns_ntt_polymul_kernel
// (rns_ntt_polymul). Kernel 6 for k RNS limbs in one launch: blockIdx.y is
// the limb, blockIdx.x the batch block. Each limb's q, qinv and r2 come from
// row `limb` of the (k, 4) table `scal`, its four tables from row `limb` of
// the (k, n) tables. Bound and design: as kernel 6.
__global__ void __launch_bounds__(kMaxThreads)
rns_ntt_polymul_kernel(const uint32_t* __restrict__ a_in,
                       const uint32_t* __restrict__ b_in,
                       uint32_t* __restrict__ c,
                       const uint32_t* __restrict__ scal,
                       const uint32_t* __restrict__ wf,
                       const uint32_t* __restrict__ wi,
                       const uint32_t* __restrict__ twist,
                       const uint32_t* __restrict__ untwist,
                       uint32_t* scratch, int batch, int log2n,
                       int negacyclic, int block) {
  extern __shared__ __align__(16) uint32_t smem[];
  uint32_t *a, *b;
  cta_buffers(smem, scratch, 2 * block, log2n, a, b);
  const int limb = blockIdx.y;
  const Mod m{scal[4 * limb], scal[4 * limb + 1]};
  const uint32_t r2 = scal[4 * limb + 2];
  const size_t table = (size_t)limb << log2n;
  const int row0 = blockIdx.x * block;
  const int rows = min(block, batch - row0);
  const size_t off = ((size_t)limb * batch + row0) << log2n;
  polymul_rows(a_in + off, b_in + off, c + off, wf + table, wi + table,
               twist + table, untwist + table, a, b, rows, log2n, m, r2,
               negacyclic != 0);
}

// Threads for a CTA that transforms `slots` rows: one per butterfly of a
// sweep, at least a warp, at most 1024.
int threads_for(int slots, int log2n) {
  const long work = ((long)slots << log2n) >> 1;
  return work < 32 ? 32 : (work > kMaxThreads ? kMaxThreads : (int)work);
}

bool bad_args(int batch, int log2n, int block) {
  return batch < 0 || log2n < 0 || log2n > 28 || block < 1;
}

// Dynamic shared memory for `slots` rows in two buffers, 0 for the
// device-memory scratch path. Opts the kernel in above 48 KB.
template <typename Kernel>
cudaError_t smem_for(Kernel kernel, bool staged, int slots, int log2n,
                     size_t* bytes) {
  *bytes = staged ? 0 : 2 * ((size_t)slots << log2n) * sizeof(uint32_t);
  if (*bytes > kStaticSmemBytes) {
    return cudaFuncSetAttribute(kernel,
                                cudaFuncAttributeMaxDynamicSharedMemorySize,
                                (int)*bytes);
  }
  return cudaSuccess;
}

// The launch configuration a launcher below gives `kernel` for `slots` rows
// (threads per CTA, dynamic shared memory), the registers per thread the
// compiler gave it, and how many such CTAs one SM holds at once.
template <typename Kernel>
cudaError_t occupancy_of(Kernel kernel, int slots, int log2n, bool staged,
                         int* threads, int* smem, int* regs, int* ctas) {
  size_t bytes;
  cudaError_t err = smem_for(kernel, staged, slots, log2n, &bytes);
  if (err != cudaSuccess) return err;
  *threads = threads_for(slots, log2n);
  *smem = (int)bytes;
  cudaFuncAttributes attr;
  err = cudaFuncGetAttributes(&attr, kernel);
  if (err != cudaSuccess) return err;
  *regs = attr.numRegs;
  return cudaOccupancyMaxActiveBlocksPerMultiprocessor(ctas, kernel, *threads,
                                                       bytes);
}

}  // namespace

extern "C" {

const char* ntt_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

int ntt_batched(const uint32_t* x, uint32_t* y, const uint32_t* w,
                uint32_t* scratch, int batch, int log2n, uint32_t q,
                uint32_t qinv, uint32_t scale, int inverse, int block,
                void* stream) {
  if (bad_args(batch, log2n, block)) return cudaErrorInvalidValue;
  if (batch == 0) return cudaSuccess;
  size_t smem;
  cudaError_t err =
      smem_for(ntt_kernel, scratch != nullptr, block, log2n, &smem);
  if (err != cudaSuccess) return err;
  const int grid = (batch + block - 1) / block;
  ntt_kernel<<<grid, threads_for(block, log2n), smem,
               (cudaStream_t)stream>>>(x, y, w, scratch, batch, log2n, q,
                                       qinv, scale, inverse, block);
  return cudaGetLastError();
}

int ntt_polymul(const uint32_t* a, const uint32_t* b, uint32_t* c,
                const uint32_t* wf, const uint32_t* wi,
                const uint32_t* twist, const uint32_t* untwist,
                uint32_t* scratch, int batch, int log2n, uint32_t q,
                uint32_t qinv, uint32_t r2, int negacyclic, int block,
                void* stream) {
  if (bad_args(batch, log2n, block)) return cudaErrorInvalidValue;
  if (batch == 0) return cudaSuccess;
  size_t smem;
  cudaError_t err = smem_for(ntt_polymul_kernel, scratch != nullptr,
                             2 * block, log2n, &smem);
  if (err != cudaSuccess) return err;
  const int grid = (batch + block - 1) / block;
  ntt_polymul_kernel<<<grid, threads_for(2 * block, log2n), smem,
                       (cudaStream_t)stream>>>(
      a, b, c, wf, wi, twist, untwist, scratch, batch, log2n, q, qinv, r2,
      negacyclic, block);
  return cudaGetLastError();
}

int ntt_rns_polymul(const uint32_t* a, const uint32_t* b, uint32_t* c,
                    const uint32_t* scal, const uint32_t* wf,
                    const uint32_t* wi, const uint32_t* twist,
                    const uint32_t* untwist, uint32_t* scratch, int limbs,
                    int batch, int log2n, int negacyclic, int block,
                    void* stream) {
  if (bad_args(batch, log2n, block) || limbs < 1 || limbs > 65535) {
    return cudaErrorInvalidValue;
  }
  if (batch == 0) return cudaSuccess;
  size_t smem;
  cudaError_t err = smem_for(rns_ntt_polymul_kernel, scratch != nullptr,
                             2 * block, log2n, &smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((batch + block - 1) / block, limbs);
  rns_ntt_polymul_kernel<<<grid, threads_for(2 * block, log2n), smem,
                           (cudaStream_t)stream>>>(
      a, b, c, scal, wf, wi, twist, untwist, scratch, batch, log2n,
      negacyclic, block);
  return cudaGetLastError();
}

// Occupancy of a launch as the launchers above make it: `kernel` is 0 NTT,
// 1 single-limb product, 2 RNS product; `block` the rows per CTA the
// wrapper passes; `staged` whether the rows go through device memory.
int ntt_occupancy(int kernel, int log2n, int block, int staged, int* threads,
                  int* smem, int* regs, int* ctas) {
  if (bad_args(1, log2n, block)) return cudaErrorInvalidValue;
  const bool st = staged != 0;
  switch (kernel) {
    case 0:
      return occupancy_of(ntt_kernel, block, log2n, st, threads, smem, regs,
                          ctas);
    case 1:
      return occupancy_of(ntt_polymul_kernel, 2 * block, log2n, st, threads,
                          smem, regs, ctas);
    case 2:
      return occupancy_of(rns_ntt_polymul_kernel, 2 * block, log2n, st,
                          threads, smem, regs, ctas);
  }
  return cudaErrorInvalidValue;
}

}  // extern "C"
