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
// Where the rows live: as in stockham.cu. The single-CTA kernels hold their
// rows in two ping-pong buffers: 8n bytes per transformed row, 16n per
// product (both operands' spectra side by side). While that fits the 227 KB
// a CTA may opt into, the rows stay in dynamic shared memory for every
// sweep: up to n = 16384 for the NTT and n = 8192 for the products. Longer
// rows run the very same loop on a device-memory ping-pong scratch that the
// wrapper allocates, one slice per CTA; __syncthreads() orders those global
// accesses within the CTA, and the scratch is read through plain (coherent)
// loads. The wrapper (repro_torch/kernels/ntt.py: ntt_cta_rows) decides
// which path runs and passes scratch == nullptr for the shared-memory one.
// From TWO_PASS_FROM (repro_torch/kernels/fft.py) points on, as far as n
// splits into parts of at most 8192 points, every kernel takes a split-pass
// schedule instead, whose CTAs hold whole sub-problems of a split n = n1 n2
// (the split-pass section below): the NTT two launches, the single-limb and
// the RNS product three (the RNS product with the limb as grid row y). Below
// its split, from REGISTER_STEPS_FROM points on, the RNS product runs its
// register-step schedule: one CTA per (row, limb), the sweeps in registers.
// The staged path then runs only rows past every split (n > 2^25) and
// whatever schedule a caller asks for by name.
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
// against 8 bytes of device memory per point). Design: below
// TWO_PASS_FROM["ntt_batched"] points every sweep stays in shared memory
// (one CTA per row block, input reduced mod q on load); from there on the
// wrapper launches the two-pass schedule instead (ntt_pass1_kernel and
// ntt_pass2_kernel, below), whose CTAs hold whole sub-problems of the split.
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
// the load and the write-out, so they cost no pass of their own. From
// TWO_PASS_FROM["ntt_polymul"] points on the wrapper launches the
// split-pass schedule instead (ntt_polymul_pass1_kernel,
// ntt_polymul_mid_kernel, ntt_polymul_pass2_kernel, below).
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
// the (k, n) tables. Bound: as kernel 6. This single-CTA design (24 radix-2
// sweeps, each a shared-memory round trip and a barrier) runs only where the
// wrapper plans neither of the other two: from
// REGISTER_STEPS_FROM["rns_ntt_polymul"] points the register-step kernel
// (rns_ntt_polymul_steps_kernel), from TWO_PASS_FROM["rns_ntt_polymul"] the
// split-pass launches of kernel 6 with the limb as grid row y.
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

// ---------------------------------------------------------------------------
// Kernel 6, split-pass schedule (ntt_polymul from TWO_PASS_FROM
// ["ntt_polymul"] points on, repro_torch/kernels/ntt.py:
// ntt_two_pass_plan).
//
// The radix-2 Stockham state A(L, r) splits at L = n1 (n = n1 * n2)
// without changing one operation, as stockham.cu's two-pass schedule
// splits the float sweeps: the sweeps from L = 1 to n1 keep the column
// index modulo n2, so sub-problem q0 is the n1-point transform of
// x[q0 + k n2], ending as A[l n2 + q0]; the sweeps from n1 to n keep the
// block index modulo n1, so sub-problem l0 is the slice A[l0 n2 ..
// (l0 + 1) n2), ending as the bins l0 + k n1, with the twiddles of the
// global block l0 + n1 l (gathered into a pass-2 table in reading order).
// The product takes three launches (the RNS product the same three, with
// blockIdx.y the limb: its q, qinv and r2 from row `limb` of the (k, 4)
// table, its tables and pass-2 tables from row `limb` of (k, n) stacks):
//   F1 (ntt_polymul_pass1_kernel): c consecutive q0 of a row, of a and of
//      b: load, reduce mod q, psi twist, forward sweeps L = 1 .. n1, store
//      A_a and A_b.
//   M  (ntt_polymul_mid_kernel): c consecutive l0 of a row, of a and of b:
//      forward sweeps L = n1 .. n, the r2-hop product of the bins
//      l0 + k n1 (in the place of a's), then the inverse's pass 1 under
//      the mirrored split (n2, n1), whose sub-problem q0' = l0 reads
//      exactly P[l0 + k n1], the elements the CTA holds: inverse sweeps
//      L = 1 .. n2, store A'[l n1 + l0].
//   I2 (ntt_polymul_pass2_kernel): c consecutive l0' < n2 of a row, the
//      slices A'[l0' n1 ..): inverse sweeps L = n2 .. n, store
//      c[l0' + k n2] times the untwist psi^-j n^-1.
// Radix 2 puts every split on the sweep sequence, so the mirrored split
// always is, and there are always three launches. The NTT alone takes two:
// pass 1 (ntt_pass1_kernel) is F1's reader on one operand without the
// twist, pass 2 (ntt_pass2_kernel) the forward pass 2 with the bins
// l0 + k n1 stored in natural order (times n^-1 for the inverse). Residues
// are exact, so the result equals the single-CTA kernel's, the plain
// versions' and the numpy reference's (==).
//
// Sweeps in registers: a step runs T <= 4 radix-2 sweeps on groups of 2^T
// elements a thread holds -- at local A(L, r), group (l, q), q < r / 2^T,
// holds (l, q + i r / 2^T); after sweep t it holds blocks l + b L (b < 2^t)
// of A(2^t L, r / 2^t), so the group's butterflies of all T sweeps are its
// own and it ends as blocks l + b L of column q of A(2^T L, r / 2^T). Each
// thread holds 16 residues (16 / 2^T groups), so a 256-point sub-problem
// takes two steps and touches shared memory once, where ntt_sweeps crosses
// shared (or device) memory and a barrier for every sweep. Shared rows are
// slot-major at stride m + 1 words (no bank conflicts between neighbouring
// slots). The RNS product's register-step kernel runs the same steps on
// whole rows (one sub-problem of n points per operand), in rows with a pad
// word after every 16 (NttRowSmem), where a step's strided columns would
// otherwise fall on two banks.
//
// Bound: 32-bit integer operations, as kernel 6 (the butterflies do not
// change); device memory sees 36 bytes a point a row (F1 8 in, 8 out; M 8
// in, 4 out; I2 4 in, 4 out; the NTT's two passes 8 each), and every
// launch spreads a row over
// n2 / c, n1 / c and n2 / c CTAs, where ntt_polymul_kernel ran one CTA of
// 1024 threads per row through a device-memory ping-pong for all 48 sweeps
// from n = 16384 on.
// ---------------------------------------------------------------------------

constexpr int kPassThreads = 256;
constexpr size_t kMaxSmemBytes = 232448;

// `slots` sub-problems in shared memory: element i of slot s at s ld + i.
struct NttSmem {
  uint32_t* p;
  int ld;
  __device__ __forceinline__ uint32_t load(int s, int i) const {
    return p[s * ld + i];
  }
  __device__ __forceinline__ void store(int s, int i, uint32_t v) const {
    p[s * ld + i] = v;
  }
};

// Whole rows in shared memory: element i of row s at s ld + i + i / 16,
// one pad word after every 16, so that the 32 threads of a warp reading
// column i of 32 consecutive groups (stride 16 or 16 r) hit 32 banks.
struct NttRowSmem {
  uint32_t* p;
  int ld;
  __device__ __forceinline__ uint32_t load(int s, int i) const {
    return p[s * ld + i + (i >> 4)];
  }
  __device__ __forceinline__ void store(int s, int i, uint32_t v) const {
    p[s * ld + i + (i >> 4)] = v;
  }
};

// Consecutive sub-problems: slot s holds base + s.
struct NttRun {
  int base;
  __device__ __forceinline__ int l0(int s) const { return base + s; }
};

// The same sub-problems of both operands: slots [0, 2^lc) a's, the rest
// b's, slot s holding base + (s mod 2^lc).
struct NttPair {
  int base;
  int lc;
  __device__ __forceinline__ int l0(int s) const {
    return base + (s & ((1 << lc) - 1));
  }
};

// Twiddle of local block l in a sweep at local A(L, r), half = r / 2.
// Pass 1 (the whole transform's L and block index): w[l half stride] of
// the master table, stride n / m for m-point sub-problems; the same for
// every slot.
struct NttTw1 {
  const uint32_t* __restrict__ w;
  int stride;
  __device__ __forceinline__ uint32_t operator()(int, int l, int,
                                                 int half) const {
    return w[l * half * stride];
  }
};

// Pass 2 (global block l0 + n1 l, global L = n1 L): w[(l0 + n1 l) half],
// gathered by the wrapper at entry n1 (L - 1) + l n1 + l0 (ntt.py:
// pass2_tables), so the consecutive slots of a CTA read consecutive
// entries.
template <class Slots>
struct NttTw2 {
  const uint32_t* __restrict__ tw;
  int n1;
  Slots slots;
  __device__ __forceinline__ uint32_t operator()(int s, int l, int L,
                                                 int) const {
    return tw[n1 * (L - 1) + l * n1 + slots.l0(s)];
  }
};

// The sub-problems a CTA holds: 2^lslots of 2^lm points, their twiddles,
// the modulus, and whether the first step's work items run sub-problem by
// sub-problem (neighbouring threads on neighbouring elements, for a first
// step reading contiguous slices of device memory) instead of slot by
// slot (neighbouring threads on neighbouring sub-problems, whose elements
// lie side by side at the strided ends of a pass); `rest_by_sub` the same
// for the later steps (whole rows, whose steps all read and write
// contiguous runs).
template <class Tw>
struct NttSubs {
  int lslots;
  int lm;
  Tw tw;
  Mod m;
  bool first_by_sub;
  bool rest_by_sub = false;
};

// Work items of a step: max(1, m / 16) per sub-problem, item w being slot
// w mod slots and index w / slots, or, `by_sub`, slot w / items and index
// w mod items.
__device__ __forceinline__ int ntt_litems(int lm) {
  return lm >= 4 ? lm - 4 : 0;
}

__device__ __forceinline__ void ntt_item(int w, int lslots, int lm,
                                         bool by_sub, int& s, int& tau) {
  const int lp = ntt_litems(lm);
  s = by_sub ? w >> lp : w & ((1 << lslots) - 1);
  tau = by_sub ? w & ((1 << lp) - 1) : w >> lslots;
}

// Sweeps t .. T-1 of a group x in registers. Before sweep t, x[b + 2^t i]
// holds block l + b L (b < 2^t) of A(2^t L, r / 2^t) at column q + i r /
// 2^T (i < 2^(T-t)): butterfly (b, i < H) pairs i with i + H,
// H = 2^(T-t-1), with the twiddle of block l + b L, and sends its outputs
// to blocks l + b L and l + (b + 2^t) L of the next state, as ntt_stage.
template <int T, int t, class Tw>
__device__ __forceinline__ void group_sweeps(uint32_t (&x)[1 << T],
                                             const NttSubs<Tw>& sp, int s,
                                             int l, int L, int lr) {
  if constexpr (t < T) {
    constexpr int E = 1 << T;
    constexpr int H = E >> (t + 1);
    uint32_t u[E];
#pragma unroll
    for (int b = 0; b < (1 << t); ++b) {
      const uint32_t w = sp.tw(s, l + b * L, L << t, 1 << (lr - t - 1));
#pragma unroll
      for (int i = 0; i < H; ++i) {
        const uint32_t e = x[b + (i << t)];
        const uint32_t o = mont_mul(x[b + ((i + H) << t)], w, sp.m);
        u[b + (i << (t + 1))] = add_mod(e, o, sp.m.q);
        u[b + (1 << t) + (i << (t + 1))] = sub_mod(e, o, sp.m.q);
      }
    }
#pragma unroll
    for (int j = 0; j < E; ++j) x[j] = u[j];
    group_sweeps<T, t + 1>(x, sp, s, l, L, lr);
  }
}

// One step of T sweeps at local A(L, r), lr = log2 r >= T: item tau of
// slot s runs the groups tau + g (items per sub-problem), all loads first.
template <int T, class Tw, class Src, class Dst>
__device__ __forceinline__ void ntt_step(NttSubs<Tw> sp, bool by_sub, int L,
                                         int lr, Src src, Dst dst) {
  constexpr int E = 1 << T;
  constexpr int G = 16 / E;  // groups an item holds at most
  const int lq = lr - T;
  const int qr = 1 << lq;
  const int per = 1 << ntt_litems(sp.lm);
  const int nb = ((1 << sp.lm) >> T) / per;
  const int items = per << sp.lslots;
  for (int w = threadIdx.x; w < items; w += blockDim.x) {
    int s, tau;
    ntt_item(w, sp.lslots, sp.lm, by_sub, s, tau);
    uint32_t v[G][E];
#pragma unroll
    for (int g = 0; g < G; ++g) {
      if (g < nb) {
        const int b = tau + g * per;
        const int base = ((b >> lq) << lr) + (b & (qr - 1));
#pragma unroll
        for (int i = 0; i < E; ++i) v[g][i] = src.load(s, base + i * qr);
      }
    }
#pragma unroll
    for (int g = 0; g < G; ++g) {
      if (g < nb) {
        const int b = tau + g * per;
        const int l = b >> lq;
        const int q = b & (qr - 1);
        group_sweeps<T, 0>(v[g], sp, s, l, L, lr);
#pragma unroll
        for (int j = 0; j < E; ++j) {
          dst.store(s, ((l + j * L) << lq) + q, v[g][j]);
        }
      }
    }
  }
}

template <class Tw, class Src, class Dst>
__device__ __forceinline__ void ntt_run_step(int T, NttSubs<Tw> sp,
                                             bool by_sub, int L, int lr,
                                             Src src, Dst dst) {
  switch (T) {
    case 4:
      ntt_step<4>(sp, by_sub, L, lr, src, dst);
      break;
    case 3:
      ntt_step<3>(sp, by_sub, L, lr, src, dst);
      break;
    case 2:
      ntt_step<2>(sp, by_sub, L, lr, src, dst);
      break;
    default:
      ntt_step<1>(sp, by_sub, L, lr, src, dst);
  }
}

// Every sweep of the CTA's sub-problems in the whole transform's order, in
// steps of min(4, sweeps left). The first step reads `in` (device memory)
// where `from_global`, else shared buffer `a` (filled and synchronised by
// the caller); the last step writes `out` (device memory) where
// `to_global`, else the shared buffer it returns. Steps ping-pong between
// a and b (NttSmem or NttRowSmem) with a barrier after each.
template <class Tw, class In, class Out, class Sm>
__device__ __forceinline__ Sm ntt_sub_steps(NttSubs<Tw> sp, In in,
                                            bool from_global, Out out,
                                            bool to_global, Sm a, Sm b) {
  int L = 1;
  int lr = sp.lm;
  bool global_in = from_global;
  Sm cur = a, oth = b;
  while (lr > 0) {
    const int T = lr >= 4 ? 4 : lr;
    const bool last = lr == T;
    if (global_in && last && to_global) {
      ntt_run_step(T, sp, sp.first_by_sub, L, lr, in, out);
    } else if (global_in) {
      ntt_run_step(T, sp, sp.first_by_sub, L, lr, in, cur);
    } else if (last && to_global) {
      ntt_run_step(T, sp, sp.rest_by_sub, L, lr, cur, out);
    } else {
      ntt_run_step(T, sp, sp.rest_by_sub, L, lr, cur, oth);
      const Sm t = cur;
      cur = oth;
      oth = t;
    }
    global_in = false;
    __syncthreads();
    L <<= T;
    lr -= T;
  }
  return cur;
}

// The CTA's two shared buffers of `slots` sub-problems at row stride ld.
__device__ __forceinline__ void ntt_sub_buffers(uint32_t* smem, int slots,
                                                int ld, NttSmem& a,
                                                NttSmem& b) {
  a = NttSmem{smem, ld};
  b = NttSmem{smem + slots * ld, ld};
}

// The CTA's place in a launch over 2^lsubs sub-problems per row, c = 2^lc
// a CTA: its row (blockIdx.x / (2^lsubs / c)) and its first sub-problem.
__device__ __forceinline__ void ntt_pass_cta(int lsubs, int lc, size_t& row,
                                             int& first) {
  const int glg = lsubs - lc;
  row = blockIdx.x >> glg;
  first = (blockIdx.x & ((1 << glg) - 1)) << lc;
}

// F1's input: element k of sub-problem q0 = base + (s mod c) of a (slots
// s < c) or b is x[k n2 + q0] of the row at `off`, reduced mod q and, for
// the negacyclic product, twisted by psi^(k n2 + q0).
struct NttF1In {
  const uint32_t* __restrict__ a;
  const uint32_t* __restrict__ b;
  const uint32_t* __restrict__ twist;
  size_t off;
  int lg2;
  int q0;
  int lc;
  Mod m;
  bool negacyclic;
  __device__ __forceinline__ uint32_t load(int s, int k) const {
    const int j = (k << lg2) + q0 + (s & ((1 << lc) - 1));
    const uint32_t v = ((s >> lc) ? b : a)[off + j] % m.q;
    return negacyclic ? mont_mul(v, twist[j], m) : v;
  }
};

// F1's output: element l of sub-problem q0 to A[l n2 + q0] of a's or b's
// intermediate row.
struct NttF1Out {
  uint32_t* __restrict__ fa;
  uint32_t* __restrict__ fb;
  size_t off;
  int lg2;
  int q0;
  int lc;
  __device__ __forceinline__ void store(int s, int l, uint32_t v) const {
    ((s >> lc) ? fb : fa)[off + ((size_t)l << lg2) + q0 +
                          (s & ((1 << lc) - 1))] = v;
  }
};

// A contiguous sub-problem's input: element i of slot s is
// x[(l0 << lm) + i] of the row at `off`, x a's (or the only) intermediate
// for slots s < 2^lc and b's beyond.
template <class Slots>
struct NttSliceIn {
  const uint32_t* __restrict__ xa;
  const uint32_t* __restrict__ xb;
  size_t off;
  int lm;
  int lc;
  Slots slots;
  __device__ __forceinline__ uint32_t load(int s, int i) const {
    return ((s >> lc) ? xb : xa)[off + ((size_t)slots.l0(s) << lm) + i];
  }
};

// M's output: element l of the inverse's pass-1 sub-problem q0' = l0 to
// A'[l n1 + l0].
struct NttMidOut {
  uint32_t* __restrict__ ap;
  size_t off;
  int log2n1;
  int l0;
  __device__ __forceinline__ void store(int s, int l, uint32_t v) const {
    ap[off + ((size_t)l << log2n1) + l0 + s] = v;
  }
};

// I2's output: element k of sub-problem l0' to c[l0' + k n2], times the
// untwist psi^-j n^-1 (n^-1 for the cyclic product) at j = l0' + k n2.
struct NttI2Out {
  uint32_t* __restrict__ c;
  const uint32_t* __restrict__ untwist;
  size_t off;
  int lg2;
  int l0;
  Mod m;
  __device__ __forceinline__ void store(int s, int k, uint32_t v) const {
    const int j = l0 + s + (k << lg2);
    c[off + j] = mont_mul(v, untwist[j], m);
  }
};

// The NTT's pass-2 output: element k of sub-problem l0 is bin l0 + k n1,
// stored in natural order, times n^-1 (`scale`, Montgomery form) for the
// inverse.
struct NttBinsOut {
  uint32_t* __restrict__ y;
  size_t off;
  int log2n1;
  int l0;
  Mod m;
  uint32_t scale;
  bool inverse;
  __device__ __forceinline__ void store(int s, int k, uint32_t v) const {
    y[off + l0 + s + ((size_t)k << log2n1)] =
        inverse ? mont_mul(v, scale, m) : v;
  }
};

// The modulus of the launch's limb blockIdx.y: row `limb` of the (k, 4)
// table `scal` (q, qinv, r2, 0), or, for a single-limb launch (scal null,
// one grid row), the scalars the launcher was given.
__device__ __forceinline__ Mod limb_mod(const uint32_t* __restrict__ scal,
                                        uint32_t q, uint32_t qinv) {
  const int limb = blockIdx.y;
  return scal ? Mod{scal[4 * limb], scal[4 * limb + 1]} : Mod{q, qinv};
}

// Offset of the row `row` of limb blockIdx.y in a (k, B, n) stack, and of
// the limb's row in a (k, n) table.
__device__ __forceinline__ size_t limb_row(int batch, size_t row,
                                           int log2n) {
  return ((size_t)blockIdx.y * batch + row) << log2n;
}

__device__ __forceinline__ size_t limb_table(int log2n) {
  return (size_t)blockIdx.y << log2n;
}

// F1: CTA (blockIdx.x, limb blockIdx.y) takes row blockIdx.x / (n2 / c)
// and its c = 2^lc consecutive sub-problems q0 of a and of b.
__global__ void __launch_bounds__(kPassThreads)
ntt_polymul_pass1_kernel(const uint32_t* __restrict__ a_in,
                         const uint32_t* __restrict__ b_in,
                         uint32_t* __restrict__ fa, uint32_t* __restrict__ fb,
                         const uint32_t* __restrict__ wf,
                         const uint32_t* __restrict__ twist,
                         const uint32_t* __restrict__ scal, int batch,
                         int log2n, int log2n1, uint32_t q, uint32_t qinv,
                         int negacyclic, int lc) {
  extern __shared__ __align__(16) uint32_t smem[];
  const int lg2 = log2n - log2n1;
  size_t row;
  int q0;
  ntt_pass_cta(lg2, lc, row, q0);
  const Mod m = limb_mod(scal, q, qinv);
  const size_t off = limb_row(batch, row, log2n);
  const size_t table = limb_table(log2n);
  NttSmem sa, sb;
  ntt_sub_buffers(smem, 2 << lc, (1 << log2n1) + 1, sa, sb);
  const NttSubs<NttTw1> sp{lc + 1, log2n1, NttTw1{wf + table, 1 << lg2}, m,
                           false};
  ntt_sub_steps(sp, NttF1In{a_in, b_in, twist + table, off, lg2, q0, lc, m,
                            negacyclic != 0},
                true, NttF1Out{fa, fb, off, lg2, q0, lc}, true, sa, sb);
}

// M: CTA (blockIdx.x, limb blockIdx.y) takes row blockIdx.x / (n1 / c) and
// its c = 2^lc consecutive sub-problems l0 of a (slots s < c) and of b
// (slots c + s).
__global__ void __launch_bounds__(kPassThreads)
ntt_polymul_mid_kernel(const uint32_t* __restrict__ fa,
                       const uint32_t* __restrict__ fb,
                       uint32_t* __restrict__ ap,
                       const uint32_t* __restrict__ tw2f,
                       const uint32_t* __restrict__ wi,
                       const uint32_t* __restrict__ scal, int batch,
                       int log2n, int log2n1, uint32_t q, uint32_t qinv,
                       uint32_t r2, int lc) {
  extern __shared__ __align__(16) uint32_t smem[];
  const int lg2 = log2n - log2n1;
  size_t row;
  int l0;
  ntt_pass_cta(log2n1, lc, row, l0);
  const Mod m = limb_mod(scal, q, qinv);
  if (scal) r2 = scal[4 * blockIdx.y + 2];
  const size_t off = limb_row(batch, row, log2n);
  const size_t table = limb_table(log2n);
  const int c = 1 << lc;
  NttSmem sa, sb;
  ntt_sub_buffers(smem, 2 << lc, (1 << lg2) + 1, sa, sb);
  const NttPair slots{l0, lc};
  const NttSubs<NttTw2<NttPair>> fwd{
      lc + 1, lg2, NttTw2<NttPair>{tw2f + table, 1 << log2n1, slots}, m,
      true};
  const NttSmem z = ntt_sub_steps(
      fwd, NttSliceIn<NttPair>{fa, fb, off, lg2, lc, slots}, true, sa, false,
      sa, sb);
  const NttSmem spare = z.p == sa.p ? sb : sa;
  // the r2-hop product of bins l0 + k n1, in the place of a's
  for (int idx = threadIdx.x; idx < (c << lg2); idx += blockDim.x) {
    const int s = idx & (c - 1);
    const int k = idx >> lc;
    z.store(s, k, mont_mul(mont_mul(z.load(s, k), r2, m), z.load(c + s, k),
                           m));
  }
  __syncthreads();
  const NttSubs<NttTw1> inv{lc, lg2, NttTw1{wi + table, 1 << log2n1}, m,
                            false};
  ntt_sub_steps(inv, z, false, NttMidOut{ap, off, log2n1, l0}, true, z,
                spare);
}

// I2: CTA (blockIdx.x, limb blockIdx.y) takes row blockIdx.x / (n2 / c)
// and its c = 2^lc consecutive sub-problems l0' of n1 points.
__global__ void __launch_bounds__(kPassThreads)
ntt_polymul_pass2_kernel(const uint32_t* __restrict__ ap,
                         uint32_t* __restrict__ c,
                         const uint32_t* __restrict__ tw2i,
                         const uint32_t* __restrict__ untwist,
                         const uint32_t* __restrict__ scal, int batch,
                         int log2n, int log2n1, uint32_t q, uint32_t qinv,
                         int lc) {
  extern __shared__ __align__(16) uint32_t smem[];
  const int lg2 = log2n - log2n1;
  size_t row;
  int l0;
  ntt_pass_cta(lg2, lc, row, l0);
  const Mod m = limb_mod(scal, q, qinv);
  const size_t off = limb_row(batch, row, log2n);
  const size_t table = limb_table(log2n);
  NttSmem sa, sb;
  ntt_sub_buffers(smem, 1 << lc, (1 << log2n1) + 1, sa, sb);
  const NttSubs<NttTw2<NttRun>> sp{
      lc, log2n1, NttTw2<NttRun>{tw2i + table, 1 << lg2, NttRun{l0}}, m,
      true};
  // one intermediate: both of NttSliceIn's rows are A'
  ntt_sub_steps(sp, NttSliceIn<NttRun>{ap, ap, off, log2n1, lc, NttRun{l0}},
                true, NttI2Out{c, untwist + table, off, lg2, l0, m}, true,
                sa, sb);
}

// Kernel 8, register-step schedule: CTA (blockIdx.x, limb blockIdx.y)
// takes the product of row blockIdx.x of limb blockIdx.y, both operands'
// whole rows in shared memory (NttRowSmem, two buffers of two rows: 17n
// bytes). The two forward transforms run as one pass over two sub-problems
// of n points in register steps of up to four sweeps (ntt_sub_steps; the
// load reduces mod q and twists, as F1's reader on one sub-problem of the
// whole row), the r2-hop product runs in place of a's spectrum, and the
// inverse runs on it in the same steps with the untwist on the store. A
// 4096-point transform crosses shared memory three times where
// rns_ntt_polymul_kernel crosses it twelve times, with a barrier each;
// twiddles come from the limb's rows of the (k, n) tables. Bound: 32-bit
// integer operations, as kernel 6 (12 bytes of device memory a point a
// row, read and written once). 256 threads and 68 KB at n = 4096: two
// CTAs an SM at the kernel's 128 registers (three, capped at 80, spill).
__global__ void __launch_bounds__(kPassThreads)
rns_ntt_polymul_steps_kernel(const uint32_t* __restrict__ a_in,
                             const uint32_t* __restrict__ b_in,
                             uint32_t* __restrict__ c,
                             const uint32_t* __restrict__ scal,
                             const uint32_t* __restrict__ wf,
                             const uint32_t* __restrict__ wi,
                             const uint32_t* __restrict__ twist,
                             const uint32_t* __restrict__ untwist, int batch,
                             int log2n, int negacyclic) {
  extern __shared__ __align__(16) uint32_t smem[];
  const Mod m = limb_mod(scal, 0, 0);
  const uint32_t r2 = scal[4 * blockIdx.y + 2];
  const size_t off = limb_row(batch, blockIdx.x, log2n);
  const size_t table = limb_table(log2n);
  const int n = 1 << log2n;
  const int ld = n + (n >> 4);
  const NttRowSmem sa{smem, ld}, sb{smem + 2 * ld, ld};
  const NttSubs<NttTw1> fwd{1, log2n, NttTw1{wf + table, 1}, m, true, true};
  const NttRowSmem z = ntt_sub_steps(
      fwd, NttF1In{a_in, b_in, twist + table, off, 0, 0, 0, m,
                   negacyclic != 0},
      true, sa, false, sa, sb);
  const NttRowSmem spare = z.p == sa.p ? sb : sa;
  for (int k = threadIdx.x; k < n; k += blockDim.x) {
    z.store(0, k, mont_mul(mont_mul(z.load(0, k), r2, m), z.load(1, k), m));
  }
  __syncthreads();
  const NttSubs<NttTw1> inv{0, log2n, NttTw1{wi + table, 1}, m, false, true};
  ntt_sub_steps(inv, z, false, NttI2Out{c, untwist + table, off, 0, 0, m},
                true, z, spare);
}

// Kernel 7, two-pass schedule. Pass 1: CTA blockIdx.x takes row
// blockIdx.x / (n2 / c) and its c = 2^lc consecutive sub-problems q0
// (x[q0 + k n2], reduced mod q on load): sweeps L = 1 .. n1, store
// A[l n2 + q0] to the intermediate t.
__global__ void __launch_bounds__(kPassThreads)
ntt_pass1_kernel(const uint32_t* __restrict__ x, uint32_t* __restrict__ t,
                 const uint32_t* __restrict__ w, int log2n, int log2n1,
                 uint32_t q, uint32_t qinv, int lc) {
  extern __shared__ __align__(16) uint32_t smem[];
  const int lg2 = log2n - log2n1;
  size_t row;
  int q0;
  ntt_pass_cta(lg2, lc, row, q0);
  const Mod m{q, qinv};
  const size_t off = row << log2n;
  NttSmem sa, sb;
  ntt_sub_buffers(smem, 1 << lc, (1 << log2n1) + 1, sa, sb);
  const NttSubs<NttTw1> sp{lc, log2n1, NttTw1{w, 1 << lg2}, m, false};
  // one operand: every slot is below 2^lc, so NttF1In reads x alone
  ntt_sub_steps(sp, NttF1In{x, x, nullptr, off, lg2, q0, lc, m, false}, true,
                NttF1Out{t, t, off, lg2, q0, lc}, true, sa, sb);
}

// Pass 2: CTA blockIdx.x takes row blockIdx.x / (n1 / c) and its c = 2^lc
// consecutive slices A[l0 n2 ..): sweeps L = n1 .. n with the gathered
// pass-2 table `tw2` (of the forward root, or of its inverse), store bin
// l0 + k n1, times n^-1 for the inverse.
__global__ void __launch_bounds__(kPassThreads)
ntt_pass2_kernel(const uint32_t* __restrict__ t, uint32_t* __restrict__ y,
                 const uint32_t* __restrict__ tw2, int log2n, int log2n1,
                 uint32_t q, uint32_t qinv, uint32_t scale, int inverse,
                 int lc) {
  extern __shared__ __align__(16) uint32_t smem[];
  const int lg2 = log2n - log2n1;
  size_t row;
  int l0;
  ntt_pass_cta(log2n1, lc, row, l0);
  const Mod m{q, qinv};
  const size_t off = row << log2n;
  NttSmem sa, sb;
  ntt_sub_buffers(smem, 1 << lc, (1 << lg2) + 1, sa, sb);
  const NttSubs<NttTw2<NttRun>> sp{
      lc, lg2, NttTw2<NttRun>{tw2, 1 << log2n1, NttRun{l0}}, m, true};
  ntt_sub_steps(sp, NttSliceIn<NttRun>{t, t, off, lg2, lc, NttRun{l0}}, true,
                NttBinsOut{y, off, log2n1, l0, m, scale, inverse != 0}, true,
                sa, sb);
}

// Threads of a split-pass CTA for `slots` sub-problems of 2^lm points: one
// per work item of a step, at least a warp, at most kPassThreads.
int ntt_pass_threads(int slots, int lm) {
  const long t = (long)slots << (lm >= 4 ? lm - 4 : 0);
  return t < 32 ? 32 : (t > kPassThreads ? kPassThreads : (int)t);
}

// Dynamic shared memory of a split-pass CTA holding `slots` sub-problems
// of 2^lm points at row stride 2^lm + 1: one buffer for every state the
// steps keep in shared memory (the copied-in slices unless the first step
// reads device memory, and every step's output but a last one written to
// device memory), two at most. M (`mid`) keeps both: the spectra, the
// product and the inverse's pass 1 use them.
size_t ntt_pass_smem(int slots, int lm, bool from_global, bool to_global,
                     bool mid) {
  const int steps = (lm + 3) / 4;
  const int states =
      (from_global ? 0 : 1) + steps - (to_global ? 1 : 0);
  const int buffers =
      mid ? 2 : (states < 1 ? 1 : (states > 2 ? 2 : states));
  return (size_t)buffers * slots * (((size_t)1 << lm) + 1) *
         sizeof(uint32_t);
}

// Opts `kernel` in to `bytes` of dynamic shared memory above 48 KB.
template <typename Kernel>
cudaError_t opt_in(Kernel kernel, size_t bytes) {
  if (bytes > kStaticSmemBytes) {
    return cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  }
  return cudaSuccess;
}

// A split-pass launch the product takes: n1 = 2^log2n1 and n2 at least 2;
// F1's c1 = 2^lc1 sub-problems of each operand at most n2; M's cm at most
// n1; I2's ci at most n2; each launch's shared memory within the card's
// 227 KB; each grid within 2^31 - 1 CTAs.
bool bad_ntt_split(int batch, int log2n, int log2n1, int lc1, int lcm,
                   int lci) {
  const int lg2 = log2n - log2n1;
  if (log2n1 < 1 || lg2 < 1 || lc1 < 0 || lcm < 0 || lci < 0 || lc1 > lg2 ||
      lcm > log2n1 || lci > lg2) {
    return true;
  }
  const long rows = batch;
  return ntt_pass_smem(2 << lc1, log2n1, true, true, false) > kMaxSmemBytes ||
         ntt_pass_smem(2 << lcm, lg2, true, true, true) > kMaxSmemBytes ||
         ntt_pass_smem(1 << lci, log2n1, true, true, false) >
             kMaxSmemBytes ||
         (rows << (lg2 - lc1)) > 0x7fffffffL ||
         (rows << (log2n1 - lcm)) > 0x7fffffffL ||
         (rows << (lg2 - lci)) > 0x7fffffffL;
}

// A two-pass launch the NTT takes: n1 = 2^log2n1 and n2 at least 2; pass
// 1's c1 = 2^lc1 sub-problems at most n2, pass 2's c2 at most n1; each
// launch's shared memory within 227 KB, each grid within 2^31 - 1 CTAs.
bool bad_ntt_pass_split(int batch, int log2n, int log2n1, int lc1,
                        int lc2) {
  const int lg2 = log2n - log2n1;
  if (log2n1 < 1 || lg2 < 1 || lc1 < 0 || lc2 < 0 || lc1 > lg2 ||
      lc2 > log2n1) {
    return true;
  }
  const long rows = batch;
  return ntt_pass_smem(1 << lc1, log2n1, true, true, false) > kMaxSmemBytes ||
         ntt_pass_smem(1 << lc2, lg2, true, true, false) > kMaxSmemBytes ||
         (rows << (lg2 - lc1)) > 0x7fffffffL ||
         (rows << (log2n1 - lc2)) > 0x7fffffffL;
}

// Dynamic shared memory of the register-step kernel: two buffers of both
// operands' rows of 2^log2n words, one pad word in 16 (NttRowSmem).
size_t rns_steps_smem(int log2n) {
  const size_t n = (size_t)1 << log2n;
  return 4 * (n + (n >> 4)) * sizeof(uint32_t);
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
  return opt_in(kernel, *bytes);
}

// A launch of `kernel` with `threads` per CTA and `bytes` of dynamic shared
// memory (opted in): reports those, the registers per thread the compiler
// gave it, and how many such CTAs one SM holds at once.
template <typename Kernel>
cudaError_t launch_occupancy(Kernel kernel, int threads_per_cta, size_t bytes,
                             int* threads, int* smem, int* regs, int* ctas) {
  cudaError_t err = opt_in(kernel, bytes);
  if (err != cudaSuccess) return err;
  *threads = threads_per_cta;
  *smem = (int)bytes;
  cudaFuncAttributes attr;
  err = cudaFuncGetAttributes(&attr, kernel);
  if (err != cudaSuccess) return err;
  *regs = attr.numRegs;
  return cudaOccupancyMaxActiveBlocksPerMultiprocessor(ctas, kernel, *threads,
                                                       bytes);
}

// The launch configuration a launcher below gives `kernel` for `slots` rows
// (threads per CTA, dynamic shared memory) and what the card makes of it.
template <typename Kernel>
cudaError_t occupancy_of(Kernel kernel, int slots, int log2n, bool staged,
                         int* threads, int* smem, int* regs, int* ctas) {
  const size_t bytes =
      staged ? 0 : 2 * ((size_t)slots << log2n) * sizeof(uint32_t);
  return launch_occupancy(kernel, threads_for(slots, log2n), bytes, threads,
                          smem, regs, ctas);
}

// The product's split-pass schedule over `limbs` limbs (grid row y): F1, M
// and I2 on `st`, each launch checked. `scratch` holds three planes of
// limbs * batch * n words (F1's spectra of a and of b, then the inverse's
// pass-1 result); `scal` is null for a single limb, whose q, qinv and r2 are
// then the scalars given.
cudaError_t launch_polymul_split(
    const uint32_t* a, const uint32_t* b, uint32_t* c, const uint32_t* scal,
    const uint32_t* wf, const uint32_t* wi, const uint32_t* twist,
    const uint32_t* untwist, uint32_t* scratch, const uint32_t* tw2f,
    const uint32_t* tw2i, int limbs, int batch, int log2n, uint32_t q,
    uint32_t qinv, uint32_t r2, int negacyclic, int log2n1, int lc1, int lcm,
    int lci, cudaStream_t st) {
  const int lg2 = log2n - log2n1;
  const size_t plane = ((size_t)limbs * batch) << log2n;
  uint32_t* fa = scratch;
  uint32_t* fb = scratch + plane;
  uint32_t* ap = scratch + 2 * plane;
  size_t smem = ntt_pass_smem(2 << lc1, log2n1, true, true, false);
  cudaError_t err = opt_in(ntt_polymul_pass1_kernel, smem);
  if (err != cudaSuccess) return err;
  ntt_polymul_pass1_kernel<<<dim3(batch << (lg2 - lc1), limbs),
                             ntt_pass_threads(2 << lc1, log2n1), smem, st>>>(
      a, b, fa, fb, wf, twist, scal, batch, log2n, log2n1, q, qinv,
      negacyclic, lc1);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  smem = ntt_pass_smem(2 << lcm, lg2, true, true, true);
  err = opt_in(ntt_polymul_mid_kernel, smem);
  if (err != cudaSuccess) return err;
  ntt_polymul_mid_kernel<<<dim3(batch << (log2n1 - lcm), limbs),
                           ntt_pass_threads(2 << lcm, lg2), smem, st>>>(
      fa, fb, ap, tw2f, wi, scal, batch, log2n, log2n1, q, qinv, r2, lcm);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  smem = ntt_pass_smem(1 << lci, log2n1, true, true, false);
  err = opt_in(ntt_polymul_pass2_kernel, smem);
  if (err != cudaSuccess) return err;
  ntt_polymul_pass2_kernel<<<dim3(batch << (lg2 - lci), limbs),
                             ntt_pass_threads(1 << lci, log2n1), smem, st>>>(
      ap, c, tw2i, untwist, scal, batch, log2n, log2n1, q, qinv, lci);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

const char* ntt_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

// log2n1 > 0: the two-pass schedule, `scratch` one plane of batch * n
// words (pass 1's result), `tw2` the pass-2 table of the forward root (of
// its inverse for an inverse transform), `block` unused; each launch is
// checked. log2n1 == 0: one CTA per `block` rows, `tw2` unused.
int ntt_batched(const uint32_t* x, uint32_t* y, const uint32_t* w,
                uint32_t* scratch, const uint32_t* tw2, int batch, int log2n,
                uint32_t q, uint32_t qinv, uint32_t scale, int inverse,
                int block, int log2n1, int lc1, int lc2, void* stream) {
  if (bad_args(batch, log2n, block)) return cudaErrorInvalidValue;
  if (log2n1 != 0 &&
      (scratch == nullptr || tw2 == nullptr ||
       bad_ntt_pass_split(batch, log2n, log2n1, lc1, lc2))) {
    return cudaErrorInvalidValue;
  }
  if (batch == 0) return cudaSuccess;
  const cudaStream_t st = (cudaStream_t)stream;
  if (log2n1 != 0) {
    const int lg2 = log2n - log2n1;
    size_t smem = ntt_pass_smem(1 << lc1, log2n1, true, true, false);
    cudaError_t err = opt_in(ntt_pass1_kernel, smem);
    if (err != cudaSuccess) return err;
    ntt_pass1_kernel<<<batch << (lg2 - lc1), ntt_pass_threads(1 << lc1,
                                                              log2n1),
                       smem, st>>>(x, scratch, w, log2n, log2n1, q, qinv,
                                   lc1);
    err = cudaGetLastError();
    if (err != cudaSuccess) return err;
    smem = ntt_pass_smem(1 << lc2, lg2, true, true, false);
    err = opt_in(ntt_pass2_kernel, smem);
    if (err != cudaSuccess) return err;
    ntt_pass2_kernel<<<batch << (log2n1 - lc2), ntt_pass_threads(1 << lc2,
                                                                 lg2),
                       smem, st>>>(scratch, y, tw2, log2n, log2n1, q, qinv,
                                   scale, inverse, lc2);
    return cudaGetLastError();
  }
  size_t smem;
  cudaError_t err =
      smem_for(ntt_kernel, scratch != nullptr, block, log2n, &smem);
  if (err != cudaSuccess) return err;
  const int grid = (batch + block - 1) / block;
  ntt_kernel<<<grid, threads_for(block, log2n), smem, st>>>(
      x, y, w, scratch, batch, log2n, q, qinv, scale, inverse, block);
  return cudaGetLastError();
}

// log2n1 > 0: the split-pass schedule, `scratch` three planes of batch * n
// words (F1's spectra of a and of b, then the inverse's pass-1 result),
// `tw2f` the forward pass-2 table (split n1 x n2) and `tw2i` the inverse's
// (split n2 x n1), `block` unused; each launch is checked. log2n1 == 0:
// one CTA per `block` rows, `tw2f` and `tw2i` unused.
int ntt_polymul(const uint32_t* a, const uint32_t* b, uint32_t* c,
                const uint32_t* wf, const uint32_t* wi,
                const uint32_t* twist, const uint32_t* untwist,
                uint32_t* scratch, const uint32_t* tw2f,
                const uint32_t* tw2i, int batch, int log2n, uint32_t q,
                uint32_t qinv, uint32_t r2, int negacyclic, int block,
                int log2n1, int lc1, int lcm, int lci, void* stream) {
  if (bad_args(batch, log2n, block)) return cudaErrorInvalidValue;
  if (log2n1 != 0 &&
      (scratch == nullptr || tw2f == nullptr || tw2i == nullptr ||
       bad_ntt_split(batch, log2n, log2n1, lc1, lcm, lci))) {
    return cudaErrorInvalidValue;
  }
  if (batch == 0) return cudaSuccess;
  if (log2n1 != 0) {
    return launch_polymul_split(a, b, c, nullptr, wf, wi, twist, untwist,
                                scratch, tw2f, tw2i, 1, batch, log2n, q,
                                qinv, r2, negacyclic, log2n1, lc1, lcm, lci,
                                (cudaStream_t)stream);
  }
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

// Three schedules. log2n1 > 0: the split-pass launches with the limb as
// grid row y, `scratch` three planes of limbs * batch * n words, `tw2f` and
// `tw2i` the (k, n) stacks of each limb's pass-2 tables (zero-padded to n).
// Else `steps` != 0: the register-step kernel, one CTA per (row, limb).
// Else one single-CTA launch per `block` rows and limb (`scratch` its
// staging buffers, or null). Unused pointers may be null.
int ntt_rns_polymul(const uint32_t* a, const uint32_t* b, uint32_t* c,
                    const uint32_t* scal, const uint32_t* wf,
                    const uint32_t* wi, const uint32_t* twist,
                    const uint32_t* untwist, uint32_t* scratch,
                    const uint32_t* tw2f, const uint32_t* tw2i, int limbs,
                    int batch, int log2n, int negacyclic, int block,
                    int steps, int log2n1, int lc1, int lcm, int lci,
                    void* stream) {
  if (bad_args(batch, log2n, block) || limbs < 1 || limbs > 65535) {
    return cudaErrorInvalidValue;
  }
  if (log2n1 != 0 &&
      (scratch == nullptr || tw2f == nullptr || tw2i == nullptr ||
       bad_ntt_split(batch, log2n, log2n1, lc1, lcm, lci))) {
    return cudaErrorInvalidValue;
  }
  if (log2n1 == 0 && steps != 0 &&
      (log2n < 1 || rns_steps_smem(log2n) > kMaxSmemBytes)) {
    return cudaErrorInvalidValue;
  }
  if (batch == 0) return cudaSuccess;
  const cudaStream_t st = (cudaStream_t)stream;
  if (log2n1 != 0) {
    return launch_polymul_split(a, b, c, scal, wf, wi, twist, untwist,
                                scratch, tw2f, tw2i, limbs, batch, log2n, 0,
                                0, 0, negacyclic, log2n1, lc1, lcm, lci, st);
  }
  if (steps != 0) {
    const size_t smem = rns_steps_smem(log2n);
    cudaError_t err = opt_in(rns_ntt_polymul_steps_kernel, smem);
    if (err != cudaSuccess) return err;
    rns_ntt_polymul_steps_kernel<<<dim3(batch, limbs),
                                   ntt_pass_threads(2, log2n), smem, st>>>(
        a, b, c, scal, wf, wi, twist, untwist, batch, log2n, negacyclic);
    return cudaGetLastError();
  }
  size_t smem;
  cudaError_t err = smem_for(rns_ntt_polymul_kernel, scratch != nullptr,
                             2 * block, log2n, &smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((batch + block - 1) / block, limbs);
  rns_ntt_polymul_kernel<<<grid, threads_for(2 * block, log2n), smem, st>>>(
      a, b, c, scal, wf, wi, twist, untwist, scratch, batch, log2n,
      negacyclic, block);
  return cudaGetLastError();
}

// Occupancy of a launch as the launchers above make it: `kernel` is 0 NTT,
// 1 single-limb product, 2 RNS product; `block` the rows per CTA the
// wrapper passes; `staged` whether the rows go through device memory.
// Other values of `staged` select a launch of another schedule, with
// `log2n` the log2 of the launch's sub-problem length and `block` its
// sub-problems per CTA: for either product 2, 3, 4 select F1, M or I2 of
// the split-pass schedule (`block` of each operand for F1 and M, which
// hold both); for the NTT 2 and 3 its pass 1 and pass 2; for the RNS
// product 5 the register-step kernel (`log2n` the row's, `block` unused).
int ntt_occupancy(int kernel, int log2n, int block, int staged, int* threads,
                  int* smem, int* regs, int* ctas) {
  if (bad_args(1, log2n, block)) return cudaErrorInvalidValue;
  if ((kernel == 1 || kernel == 2) && staged >= 2 && staged <= 4) {
    if (log2n < 1) return cudaErrorInvalidValue;
    switch (staged) {
      case 2:
        return launch_occupancy(
            ntt_polymul_pass1_kernel, ntt_pass_threads(2 * block, log2n),
            ntt_pass_smem(2 * block, log2n, true, true, false), threads, smem,
            regs, ctas);
      case 3:
        return launch_occupancy(
            ntt_polymul_mid_kernel, ntt_pass_threads(2 * block, log2n),
            ntt_pass_smem(2 * block, log2n, true, true, true), threads, smem,
            regs, ctas);
      default:
        return launch_occupancy(
            ntt_polymul_pass2_kernel, ntt_pass_threads(block, log2n),
            ntt_pass_smem(block, log2n, true, true, false), threads, smem,
            regs, ctas);
    }
  }
  if (kernel == 2 && staged == 5) {
    if (log2n < 1) return cudaErrorInvalidValue;
    return launch_occupancy(rns_ntt_polymul_steps_kernel,
                            ntt_pass_threads(2, log2n), rns_steps_smem(log2n),
                            threads, smem, regs, ctas);
  }
  if (kernel == 0 && (staged == 2 || staged == 3)) {
    if (log2n < 1) return cudaErrorInvalidValue;
    const int t = ntt_pass_threads(block, log2n);
    const size_t bytes = ntt_pass_smem(block, log2n, true, true, false);
    return staged == 2 ? launch_occupancy(ntt_pass1_kernel, t, bytes,
                                          threads, smem, regs, ctas)
                       : launch_occupancy(ntt_pass2_kernel, t, bytes,
                                          threads, smem, regs, ctas);
  }
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
