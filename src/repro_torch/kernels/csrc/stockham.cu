// Hand-written Hopper (sm_90a) kernels for the float transform service:
// batched complex FFT, two-for-one real FFT and its inverse, and the fused
// complex and real circular polynomial products. One Stockham routine
// serves all five.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3
//        -fmad=false -shared -Xcompiler -fPIC  (repro_torch/kernels/_build.py)
// The C entry points at the end take device pointers and a stream, launch on
// that stream, and return cudaGetLastError() after the launch.
//
// Data layout: complex rows as split fp32 planes (re, im), row stride n,
// n a power of two. The Stockham autosort state of a row is A(L, r) with
// L * r = n: element (l, q) at l * r + q, and column q of A is the length-L
// FFT of x[q :: r]. No bit-reversal pass and no gather: every sweep reads
// and writes contiguous strided slices.
//
// Where the rows live (the shared-memory switch):
//   A CTA holds `block` rows (a row is n complex fp32 values, 8n bytes) in
//   two ping-pong buffers. A sweep reads one buffer and writes the other,
//   then __syncthreads(). Its working set is therefore 16n bytes per complex
//   row it transforms: one row for the FFT, half a row for each real row of
//   the real FFT (two real rows ride one complex row), and two rows for the
//   products, which hold both operands' spectra side by side. While that
//   fits the 227 KB a CTA may opt into on Hopper, the rows stay in dynamic
//   shared memory for every sweep, and device memory sees each input once
//   and each output once. That holds up to n = 8192 for the FFT and the real
//   FFT, and up to n = 4096 for the two products. Longer rows (the service
//   takes up to n = 2^18 and beyond) run the very same stage loop on a
//   device-memory ping-pong scratch that the wrapper allocates, one slice per
//   CTA; __syncthreads() orders those global accesses within the CTA, and
//   the scratch is read through plain (coherent) loads, never the read-only
//   path. The wrapper (repro_torch/kernels/fft.py: cta_rows) decides which
//   path runs and passes scratch == nullptr for the shared-memory one.
//   The FFT, the real FFT and its inverse take a third schedule from 8192
//   points on, as far as n splits into two parts of at most 8192 points:
//   two launches, each CTA holding whole sub-problems of the split (the
//   two-pass sections below); the two products take it too, as three or
//   four launches, from
//   their own thresholds (the split-pass section below: 8192 for the
//   complex product, 4096 for the real one). The staged path runs only
//   where no split fits.
//
// Arithmetic: twiddles come from the host table (f64 angles rounded once to
// fp32) in device memory; the kernels never call sincosf/__sinf. The file is
// built with -fmad=false, so no multiply-add is contracted: the Hermitian
// split and the pointwise products perform the same roundings as the plain
// PyTorch versions, which keeps the split spectra exactly Hermitian (each
// mirrored component is the same float expression) -- the property the
// paired inverse of the real product relies on.
#include <cuda_runtime.h>

#include <cstddef>

namespace {

constexpr int kMaxThreads = 1024;
constexpr size_t kStaticSmemBytes = 48 * 1024;
constexpr size_t kMaxSmemBytes = 232448;
// Threads of a two-pass CTA at most (one per work item of its steps below
// that): each holds 16 complex values in registers, so the pass kernels
// are compiled for this many threads, which leaves them up to 255
// registers.
constexpr int kPassThreads = 256;

// `rows` complex rows of length n in split planes.
struct Rows {
  float* re;
  float* im;
};

__device__ __forceinline__ void cmul(float ar, float ai, float br, float bi,
                                     float& cr, float& ci) {
  cr = ar * br - ai * bi;
  ci = ar * bi + ai * br;
}

// One radix-2 sweep over `rows` rows: A(L, r) -> A(2L, r/2), lr = log2 r.
// Twiddle of column block l: W[l * n / 2L] = W[l * r/2].
__device__ void radix2_stage(Rows src, Rows dst, int rows, int log2n, int L,
                             int lr, const float* __restrict__ wr,
                             const float* __restrict__ wi) {
  const int lh = lr - 1;
  const int half = 1 << lh;
  const int per_row = 1 << (log2n - 1);
  const int total = rows * per_row;
  for (int idx = threadIdx.x; idx < total; idx += blockDim.x) {
    const size_t base = (size_t)(idx >> (log2n - 1)) << log2n;
    const int j = idx & (per_row - 1);
    const int l = j >> lh;
    const int q = j & (half - 1);
    const float* sr = src.re + base;
    const float* si = src.im + base;
    const int ie = (l << lr) + q;
    const float er = sr[ie], ei = si[ie];
    const float odr = sr[ie + half], odi = si[ie + half];
    float tr, ti;
    cmul(wr[l * half], wi[l * half], odr, odi, tr, ti);
    float* dr = dst.re + base;
    float* di = dst.im + base;
    const int oe = (l << lh) + q;
    const int hi = oe + (L << lh);
    dr[oe] = er + tr;
    di[oe] = ei + ti;
    dr[hi] = er - tr;
    di[hi] = ei - ti;
  }
}

// One radix-4 sweep: A(L, r) -> A(4L, r/4). With E_m the m-th quarter of a
// row block and T_m = W[l m r/4] E_m: out blocks (a+c, b+i'd, a-c, b-i'd)
// for a = T0+T2, b = T0-T2, c = T1+T3, d = T1-T3, where i'd multiplies d by
// -i forward (sign < 0) and by +i inverse.
__device__ void radix4_stage(Rows src, Rows dst, int rows, int log2n, int L,
                             int lr, float sign, const float* __restrict__ wr,
                             const float* __restrict__ wi) {
  const int lq = lr - 2;
  const int q4 = 1 << lq;
  const int per_row = 1 << (log2n - 2);
  const int total = rows * per_row;
  const int lstride = L << lq;
  for (int idx = threadIdx.x; idx < total; idx += blockDim.x) {
    const size_t base = (size_t)(idx >> (log2n - 2)) << log2n;
    const int j = idx & (per_row - 1);
    const int l = j >> lq;
    const int q = j & (q4 - 1);
    const float* sr = src.re + base;
    const float* si = src.im + base;
    const int ib = (l << lr) + q;
    const float t0r = sr[ib], t0i = si[ib];
    float t1r, t1i, t2r, t2i, t3r, t3i;
    cmul(wr[l * q4], wi[l * q4], sr[ib + q4], si[ib + q4], t1r, t1i);
    cmul(wr[2 * l * q4], wi[2 * l * q4], sr[ib + 2 * q4], si[ib + 2 * q4],
         t2r, t2i);
    cmul(wr[3 * l * q4], wi[3 * l * q4], sr[ib + 3 * q4], si[ib + 3 * q4],
         t3r, t3i);
    const float a_r = t0r + t2r, a_i = t0i + t2i;
    const float b_r = t0r - t2r, b_i = t0i - t2i;
    const float c_r = t1r + t3r, c_i = t1i + t3i;
    const float d_r = t1r - t3r, d_i = t1i - t3i;
    const float id_r = sign < 0.f ? d_i : -d_i;
    const float id_i = sign < 0.f ? -d_r : d_r;
    float* dr = dst.re + base;
    float* di = dst.im + base;
    const int ob = (l << lq) + q;
    dr[ob] = a_r + c_r;
    di[ob] = a_i + c_i;
    dr[ob + lstride] = b_r + id_r;
    di[ob + lstride] = b_i + id_i;
    dr[ob + 2 * lstride] = a_r - c_r;
    di[ob + 2 * lstride] = a_i - c_i;
    dr[ob + 3 * lstride] = b_r - id_r;
    di[ob + 3 * lstride] = b_i - id_i;
  }
}

// Every sweep of an n-point transform over `rows` rows, starting in `a` and
// ping-ponging with `b`. The caller has synchronised after filling `a`. On
// return `a` holds the result and `b` the other buffer. Radix 4 runs one
// radix-2 sweep first when log2 n is odd. The table (wr, wi) is the forward
// table, or the conjugated one for an inverse; the 1/n scale is the
// caller's.
__device__ void stockham(Rows& a, Rows& b, int rows, int log2n, int radix,
                         bool inverse, const float* __restrict__ wr,
                         const float* __restrict__ wi) {
  const float sign = inverse ? 1.f : -1.f;
  int L = 1;
  int lr = log2n;
  if (radix == 4 && (log2n & 1)) {
    radix2_stage(a, b, rows, log2n, L, lr, wr, wi);
    __syncthreads();
    const Rows t = a; a = b; b = t;
    L <<= 1;
    lr -= 1;
  }
  while (lr > 0) {
    if (radix == 4 && lr >= 2) {
      radix4_stage(a, b, rows, log2n, L, lr, sign, wr, wi);
      L <<= 2;
      lr -= 2;
    } else {
      radix2_stage(a, b, rows, log2n, L, lr, wr, wi);
      L <<= 1;
      lr -= 1;
    }
    __syncthreads();
    const Rows t = a; a = b; b = t;
  }
}

// The CTA's two ping-pong buffers of `slots` complex rows each: in dynamic
// shared memory, or in this CTA's slice of the device-memory scratch.
__device__ __forceinline__ void cta_buffers(float* smem, float* scratch,
                                            int slots, int log2n, Rows& a,
                                            Rows& b) {
  const size_t plane = (size_t)slots << log2n;
  float* mem = scratch ? scratch + (size_t)blockIdx.x * 4 * plane : smem;
  a = Rows{mem, mem + plane};
  b = Rows{mem + 2 * plane, mem + 3 * plane};
}

// Kernel 1 -- replaces repro/kernels/fft.py::_fft_kernel (fft_planes).
// Batched complex FFT or inverse FFT (scaled by 1/n) of split planes (B, n).
// Bound on this card: device-memory bytes -- a call reads 8 bytes and
// writes 8 bytes per point and does ~5 log2(n) flops per point, far below
// the 20 flops/byte at which the H100's fp32 rate would bind. Design: every
// sweep stays in shared memory while the row fits (n <= 8192), so device
// memory sees the input once and the output once; the 1/n scale is folded
// into the write-out. From 8192 points on the wrapper launches the two-pass
// kernels instead (fft_pass1_kernel, fft_pass2_kernel, below); rows past
// their splits take the device-memory scratch.
__global__ void __launch_bounds__(kMaxThreads)
fft_kernel(const float* __restrict__ xr, const float* __restrict__ xi,
           float* __restrict__ yr, float* __restrict__ yi,
           const float* __restrict__ wr, const float* __restrict__ wi,
           float* scratch, int batch, int log2n, int radix, int inverse,
           int block) {
  extern __shared__ __align__(16) float smem[];
  Rows a, b;
  cta_buffers(smem, scratch, block, log2n, a, b);
  const int row0 = blockIdx.x * block;
  const int rows = min(block, batch - row0);
  const size_t off = (size_t)row0 << log2n;
  const int count = rows << log2n;
  for (int k = threadIdx.x; k < count; k += blockDim.x) {
    a.re[k] = xr[off + k];
    a.im[k] = xi[off + k];
  }
  __syncthreads();
  stockham(a, b, rows, log2n, radix, inverse != 0, wr, wi);
  const float scale = inverse ? 1.f / (float)(1 << log2n) : 1.f;
  for (int k = threadIdx.x; k < count; k += blockDim.x) {
    yr[off + k] = a.re[k] * scale;
    yi[off + k] = a.im[k] * scale;
  }
}

// Kernel 2 -- replaces repro/kernels/fft.py::_rfft_kernel (rfft_planes).
// Two-for-one real FFT: real rows (2j, 2j+1) ride one complex transform as
// z = a + ib; the Hermitian split A_k = (Z_k + conj Z_{n-k})/2,
// B_k = -i (Z_k - conj Z_{n-k})/2 separates them, and each spectrum leaves
// in the packed-Nyquist layout: P[0] = X0.re + i Xnyq.re, P[k] = X[k] for
// 0 < k < n/2. Output planes (B, n/2). An odd batch pairs its last row with
// a zero row, which is never written back. Bound: device-memory bytes
// (4 bytes in and 4 bytes out per real point). Design: the split and the
// packing happen in shared memory, so the full spectrum never reaches
// device memory; two real rows share one complex transform, halving the
// butterflies and the working set of the complex kernel on real input. From
// 8192 points on the wrapper launches rfft_pass1_kernel and
// rfft_pass2_kernel (below) instead, with the split in pass 2's epilogue.
__global__ void __launch_bounds__(kMaxThreads)
rfft_kernel(const float* __restrict__ x, float* __restrict__ yr,
            float* __restrict__ yi, const float* __restrict__ wr,
            const float* __restrict__ wi, float* scratch, int batch,
            int log2n, int radix, int block) {
  extern __shared__ __align__(16) float smem[];
  Rows a, b;
  cta_buffers(smem, scratch, block >> 1, log2n, a, b);
  const int n = 1 << log2n;
  const int nh = n >> 1;
  const int row0 = blockIdx.x * block;
  const int rows = min(block, batch - row0);
  const int pairs = (rows + 1) >> 1;
  for (int k = threadIdx.x; k < (pairs << log2n); k += blockDim.x) {
    const int r = row0 + 2 * (k >> log2n);
    const size_t col = k & (n - 1);
    a.re[k] = x[((size_t)r << log2n) + col];
    a.im[k] = r + 1 < batch ? x[((size_t)(r + 1) << log2n) + col] : 0.f;
  }
  __syncthreads();
  stockham(a, b, pairs, log2n, radix, false, wr, wi);
  for (int k = threadIdx.x; k < pairs * nh; k += blockDim.x) {
    const int p = k >> (log2n - 1);
    const int kk = k & (nh - 1);
    const int m = (n - kk) & (n - 1);
    const float* zr = a.re + ((size_t)p << log2n);
    const float* zi = a.im + ((size_t)p << log2n);
    const float z_r = zr[kk], z_i = zi[kk], m_r = zr[m], m_i = zi[m];
    const int r = row0 + 2 * p;
    const size_t oa = (size_t)r * nh + kk;
    yr[oa] = 0.5f * (m_r + z_r);
    yi[oa] = kk == 0 ? 0.5f * (zr[nh] + zr[nh]) : 0.5f * (-m_i + z_i);
    if (r + 1 < batch) {
      yr[oa + nh] = 0.5f * (m_i + z_i);
      yi[oa + nh] = kk == 0 ? 0.5f * (zi[nh] + zi[nh]) : 0.5f * (m_r - z_r);
    }
  }
}

// ---------------------------------------------------------------------------
// Kernels 1 and 2, two-pass schedule (fft_planes and rfft_planes from
// TWO_PASS_FROM points on, repro_torch/kernels/fft.py).
//
// The Stockham state A(L, r) splits at L = n1 (n = n1 * n2, n1 on the sweep
// sequence) without changing one operation. Pass 1 runs the sweeps from
// L = 1 to n1: they keep the column index modulo n2, so sub-problem q0 is
// the n1-point transform of x[q0 + k n2], which ends as A[l n2 + q0]. Pass 2
// runs the sweeps from L = n1 to n: they keep the block index modulo n1, so
// sub-problem l0 starts as the slice A[l0 n2 .. (l0 + 1) n2) and ends as
// y[l0 + k n1]; its twiddles take the global block index l0 + n1 l' (the
// four-step twiddle, folded into the sweeps). Each pass is one launch; a
// CTA takes `slots` consecutive sub-problems, so the strided accesses to
// device memory move runs of `slots` contiguous floats.
//
// Inside a pass the sweeps run as steps in registers: a radix-16 step does
// two radix-4 sweeps on 16 elements a thread holds (the four butterflies of
// the first sweep that share one column block feed exactly the four of the
// second), a radix-4 or radix-2 step one sweep on up to 16 elements. Steps
// exchange their elements through shared memory (slot-major, row stride
// m + 1 floats) with one barrier each; the first step loads from device
// memory and the last stores to it, so a 256-point sub-problem touches
// shared memory once. Pass 1's twiddles come from the host table (all slots
// share them); pass 2's from a table the wrapper gathers in the order a CTA
// reads them (Pass2Twiddles), since its slots' twiddles differ and would
// otherwise be scattered reads. Every butterfly is the whole-row sweep's own
// arithmetic on the same operands and the same twiddle values, in the same
// order, so the result equals the single-CTA kernels' and the plain
// versions' bit for bit.
//
// Bound: device-memory bytes. Device memory sees the input once, the
// intermediate (one complex row per row; per row pair for the rfft) written
// once and read once, and the output once -- at batch 64 and n = 65536 the
// intermediate is 33.5 MB and fits the 50 MB L2 -- and the grid has B n2 /
// slots CTAs per pass (1024 at that shape), so every SM has work, where the
// single-CTA staged kernel ran one CTA per row through a device-memory
// ping-pong for all 8 sweeps.
// ---------------------------------------------------------------------------

// Consecutive sub-problems: slot s holds sub-problem base + s (pass 1's q0,
// the fft's pass-2 l0).
struct RunSlots {
  int base;
  __device__ __forceinline__ int l0(int s) const { return base + s; }
};

// Pass 2 of the rfft: CTA g holds the low sub-problems l0 = g c + t in slots
// t < c and their mirrors n1 - l0 in slots c + t; the two sub-problems that
// are their own mirrors, 0 and n1 / 2, sit in CTA 0's slots 0 and c
// (fft.py: mirror_slots).
struct MirrorSlots {
  int g;
  int c;
  int n1;
  __device__ __forceinline__ int l0(int s) const {
    if (s < c) return g * c + s;
    const int low = g * c + (s - c);
    return low == 0 ? n1 >> 1 : n1 - low;
  }
  __device__ __forceinline__ int mirror(int s) const {
    if (g == 0 && (s == 0 || s == c)) return s;
    return s < c ? s + c : s - c;
  }
};

struct Cplx {
  float r, i;
};

// The radix-2 and radix-4 butterflies of radix2_stage and radix4_stage, the
// same fp32 operations in the same order.
__device__ __forceinline__ void bfly2(Cplx e, Cplx o, Cplx w, Cplx& lo,
                                      Cplx& hi) {
  Cplx t;
  cmul(w.r, w.i, o.r, o.i, t.r, t.i);
  lo = Cplx{e.r + t.r, e.i + t.i};
  hi = Cplx{e.r - t.r, e.i - t.i};
}

__device__ __forceinline__ void bfly4(Cplx e0, Cplx e1, Cplx e2, Cplx e3,
                                      Cplx w1, Cplx w2, Cplx w3, float sign,
                                      Cplx* o) {
  float t1r, t1i, t2r, t2i, t3r, t3i;
  cmul(w1.r, w1.i, e1.r, e1.i, t1r, t1i);
  cmul(w2.r, w2.i, e2.r, e2.i, t2r, t2i);
  cmul(w3.r, w3.i, e3.r, e3.i, t3r, t3i);
  const float a_r = e0.r + t2r, a_i = e0.i + t2i;
  const float b_r = e0.r - t2r, b_i = e0.i - t2i;
  const float c_r = t1r + t3r, c_i = t1i + t3i;
  const float d_r = t1r - t3r, d_i = t1i - t3i;
  const float id_r = sign < 0.f ? d_i : -d_i;
  const float id_i = sign < 0.f ? -d_r : d_r;
  o[0] = Cplx{a_r + c_r, a_i + c_i};
  o[1] = Cplx{b_r + id_r, b_i + id_i};
  o[2] = Cplx{a_r - c_r, a_i - c_i};
  o[3] = Cplx{b_r - id_r, b_i - id_i};
}

// Twiddle m' (1 .. R-1) of local block l of slot s in a sweep of radix R at
// local A(L, r), qr = r/R: the whole-row sweep's W[l_g m' n / (R L_g)] for
// the slot's global block l_g.
//
// Pass 1: l_g = l and L_g = L, so it is W[l m' qr n2] of the host table,
// the same for every slot.
struct Pass1Twiddles {
  const float* __restrict__ wr;
  const float* __restrict__ wi;
  int n2;
  __device__ __forceinline__ Cplx operator()(int, int l, int, int qr,
                                             int j) const {
    const int t = l * (j * qr) * n2;
    return Cplx{wr[t], wi[t]};
  }
};

// Pass 2: l_g = l0 + n1 l and L_g = n1 L, so it is W[(l0 + n1 l) m' qr]. The
// wrapper gathers these values from the host table into the pass-2 table
// (fft.py: pass2_twiddles): entry n1 (L - 1) + ((m' - 1) L + l) n1 + l0,
// sweep after sweep, so the slots of a CTA, which hold consecutive l0,
// read consecutive entries.
template <class Slots>
struct Pass2Twiddles {
  const float* __restrict__ tw;
  int plane;
  int n1;
  Slots slots;
  __device__ __forceinline__ Cplx operator()(int s, int l, int L, int,
                                             int j) const {
    const int t = n1 * (L - 1) + ((j - 1) * L + l) * n1 + slots.l0(s);
    return Cplx{tw[t], tw[plane + t]};
  }
};

// The sub-problems a pass CTA holds: `slots` (2^lslots) of 2^lm points, the
// sign of the transform, its twiddles, and whether the first step's work
// items run sub-problem by sub-problem (`first_by_sub`: neighbouring
// threads on neighbouring elements of one sub-problem, for a first step
// that reads contiguous slices of device memory) instead of slot by slot.
template <class Tw>
struct Subs {
  int lslots;
  int lm;
  float sign;
  Tw tw;
  bool first_by_sub;
};

// Element p of slot s in shared memory (slot-major, row stride ld).
struct SmemIO {
  Rows rows;
  int ld;
  __device__ __forceinline__ Cplx load(int s, int p) const {
    return Cplx{rows.re[s * ld + p], rows.im[s * ld + p]};
  }
  __device__ __forceinline__ void store(int s, int p, Cplx v) const {
    rows.re[s * ld + p] = v.r;
    rows.im[s * ld + p] = v.i;
  }
};

// Work items of a step: every slot's sub-problem splits into max(1, m/16)
// items of up to 16 elements. Item w is slot w mod slots and index
// w / slots within its sub-problem (neighbouring threads on neighbouring
// sub-problems, whose elements lie side by side in device memory at the
// strided ends of each pass), or, `by_sub`, slot w / items and index
// w mod items.
__device__ __forceinline__ int litems_per_sub(int lm) {
  return lm >= 4 ? lm - 4 : 0;
}

__device__ __forceinline__ void item_of(int w, int lslots, int lm,
                                        bool by_sub, int& s, int& tau) {
  const int lp = litems_per_sub(lm);
  s = by_sub ? w >> lp : w & ((1 << lslots) - 1);
  tau = by_sub ? w & ((1 << lp) - 1) : w >> lslots;
}

// One sweep of radix R = 2 or 4 at local A(L, r), lr = log2 r: item tau of
// slot s does butterflies tau + i * (items per sub-problem), all loads
// first.
template <int R, class Tw, class Src, class Dst>
__device__ __forceinline__ void step_radix(Subs<Tw> sp, bool by_sub, int L,
                                           int lr, Src src, Dst dst) {
  constexpr int kMax = 16 / R;  // butterflies an item does at most
  const int lq = R == 4 ? lr - 2 : lr - 1;
  const int qr = 1 << lq;
  const int per = 1 << litems_per_sub(sp.lm);
  const int nb = ((1 << sp.lm) / R) / per;
  const int items = per << sp.lslots;
  for (int w = threadIdx.x; w < items; w += blockDim.x) {
    int s, tau;
    item_of(w, sp.lslots, sp.lm, by_sub, s, tau);
    Cplx v[16];
#pragma unroll
    for (int i = 0; i < kMax; ++i) {
      if (i < nb) {
        const int b = tau + i * per;
        const int ib = ((b >> lq) << lr) + (b & (qr - 1));
#pragma unroll
        for (int j = 0; j < R; ++j) v[R * i + j] = src.load(s, ib + j * qr);
      }
    }
#pragma unroll
    for (int i = 0; i < kMax; ++i) {
      if (i < nb) {
        const int b = tau + i * per;
        const int l = b >> lq;
        const int ob = (l << lq) + (b & (qr - 1));
        Cplx o[4];
        if (R == 4) {
          bfly4(v[4 * i], v[4 * i + 1], v[4 * i + 2], v[4 * i + 3],
                sp.tw(s, l, L, qr, 1), sp.tw(s, l, L, qr, 2),
                sp.tw(s, l, L, qr, 3), sp.sign, o);
        } else {
          bfly2(v[2 * i], v[2 * i + 1], sp.tw(s, l, L, qr, 1), o[0], o[1]);
        }
#pragma unroll
        for (int j = 0; j < R; ++j) dst.store(s, ob + j * (L << lq), o[j]);
      }
    }
  }
}

// Two radix-4 sweeps in registers, A(L, r) -> A(16L, r/16) (r >= 16): item
// (l, q2), q2 < r/16, holds the 16 elements (l, q2 + t r/16), which the
// first sweep's four butterflies (l, q2 + m r/16) read and the second
// sweep's four butterflies (l + jL, q2) write. The butterflies, twiddles
// and their order are the two sweeps' own.
template <class Tw, class Src, class Dst>
__device__ __forceinline__ void step_radix16(Subs<Tw> sp, bool by_sub, int L,
                                             int lr, Src src, Dst dst) {
  const int l16 = lr - 4;
  const int r16 = 1 << l16;
  const int items = 1 << (litems_per_sub(sp.lm) + sp.lslots);
  for (int w = threadIdx.x; w < items; w += blockDim.x) {
    int s, tau;
    item_of(w, sp.lslots, sp.lm, by_sub, s, tau);
    const int l = tau >> l16;
    const int q2 = tau & (r16 - 1);
    Cplx v[16];
#pragma unroll
    for (int t = 0; t < 16; ++t) v[t] = src.load(s, (l << lr) + q2 + t * r16);
    // sweep at (L, r): butterfly m reads (l, q2 + (m + 4j) r/16) and writes
    // its output j to (l + jL, q2 + m r/16), kept in v[4j + m] (the slots
    // it read)
    const Cplx w1 = sp.tw(s, l, L, 4 * r16, 1),
               w2 = sp.tw(s, l, L, 4 * r16, 2),
               w3 = sp.tw(s, l, L, 4 * r16, 3);
#pragma unroll
    for (int m = 0; m < 4; ++m) {
      Cplx o[4];
      bfly4(v[m], v[m + 4], v[m + 8], v[m + 12], w1, w2, w3, sp.sign, o);
#pragma unroll
      for (int j = 0; j < 4; ++j) v[4 * j + m] = o[j];
    }
    // sweep at (4L, r/4): butterfly (l + jL, q2) reads v[4j + m] and writes
    // output m' to (l + jL + 4L m', q2) of A(16L, r/16)
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int lj = l + j * L;
      Cplx o[4];
      bfly4(v[4 * j], v[4 * j + 1], v[4 * j + 2], v[4 * j + 3],
            sp.tw(s, lj, 4 * L, r16, 1), sp.tw(s, lj, 4 * L, r16, 2),
            sp.tw(s, lj, 4 * L, r16, 3), sp.sign, o);
#pragma unroll
      for (int mm = 0; mm < 4; ++mm) {
        dst.store(s, ((lj + 4 * L * mm) << l16) + q2, o[mm]);
      }
    }
  }
}

// The radix of the next step at local (L, lr): radix 2 throughout for
// radix 2; for radix 4 the leading radix-2 sweep of an odd log2 m, then
// two radix-4 sweeps per step while r >= 16, and a single one last.
__device__ __forceinline__ int next_step(int radix, int lm, int L, int lr) {
  if (radix == 2 || (L == 1 && (lm & 1))) return 2;
  return lr >= 4 ? 16 : 4;
}

template <class Tw, class Src, class Dst>
__device__ __forceinline__ void run_step(int R, Subs<Tw> sp, bool by_sub,
                                         int L, int lr, Src src, Dst dst) {
  if (R == 16) {
    step_radix16(sp, by_sub, L, lr, src, dst);
  } else if (R == 4) {
    step_radix<4>(sp, by_sub, L, lr, src, dst);
  } else {
    step_radix<2>(sp, by_sub, L, lr, src, dst);
  }
}

// Every sweep of the CTA's sub-problems, in the whole transform's order,
// grouped into steps. The first step reads `in` (device memory) where
// `from_global`, else shared buffer `a` (filled and synchronised by the
// caller); the last step writes `out` (device memory) where `to_global`,
// else the shared buffer it returns. Steps ping-pong between a and b (two
// SmemIO, or two of another shared layout) with a barrier after each.
template <class Tw, class In, class Out, class Buf>
__device__ __forceinline__ Buf sub_steps(Subs<Tw> sp, int radix, In in,
                                         bool from_global, Out out,
                                         bool to_global, Buf a, Buf b) {
  int L = 1;
  int lr = sp.lm;
  bool global_in = from_global;
  Buf cur = a, oth = b;
  while (lr > 0) {
    const int R = next_step(radix, sp.lm, L, lr);
    const int lg = R == 16 ? 4 : R == 4 ? 2 : 1;
    const bool last = lr == lg;
    if (global_in && last && to_global) {
      run_step(R, sp, sp.first_by_sub, L, lr, in, out);
    } else if (global_in) {
      run_step(R, sp, sp.first_by_sub, L, lr, in, cur);
    } else if (last && to_global) {
      run_step(R, sp, false, L, lr, cur, out);
    } else {
      run_step(R, sp, false, L, lr, cur, oth);
      const Buf t = cur; cur = oth; oth = t;
    }
    global_in = false;
    __syncthreads();
    L <<= lg;
    lr -= lg;
  }
  return cur;
}

// The CTA's two ping-pong buffers of `slots` sub-problems at row stride ld.
__device__ __forceinline__ void sub_buffers(float* smem, int slots, int ld,
                                            SmemIO& a, SmemIO& b) {
  const int plane = slots * ld;
  a = SmemIO{Rows{smem, smem + plane}, ld};
  b = SmemIO{Rows{smem + 2 * plane, smem + 3 * plane}, ld};
}

// Pass 1's input: element k of sub-problem q0 = q0base + s is x[k n2 + q0]
// (for the rfft, z = a + ib of the pair's rows, 0 past an odd batch).
struct Pass1In {
  const float* __restrict__ xr;
  const float* __restrict__ xi;
  size_t off;
  int lg2;
  int q0;
  bool second;
  __device__ __forceinline__ Cplx load(int s, int k) const {
    const size_t g = off + ((size_t)k << lg2) + q0 + s;
    return Cplx{xr[g], second ? xi[g] : 0.f};
  }
};

// Pass 1's output: element l of sub-problem q0 = slots.l0(s) is
// A[l n2 + q0].
template <class Slots>
struct Pass1Out {
  float* __restrict__ mr;
  float* __restrict__ mi;
  size_t off;
  int lg2;
  Slots slots;
  __device__ __forceinline__ void store(int s, int l, Cplx v) const {
    const size_t g = off + ((size_t)l << lg2) + slots.l0(s);
    mr[g] = v.r;
    mi[g] = v.i;
  }
};

// Pass 2's output (fft): element k of sub-problem l0 = l0base + s is
// y[l0 + k n1], its parts scaled by sr and si (1/n for the inverse; 1/n
// and -1/n for the complex product's conj(FFT(conj P))/n).
struct Pass2Out {
  float* __restrict__ yr;
  float* __restrict__ yi;
  size_t off;
  int l0base;
  int lg1;
  float sr;
  float si;
  __device__ __forceinline__ void store(int s, int k, Cplx v) const {
    const size_t g = off + l0base + s + ((size_t)k << lg1);
    yr[g] = v.r * sr;
    yi[g] = v.i * si;
  }
};

// The CTA's place in a pass over 2^lsubs sub-problems per row, c = 2^lc a
// CTA: its row (blockIdx.x / (2^lsubs / c)) and its first sub-problem.
__device__ __forceinline__ void pass_cta(int lsubs, int lc, size_t& row,
                                         int& first) {
  const int glg = lsubs - lc;
  row = blockIdx.x >> glg;
  first = (blockIdx.x & ((1 << glg) - 1)) << lc;
}

// Pass 1 of a row: the c = 2^lc consecutive sub-problems q0 = q0base + s,
// the sweeps from L = 1 to n1, loading element k of sub-problem q0 from
// `in` in the first step and storing A[l n2 + q0] to the intermediate row
// at `out` in the last.
template <class In>
__device__ __forceinline__ void pass1_from(In in, float* __restrict__ mr,
                                           float* __restrict__ mi, size_t out,
                                           int q0,
                                           const float* __restrict__ wr,
                                           const float* __restrict__ wi,
                                           int log2n, int log2n1, int radix,
                                           float sign, int lc) {
  extern __shared__ __align__(16) float smem[];
  const int lg2 = log2n - log2n1;
  SmemIO a, b;
  sub_buffers(smem, 1 << lc, (1 << log2n1) + 1, a, b);
  const Subs<Pass1Twiddles> sp{lc, log2n1, sign,
                               Pass1Twiddles{wr, wi, 1 << lg2}, false};
  sub_steps(sp, radix, in, true,
            Pass1Out<RunSlots>{mr, mi, out, lg2, RunSlots{q0}}, true, a, b);
}

// pass1_from with x[k n2 + q0] of the row at `in` (the imaginary part 0
// unless `second`).
__device__ __forceinline__ void pass1(const float* __restrict__ xr,
                                      const float* __restrict__ xi,
                                      size_t in, bool second,
                                      float* __restrict__ mr,
                                      float* __restrict__ mi, size_t out,
                                      int q0, const float* __restrict__ wr,
                                      const float* __restrict__ wi,
                                      int log2n, int log2n1, int radix,
                                      float sign, int lc) {
  pass1_from(Pass1In{xr, xi, in, log2n - log2n1, q0, second}, mr, mi, out,
             q0, wr, wi, log2n, log2n1, radix, sign, lc);
}

// Pass 1 of kernel 1 (fft), and of the real product's forward transforms
// (z = a + ib) and the products' inverse off the mirrored split: CTA
// blockIdx.x takes row blockIdx.x / (n2 / c) and c = 2^lc sub-problems.
__global__ void __launch_bounds__(kPassThreads)
fft_pass1_kernel(const float* __restrict__ xr, const float* __restrict__ xi,
                 float* __restrict__ mr, float* __restrict__ mi,
                 const float* __restrict__ wr, const float* __restrict__ wi,
                 int log2n, int log2n1, int radix, int inverse, int lc) {
  size_t row;
  int q0;
  pass_cta(log2n - log2n1, lc, row, q0);
  pass1(xr, xi, row << log2n, true, mr, mi, row << log2n, q0, wr, wi, log2n,
        log2n1, radix, inverse ? 1.f : -1.f, lc);
}

// Pass 1 of kernel 2 (rfft): row pair p = blockIdx.x / (n2 / c) rides
// z = x_2p + i x_2p+1 (0 past an odd batch).
__global__ void __launch_bounds__(kPassThreads)
rfft_pass1_kernel(const float* __restrict__ x, float* __restrict__ mr,
                  float* __restrict__ mi, const float* __restrict__ wr,
                  const float* __restrict__ wi, int batch, int log2n,
                  int log2n1, int radix, int lc) {
  size_t p;
  int q0;
  pass_cta(log2n - log2n1, lc, p, q0);
  // the pair's second row is x + n: pass1 reads it at the same offset
  pass1(x, x + ((size_t)1 << log2n), (2 * p) << log2n,
        2 * p + 1 < (size_t)batch, mr, mi, p << log2n, q0, wr, wi, log2n,
        log2n1, radix, -1.f, lc);
}

// Pass 2's input: element i of the sub-problem in slot s is A[l0 n2 + i]
// (l0 = slots.l0(s)); the first step reads it sub-problem by sub-problem,
// so neighbouring threads read neighbouring elements.
template <class Slots>
struct Pass2In {
  const float* __restrict__ mr;
  const float* __restrict__ mi;
  size_t off;
  int lg2;
  Slots slots;
  __device__ __forceinline__ Cplx load(int s, int i) const {
    const size_t g = off + ((size_t)slots.l0(s) << lg2) + i;
    return Cplx{mr[g], mi[g]};
  }
};

// Pass 2 of a row: the c = 2^lc consecutive sub-problems l0 = l0base + s,
// the sweeps from L = n1 to n, loading the contiguous slices A[l0 n2 ..]
// of the intermediate row at `off` in the first step and handing element k
// of sub-problem l0 (bin l0 + k n1) to `out` in the last. `tw2` is the
// pass-2 twiddle table (planes of n1 (n2 - 1) values).
template <class Out>
__device__ __forceinline__ void pass2(const float* __restrict__ mr,
                                      const float* __restrict__ mi,
                                      size_t off, int l0base, Out out,
                                      const float* __restrict__ tw2,
                                      int log2n, int log2n1, int radix,
                                      float sign, int lc) {
  extern __shared__ __align__(16) float smem[];
  const int lg2 = log2n - log2n1;
  const RunSlots slots{l0base};
  SmemIO a, b;
  sub_buffers(smem, 1 << lc, (1 << lg2) + 1, a, b);
  const int n1 = 1 << log2n1;
  const Subs<Pass2Twiddles<RunSlots>> sp{
      lc, lg2, sign,
      Pass2Twiddles<RunSlots>{tw2, n1 * ((1 << lg2) - 1), n1, slots}, true};
  sub_steps(sp, radix, Pass2In<RunSlots>{mr, mi, off, lg2, slots}, true, out,
            true, a, b);
}

// Pass 2 of kernel 1, and the complex product's last inverse pass: CTA
// blockIdx.x takes row blockIdx.x / (n1 / c) and c = 2^lc sub-problems,
// storing y[l0 + k n1] with its parts scaled by sr and si.
__global__ void __launch_bounds__(kPassThreads)
fft_pass2_kernel(const float* __restrict__ mr, const float* __restrict__ mi,
                 float* __restrict__ yr, float* __restrict__ yi,
                 const float* __restrict__ tw2, int log2n, int log2n1,
                 int radix, int inverse, int lc, float sr, float si) {
  size_t row;
  int l0base;
  pass_cta(log2n1, lc, row, l0base);
  const size_t off = row << log2n;
  pass2(mr, mi, off, l0base, Pass2Out{yr, yi, off, l0base, log2n1, sr, si},
        tw2, log2n, log2n1, radix, inverse ? 1.f : -1.f, lc);
}

// Pass 2 of kernel 2: CTA blockIdx.x takes row pair blockIdx.x / (n1 / 2c)
// and 2c sub-problems -- c low ones and their mirrors (MirrorSlots) -- runs
// the sweeps from L = n1 to n, then, as the epilogue, the Hermitian split
// and the packed-Nyquist store of rfft_kernel: bin k = l0 + n1 l'
// (l' < n2 / 2) of slot s pairs with bin n - k, which lies in the mirror
// slot; Z_{n/2} lies in sub-problem 0 (CTA 0, slot 0) at l' = n2 / 2. Each
// packed bin is written once.
__global__ void __launch_bounds__(kPassThreads)
rfft_pass2_kernel(const float* __restrict__ mr, const float* __restrict__ mi,
                  float* __restrict__ yr, float* __restrict__ yi,
                  const float* __restrict__ tw2, int batch, int log2n,
                  int log2n1, int radix, int lc) {
  extern __shared__ __align__(16) float smem[];
  const int n = 1 << log2n;
  const int nh = n >> 1;
  const int lg2 = log2n - log2n1;
  const int n2 = 1 << lg2;
  const int n1 = 1 << log2n1;
  const int slots = 2 << lc;
  const int glg = log2n1 - 1 - lc;  // CTAs per row pair: n1 / 2c
  const size_t p = blockIdx.x >> glg;
  const MirrorSlots ms{(int)(blockIdx.x & ((1 << glg) - 1)), 1 << lc, n1};
  SmemIO a, b;
  sub_buffers(smem, slots, n2 + 1, a, b);
  const Subs<Pass2Twiddles<MirrorSlots>> sp{
      lc + 1, lg2, -1.f,
      Pass2Twiddles<MirrorSlots>{tw2, n1 * (n2 - 1), n1, ms}, true};
  const SmemIO z = sub_steps(sp, radix,
                             Pass2In<MirrorSlots>{mr, mi, p << log2n, lg2, ms},
                             true, a, false, a, b);
  const size_t r = 2 * p;
  const int ld = z.ld;
  for (int idx = threadIdx.x; idx < (n2 << lc); idx += blockDim.x) {
    const int s = idx & (slots - 1);
    const int lp = idx >> (lc + 1);
    const int k = ms.l0(s) + (lp << log2n1);
    const int mk = (n - k) & (n - 1);
    const int mo = ms.mirror(s) * ld + (mk >> log2n1);
    const float z_r = z.rows.re[s * ld + lp], z_i = z.rows.im[s * ld + lp];
    const float m_r = z.rows.re[mo], m_i = z.rows.im[mo];
    const size_t oa = r * nh + k;
    yr[oa] = 0.5f * (m_r + z_r);
    yi[oa] = k == 0 ? 0.5f * (z.rows.re[n2 >> 1] + z.rows.re[n2 >> 1])
                    : 0.5f * (-m_i + z_i);
    if (r + 1 < (size_t)batch) {
      yr[oa + nh] = 0.5f * (m_i + z_i);
      yi[oa + nh] = k == 0 ? 0.5f * (z.rows.im[n2 >> 1] + z.rows.im[n2 >> 1])
                           : 0.5f * (m_r - z_r);
    }
  }
}

// Kernel 3 -- replaces repro/kernels/fft.py::_irfft_kernel (irfft_planes).
// Inverse of rfft_kernel: the packed-Nyquist half-spectra (n/2 bins) of
// rows (2j, 2j+1) are unpacked to full Hermitian spectra A and B on the
// load (bin k > n/2 is conj P[n-k]; DC and Nyquist have zero imaginary
// parts), and one inverse complex transform of Z = A + iB gives both real
// rows, a = Re z and b = Im z, scaled by 1/n. An odd batch pairs its last
// spectrum with a zero spectrum, whose row is never written back. Bound:
// device-memory bytes (4 bytes in and 4 out per real point). Design: the
// unpacking happens in the load, so the full spectra never reach device
// memory, and two real rows share one complex transform. From
// TWO_PASS_FROM["irfft"] points on the wrapper launches irfft_pass1_kernel
// and irfft_pass2_kernel (below) instead.
__global__ void __launch_bounds__(kMaxThreads)
irfft_kernel(const float* __restrict__ xr, const float* __restrict__ xi,
             float* __restrict__ y, const float* __restrict__ wr,
             const float* __restrict__ wi, float* scratch, int batch,
             int log2n, int radix, int block) {
  extern __shared__ __align__(16) float smem[];
  Rows a, b;
  cta_buffers(smem, scratch, block >> 1, log2n, a, b);
  const int n = 1 << log2n;
  const int nh = n >> 1;
  const int row0 = blockIdx.x * block;
  const int rows = min(block, batch - row0);
  const int pairs = (rows + 1) >> 1;
  for (int k = threadIdx.x; k < (pairs << log2n); k += blockDim.x) {
    const int r = row0 + 2 * (k >> log2n);
    const int kk = k & (n - 1);
    const bool second = r + 1 < batch;
    // Bin kk of a full spectrum from its packed half: (pr[kk], pi[kk])
    // below n/2 (imaginary part 0 at DC), pi[0] at the Nyquist bin, and
    // (pr[n-kk], -pi[n-kk]) above it.
    const int src = kk <= nh ? (kk == nh ? 0 : kk) : n - kk;
    const size_t oa = (size_t)r * nh + src;
    const float par = kk == nh ? xi[oa] : xr[oa];
    const float pbr = second ? (kk == nh ? xi[oa + nh] : xr[oa + nh]) : 0.f;
    const float pai = xi[oa];
    const float pbi = second ? xi[oa + nh] : 0.f;
    const bool real_bin = kk == 0 || kk == nh;
    const float ar = par;
    const float br = pbr;
    const float ai = real_bin ? 0.f : (kk < nh ? pai : -pai);
    const float bi = real_bin ? 0.f : (kk < nh ? pbi : -pbi);
    a.re[k] = ar - bi;
    a.im[k] = ai + br;
  }
  __syncthreads();
  stockham(a, b, pairs, log2n, radix, true, wr, wi);
  const float inv = 1.f / (float)n;
  for (int k = threadIdx.x; k < (pairs << log2n); k += blockDim.x) {
    const int r = row0 + 2 * (k >> log2n);
    const size_t o = ((size_t)r << log2n) + (k & (n - 1));
    y[o] = a.re[k] * inv;
    if (r + 1 < batch) y[o + n] = a.im[k] * inv;
  }
}

// ---------------------------------------------------------------------------
// Kernel 3, two-pass schedule (irfft_planes from TWO_PASS_FROM["irfft"]
// points on, repro_torch/kernels/fft.py: irfft_two_pass_plan): the inverse
// complex transform of Z = A + iB split at L = n1 as the fft's two passes
// are (the section above; the rfft's split, the inverse table). The
// unpacking rides pass 1's load, per bin: element k of sub-problem q0 is
// bin kk = q0 + k n2 of Z, formed from one packed bin of each spectrum (kk
// or n - kk) exactly as irfft_kernel forms it, so no mirror pairing is
// needed and the c consecutive sub-problems of a CTA read c consecutive
// packed bins (downwards for kk > n/2). Pass 2 stores Re z / n to row 2p
// and Im z / n to row 2p + 1 (PairOut, the real product's last store),
// with irfft_kernel's `* inv`, so the result equals the single-CTA kernel
// and irfft_planes_plain bit for bit. Bound: device-memory bytes; device
// memory sees the packed spectra once, the intermediate (one complex row
// per pair) written once and read once, and the real rows once, and each
// pass has B / 2 * n2 / c (or n1 / c) CTAs, where irfft_kernel ran one CTA
// per row pair through a device-memory ping-pong for every sweep from
// n = 16384 on.
// ---------------------------------------------------------------------------

// Pass 1's input of the irfft: element k of sub-problem q0 = q0base + s is
// bin kk = q0 + k n2 of Z = A + iB for the packed spectra of rows 2p (at
// `off`) and 2p + 1 (at off + n/2; zeros past an odd batch).
struct IrfftIn {
  const float* __restrict__ xr;
  const float* __restrict__ xi;
  size_t off;
  int lg2;
  int q0;
  int log2n;
  bool second;
  __device__ __forceinline__ Cplx load(int s, int k) const {
    const int n = 1 << log2n;
    const int nh = n >> 1;
    const int kk = (k << lg2) + q0 + s;
    const int src = kk <= nh ? (kk == nh ? 0 : kk) : n - kk;
    const size_t oa = off + src;
    const float par = kk == nh ? xi[oa] : xr[oa];
    const float pbr = second ? (kk == nh ? xi[oa + nh] : xr[oa + nh]) : 0.f;
    const float pai = xi[oa];
    const float pbi = second ? xi[oa + nh] : 0.f;
    const bool real_bin = kk == 0 || kk == nh;
    const float ai = real_bin ? 0.f : (kk < nh ? pai : -pai);
    const float bi = real_bin ? 0.f : (kk < nh ? pbi : -pbi);
    return Cplx{par - bi, ai + pbr};
  }
};

// Pass 1 of kernel 3: row pair p = blockIdx.x / (n2 / c) and c = 2^lc
// sub-problems, the inverse sweeps from L = 1 to n1 (inverse table),
// into intermediate row p.
__global__ void __launch_bounds__(kPassThreads)
irfft_pass1_kernel(const float* __restrict__ xr, const float* __restrict__ xi,
                   float* __restrict__ mr, float* __restrict__ mi,
                   const float* __restrict__ wr, const float* __restrict__ wi,
                   int batch, int log2n, int log2n1, int radix, int lc) {
  size_t p;
  int q0;
  const int lg2 = log2n - log2n1;
  pass_cta(lg2, lc, p, q0);
  pass1_from(IrfftIn{xr, xi, p << log2n, lg2, q0, log2n,
                     2 * p + 1 < (size_t)batch},
             mr, mi, p << log2n, q0, wr, wi, log2n, log2n1, radix, 1.f, lc);
}

// Kernel 5 -- replaces repro/kernels/polymul.py::_polymul_complex_kernel
// (polymul_complex_planes). Circular product mod x^n - 1 of complex rows:
// both forward transforms in one batched pass over 2*rows rows, the
// pointwise product, and the inverse as conj(FFT(conj P))/n with the
// forward table, all in one residency. Bound: device-memory bytes (16 bytes
// in, 8 out per point). Design: the two spectra and the product never
// leave the CTA while the pair of rows fits shared memory (n <= 4096),
// where the three-call library composite writes and reads every
// intermediate spectrum through device memory. From 8192 points on the
// wrapper launches the split-pass schedule instead (polymul_pass1_kernel,
// polymul_complex_mid_kernel, fft_pass2_kernel, below).
__global__ void __launch_bounds__(kMaxThreads)
polymul_complex_kernel(const float* __restrict__ ar,
                       const float* __restrict__ ai,
                       const float* __restrict__ br,
                       const float* __restrict__ bi, float* __restrict__ cr,
                       float* __restrict__ ci, const float* __restrict__ wr,
                       const float* __restrict__ wi, float* scratch, int batch,
                       int log2n, int radix, int block) {
  extern __shared__ __align__(16) float smem[];
  Rows a, b;
  cta_buffers(smem, scratch, 2 * block, log2n, a, b);
  const int row0 = blockIdx.x * block;
  const int rows = min(block, batch - row0);
  const size_t off = (size_t)row0 << log2n;
  const int count = rows << log2n;
  for (int k = threadIdx.x; k < count; k += blockDim.x) {
    a.re[k] = ar[off + k];
    a.im[k] = ai[off + k];
    a.re[count + k] = br[off + k];
    a.im[count + k] = bi[off + k];
  }
  __syncthreads();
  stockham(a, b, 2 * rows, log2n, radix, false, wr, wi);
  for (int k = threadIdx.x; k < count; k += blockDim.x) {
    const float far = a.re[k], fai = a.im[k];
    const float fbr = a.re[count + k], fbi = a.im[count + k];
    a.re[k] = far * fbr - fai * fbi;
    a.im[k] = -(far * fbi + fai * fbr);
  }
  __syncthreads();
  stockham(a, b, rows, log2n, radix, false, wr, wi);
  const float inv = 1.f / (float)(1 << log2n);
  for (int k = threadIdx.x; k < count; k += blockDim.x) {
    cr[off + k] = a.re[k] * inv;
    ci[off + k] = -a.im[k] * inv;
  }
}

// Kernel 4 -- replaces repro/kernels/polymul.py::_polymul_real_kernel
// (polymul_real_planes). Circular product of real rows with one forward
// transform per product (z = a + ib, Hermitian split, P = A B) and one
// inverse per PAIR of products: Q = P_2j + i P_2j+1, c_2j = Re IFFT(Q),
// c_2j+1 = Im IFFT(Q), which is valid because each P is exactly Hermitian.
// An odd batch pairs its last product with a zero row. Bound: device-memory
// bytes (8 bytes in, 4 out per point). Design: 1.5 transforms per product
// instead of 3, all in one residency while a row pair fits shared memory
// (n < 4096); from 4096 points on the wrapper launches the split-pass
// schedule (fft_pass1_kernel, polymul_real_mid_kernel,
// polymul_real_pass2_kernel, below), and rows past its splits take the
// device-memory scratch.
__global__ void __launch_bounds__(kMaxThreads)
polymul_real_kernel(const float* __restrict__ a_in,
                    const float* __restrict__ b_in, float* __restrict__ c,
                    const float* __restrict__ wr, const float* __restrict__ wi,
                    const float* __restrict__ wir,
                    const float* __restrict__ wii, float* scratch, int batch,
                    int log2n, int radix, int block) {
  extern __shared__ __align__(16) float smem[];
  Rows a, b;
  cta_buffers(smem, scratch, block, log2n, a, b);
  const int n = 1 << log2n;
  const int row0 = blockIdx.x * block;
  const int rows = min(block, batch - row0);
  const int pairs = (rows + 1) >> 1;
  const size_t off = (size_t)row0 << log2n;
  const int zcount = (2 * pairs) << log2n;
  for (int k = threadIdx.x; k < zcount; k += blockDim.x) {
    const bool valid = row0 + (k >> log2n) < batch;
    a.re[k] = valid ? a_in[off + k] : 0.f;
    a.im[k] = valid ? b_in[off + k] : 0.f;
  }
  __syncthreads();
  stockham(a, b, 2 * pairs, log2n, radix, false, wr, wi);
  // Hermitian split of every z row and the pointwise product, into b.
  for (int k = threadIdx.x; k < zcount; k += blockDim.x) {
    const size_t base = (size_t)(k >> log2n) << log2n;
    const int kk = k & (n - 1);
    const int m = (n - kk) & (n - 1);
    const float z_r = a.re[base + kk], z_i = a.im[base + kk];
    const float m_r = a.re[base + m], m_i = a.im[base + m];
    const float far = 0.5f * (m_r + z_r);
    const float fai = 0.5f * (-m_i + z_i);
    const float fbr = 0.5f * (m_i + z_i);
    const float fbi = 0.5f * (m_r - z_r);
    b.re[k] = far * fbr - fai * fbi;
    b.im[k] = far * fbi + fai * fbr;
  }
  __syncthreads();
  // Pair the products: Q_j = P_2j + i P_2j+1, into a.
  const int qcount = pairs << log2n;
  for (int k = threadIdx.x; k < qcount; k += blockDim.x) {
    const size_t e = ((size_t)(k >> log2n) << (log2n + 1)) + (k & (n - 1));
    a.re[k] = b.re[e] - b.im[e + n];
    a.im[k] = b.im[e] + b.re[e + n];
  }
  __syncthreads();
  stockham(a, b, pairs, log2n, radix, true, wir, wii);
  const float inv = 1.f / (float)n;
  for (int k = threadIdx.x; k < qcount; k += blockDim.x) {
    const int r = row0 + 2 * (k >> log2n);
    const size_t o = ((size_t)r << log2n) + (k & (n - 1));
    c[o] = a.re[k] * inv;
    if (r + 1 < batch) c[o + n] = a.im[k] * inv;
  }
}

// ---------------------------------------------------------------------------
// Kernels 5 and 4, split-pass schedule (polymul_complex_planes and
// polymul_real_planes from TWO_PASS_FROM points on,
// repro_torch/kernels/polymul.py).
//
// The forward transforms split at L = n1 as the fft's two passes do (the
// section above). Launch F1 runs their pass 1. Launch M runs their pass 2
// for a CTA's sub-problems l0 -- of a and of b (kernel 5), or of rows 2j
// and 2j+1, each beside its mirror (kernel 4: the Hermitian split pairs bin
// k with bin n - k, which lies in sub-problem (n1 - l0) mod n1,
// MirrorSlots) -- and forms the product in shared memory: kernel 5's
// (P.re, -P.im) for conj(FFT(conj P)), kernel 4's Q = P_2j + i P_2j+1.
// Forward pass 2's sub-problem l0 holds the bins l0 + k n1 in order k:
// exactly the inputs of sub-problem q0 = l0 of pass 1 of the split
// (n2, n1). So where that mirrored split is on the sweep sequence too --
// radix 2 always, radix 4 at even log2 n (n = 65536: 256 x 256) -- M goes
// on, without leaving the CTA, to the inverse's pass 1 (kernel 5 with the
// forward table, kernel 4 with the inverse table) and stores only its
// result (`fused`); launch I2 is the inverse's pass 2 (split n2 x n1, its
// own pass-2 table), storing kernel 5's conj(.)/n or kernel 4's
// c_2j = Re / n, c_2j+1 = Im / n: three launches. At odd log2 n and radix
// 4 (n = 8192: 128 x 64; n = 2^17: 512 x 256) the mirrored split is off
// the sequence: M stores P (Q) in natural order and the inverse runs as
// the fft's two passes split n1 x n2 (fft_pass1_kernel, then I2): four
// launches. Every operation is the plain version's, in its order, on the
// master tables' own fp32 values, so the result equals it bit for bit.
//
// Kernel 4's M binds the real product: at n = 16384 it moves 201 MB a request
// of 1024 products (Z in, the inverse's intermediate out; 0.060 ms at 3.35
// TB/s), and as first built it took 0.207 ms, F1 0.110 and I2 0.072 (NVIDIA
// H100 80GB HBM3, 700 W). Its loads do not bind it: more resident CTAs of
// fewer sub-problems were slower (c = 2: 0.261 ms; c = 1: 0.418), an M with
// no device-memory reads at all took 0.212, and a persistent M whose bulk
// copies loaded the next item while the current one swept was no faster than
// one CTA an item. Its instruction stream does: its index arithmetic ran about
// two integer instructions to each fp32 one, on the half-rate integer pipe,
// and every shared-memory access was a generic 64-bit one. So M's buffers
// hold interleaved complex values (one 64-bit access where split planes take
// two) at 32-bit shared offsets, the inverse's pass-1 twiddles come from a
// gathered table of interleaved values, and the planner's fused radix-4
// shapes are compiled with their sizes as constants, so that the steps' index
// arithmetic folds: 0.186 ms, 3.1 times its bytes' bound (3.4 before).
//
// Bound: device-memory bytes, 8 per complex point moved. Fused, kernel 5
// moves 72 bytes per point (F1: a and b in, both spectra out; M: the
// spectra in, the inverse's intermediate out; I2: it in, c out) against
// the 24 its inputs and output need, kernel 4 36 per real point against
// 12. Every launch spreads a row over n2 / c1, n1 / cm and n2 / ci CTAs,
// where the single-CTA kernels staged one row per CTA through a
// device-memory ping-pong for every sweep.
// ---------------------------------------------------------------------------

// Slots of a CTA that holds the same sub-problems of two rows: slots
// [0, 2^lper) the first row's, the rest the second's, slot s holding
// sub-problem inner.l0(s mod 2^lper).
template <class Slots>
struct RowSlots {
  Slots inner;
  int lper;
  __device__ __forceinline__ int l0(int s) const {
    return inner.l0(s & ((1 << lper) - 1));
  }
};

// M's input: element i of the sub-problem in slot s is A[l0 n2 + i] of the
// intermediate row at off0 (the first 2^lper slots) or off1; zeros for a
// second row past the batch (the zero row an odd batch pairs its last
// product with).
template <class Slots>
struct RowsIn {
  const float* __restrict__ mr;
  const float* __restrict__ mi;
  size_t off0;
  size_t off1;
  bool has1;
  int lg2;
  RowSlots<Slots> slots;
  __device__ __forceinline__ Cplx load(int s, int i) const {
    const bool one = (s >> slots.lper) != 0;
    if (one && !has1) return Cplx{0.f, 0.f};
    const size_t g = (one ? off1 : off0) + ((size_t)slots.l0(s) << lg2) + i;
    return Cplx{mr[g], mi[g]};
  }
};

// M's forward half: pass 2 of the forward transforms (forward pass-2 table
// `tw2`) for the CTA's 2^lslots sub-problems, ending in shared memory.
// Returns the buffer that holds the spectra (slot s, element k: bin
// l0(s) + k n1) and sets `spare` to the other one.
template <class Slots>
__device__ __forceinline__ SmemIO mid_forward(RowsIn<Slots> in, int lslots,
                                              const float* __restrict__ tw2,
                                              int log2n, int log2n1,
                                              int radix, SmemIO& spare) {
  extern __shared__ __align__(16) float smem[];
  const int lg2 = log2n - log2n1;
  const int n1 = 1 << log2n1;
  SmemIO a, b;
  sub_buffers(smem, 1 << lslots, (1 << lg2) + 1, a, b);
  const Subs<Pass2Twiddles<RowSlots<Slots>>> sp{
      lslots, lg2, -1.f,
      Pass2Twiddles<RowSlots<Slots>>{tw2, n1 * ((1 << lg2) - 1), n1,
                                     in.slots},
      true};
  const SmemIO z = sub_steps(sp, radix, in, true, a, false, a, b);
  spare = z.rows.re == a.rows.re ? b : a;
  return z;
}

// M's fused tail: pass 1 of the inverse, split n2 x n1 (twiddles of the
// table (wr, wi) at stride n1), on the 2^lslots sub-problems
// q0 = slots.l0(s) held in `q`, storing A'[l n1 + q0] of the row at `off`;
// `spare` is the other shared buffer.
template <class Slots>
__device__ __forceinline__ void mid_inverse(SmemIO q, SmemIO spare,
                                            int lslots, Slots slots,
                                            float* __restrict__ qr,
                                            float* __restrict__ qi,
                                            size_t off,
                                            const float* __restrict__ wr,
                                            const float* __restrict__ wi,
                                            float sign, int log2n,
                                            int log2n1, int radix) {
  const Subs<Pass1Twiddles> sp{lslots, log2n - log2n1, sign,
                               Pass1Twiddles{wr, wi, 1 << log2n1}, false};
  sub_steps(sp, radix, q, false, Pass1Out<Slots>{qr, qi, off, log2n1, slots},
            true, q, spare);
}

// F1 of kernel 5: pass 1 of both forward transforms, CTA rows r < batch
// from a and the rest from b (row r - batch), into intermediate row r.
__global__ void __launch_bounds__(kPassThreads)
polymul_pass1_kernel(const float* __restrict__ ar,
                     const float* __restrict__ ai,
                     const float* __restrict__ br,
                     const float* __restrict__ bi, float* __restrict__ mr,
                     float* __restrict__ mi, const float* __restrict__ wr,
                     const float* __restrict__ wi, int batch, int log2n,
                     int log2n1, int radix, int lc) {
  size_t r;
  int q0;
  pass_cta(log2n - log2n1, lc, r, q0);
  const bool of_b = r >= (size_t)batch;
  pass1(of_b ? br : ar, of_b ? bi : ai, (of_b ? r - batch : r) << log2n,
        true, mr, mi, r << log2n, q0, wr, wi, log2n, log2n1, radix, -1.f,
        lc);
}

// M of kernel 5: CTA blockIdx.x takes row blockIdx.x / (n1 / c) and its
// c = 2^lc consecutive sub-problems l0 of a (slots s < c, intermediate row
// `row`) and of b (slots c + s, row batch + row); the pointwise product
// (P.re, -P.im) in place of a's spectra; then, `fused`, the inverse's pass
// 1 into (pr, pi), else P stored there in natural order.
__global__ void __launch_bounds__(kPassThreads)
polymul_complex_mid_kernel(const float* __restrict__ mr,
                           const float* __restrict__ mi,
                           float* __restrict__ pr, float* __restrict__ pi,
                           const float* __restrict__ tw2,
                           const float* __restrict__ wr,
                           const float* __restrict__ wi, int batch,
                           int log2n, int log2n1, int radix, int lc,
                           int fused) {
  const int lg2 = log2n - log2n1;
  size_t row;
  int l0base;
  pass_cta(log2n1, lc, row, l0base);
  const size_t off = row << log2n;
  const RowSlots<RunSlots> slots{RunSlots{l0base}, lc};
  SmemIO spare;
  const SmemIO z = mid_forward(
      RowsIn<RunSlots>{mr, mi, off, ((size_t)batch + row) << log2n, true,
                       lg2, slots},
      lc + 1, tw2, log2n, log2n1, radix, spare);
  const int c = 1 << lc;
  for (int idx = threadIdx.x; idx < (c << lg2); idx += blockDim.x) {
    const int s = idx & (c - 1);
    const int k = idx >> lc;
    const Cplx fa = z.load(s, k), fb = z.load(c + s, k);
    Cplx p;
    cmul(fa.r, fa.i, fb.r, fb.i, p.r, p.i);
    if (fused) {
      z.store(s, k, Cplx{p.r, -p.i});
    } else {
      const size_t g = off + l0base + s + ((size_t)k << log2n1);
      pr[g] = p.r;
      pi[g] = -p.i;
    }
  }
  if (!fused) return;
  __syncthreads();
  mid_inverse(z, spare, lc, RunSlots{l0base}, pr, pi, off, wr, wi, -1.f,
              log2n, log2n1, radix);
}

// ---------------------------------------------------------------------------
// M of kernel 4 (why it is built so: the split-pass section above).
// ---------------------------------------------------------------------------

// M's two shared buffers: the CTA's dynamic shared memory, addressed by
// offsets from it, so that every access is a 32-bit shared one.
extern __shared__ __align__(16) float2 mid_shared[];

// Element p of slot s as one interleaved complex value at row stride ld,
// from complex value `base` of mid_shared on: one 64-bit access where
// SmemIO's split planes take two.
struct SmemIO2 {
  int base;
  int ld;
  __device__ __forceinline__ Cplx load(int s, int p) const {
    const float2 x = mid_shared[base + s * ld + p];
    return Cplx{x.x, x.y};
  }
  __device__ __forceinline__ void store(int s, int p, Cplx c) const {
    mid_shared[base + s * ld + p] = make_float2(c.r, c.i);
  }
};

// Row stride of M's buffers, in complex values: n2 = 2^lm and 2, the
// stride at which the steps' and the product's 64-bit accesses at n2 = 256
// meet the fewest bank conflicts.
__host__ __device__ __forceinline__ int mid_ld(int lm) {
  return (1 << lm) + 2;
}

// The inverse's pass-1 twiddles (Pass1Twiddles at stride n1) from the
// wrapper's gathered table: entry m is W[m n1] of the inverse table, as one
// complex value.
struct StrideTwiddles {
  const float2* __restrict__ w;
  __device__ __forceinline__ Cplx operator()(int, int l, int, int qr,
                                             int j) const {
    const float2 v = w[l * (j * qr)];
    return Cplx{v.x, v.y};
  }
};

// (log2 n2, radix, log2 cm) of every split the planner gives the real
// product at radix 4, the radix core/fft/planner.py plans for it
// (kernels/polymul.py: product_two_pass_plan, 4096 to 2^23 points); each
// is fused at even log2 n and not at odd.
#define MID_SHAPES(X) X(6, 4, 2) X(8, 4, 2) X(10, 4, 0)

// M of kernel 4: CTA blockIdx.x takes row pair p = blockIdx.x / (n1 / 2c)
// and 2c sub-problems of each row -- c low ones and their mirrors
// (MirrorSlots) -- rows 2p in slots [0, 2c), 2p + 1 in [2c, 4c); the
// Hermitian split and the product of each row, exactly as
// polymul_real_kernel computes them, and Q = P_2p + i P_2p+1 for the low and
// the mirror sub-problems alike (each is an inverse sub-problem); then,
// `fused`, the inverse's pass 1 (the gathered inverse twiddles `twi`) into
// (qr, qi), else Q stored there in natural order.
__device__ __forceinline__ void mid_item(
    const float* __restrict__ mr, const float* __restrict__ mi,
    float* __restrict__ qr, float* __restrict__ qi,
    const float* __restrict__ tw2, const float2* __restrict__ twi,
    int batch, int log2n, int lg2, int radix, int lc, int fused) {
  const int n = 1 << log2n;
  const int log2n1 = log2n - lg2;
  const int n1 = 1 << log2n1;
  const int held = 2 << lc;  // a row's sub-problems: c low, c mirrors
  const int glg = log2n1 - 1 - lc;  // CTAs per row pair: n1 / 2c
  const size_t p = blockIdx.x >> glg;
  const MirrorSlots ms{(int)(blockIdx.x & ((1 << glg) - 1)), 1 << lc, n1};
  const RowSlots<MirrorSlots> slots{ms, lc + 1};
  const SmemIO2 a{0, mid_ld(lg2)};
  const SmemIO2 b{2 * held * mid_ld(lg2), mid_ld(lg2)};
  const Subs<Pass2Twiddles<RowSlots<MirrorSlots>>> sp{
      lc + 2, lg2, -1.f,
      Pass2Twiddles<RowSlots<MirrorSlots>>{tw2, n1 * ((1 << lg2) - 1), n1,
                                           slots},
      true};
  const SmemIO2 z = sub_steps(
      sp, radix,
      RowsIn<MirrorSlots>{mr, mi, (2 * p) << log2n, (2 * p + 1) << log2n,
                          2 * p + 1 < (size_t)batch, lg2, slots},
      true, a, false, a, b);
  const SmemIO2 spare = z.base == a.base ? b : a;
  const size_t off = p << log2n;
  for (int idx = threadIdx.x; idx < (held << lg2); idx += blockDim.x) {
    const int s = idx & (held - 1);
    const int lp = idx >> (lc + 1);
    const int k = ms.l0(s) + (lp << log2n1);
    const int mk = (n - k) & (n - 1);
    const int mslot = ms.mirror(s), mel = mk >> log2n1;
    Cplx prod[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const Cplx zk = z.load(r * held + s, lp);
      const Cplx zm = z.load(r * held + mslot, mel);
      const float far = 0.5f * (zm.r + zk.r);
      const float fai = 0.5f * (-zm.i + zk.i);
      const float fbr = 0.5f * (zm.i + zk.i);
      const float fbi = 0.5f * (zm.r - zk.r);
      cmul(far, fai, fbr, fbi, prod[r].r, prod[r].i);
    }
    const Cplx q{prod[0].r - prod[1].i, prod[0].i + prod[1].r};
    if (fused) {
      spare.store(s, lp, q);
    } else {
      qr[off + k] = q.r;
      qi[off + k] = q.i;
    }
  }
  if (!fused) return;
  __syncthreads();
  sub_steps(Subs<StrideTwiddles>{lc + 1, lg2, 1.f, StrideTwiddles{twi},
                                 false},
            radix, spare, false, Pass1Out<MirrorSlots>{qr, qi, off, log2n1, ms},
            true, spare, z);
}

__global__ void __launch_bounds__(kPassThreads)
polymul_real_mid_kernel(const float* __restrict__ mr,
                        const float* __restrict__ mi,
                        float* __restrict__ qr, float* __restrict__ qi,
                        const float* __restrict__ tw2,
                        const float2* __restrict__ twi, int batch, int log2n,
                        int log2n1, int radix, int lc, int fused) {
  const int lg2 = log2n - log2n1;
  // the planner's fused radix-4 shapes with their sizes as constants, so
  // that the steps' index arithmetic folds; any other split with them at
  // run time (unfused, the constants made M slower: 0.0093 ms against 0.0081
  // at n = 8192, batch 64, on an H100)
#define MID_SHAPE(LG2, RADIX, LC)                                          \
  if (fused && lg2 == LG2 && radix == RADIX && lc == LC) {                \
    mid_item(mr, mi, qr, qi, tw2, twi, batch, log2n, LG2, RADIX, LC,      \
             fused);                                                      \
    return;                                                               \
  }
  MID_SHAPES(MID_SHAPE)
#undef MID_SHAPE
  mid_item(mr, mi, qr, qi, tw2, twi, batch, log2n, lg2, radix, lc, fused);
}

// Kernel 4's output of the inverse's last pass: element k of sub-problem
// l0 = l0base + s is c_2p[l0 + k n1] = Re / n and, within the batch,
// c_2p+1[l0 + k n1] = Im / n.
struct PairOut {
  float* __restrict__ c;
  size_t off;  // row 2p
  int n;
  bool second;
  int l0base;
  int lg1;
  float inv;
  __device__ __forceinline__ void store(int s, int k, Cplx v) const {
    const size_t g = off + l0base + s + ((size_t)k << lg1);
    c[g] = v.r * inv;
    if (second) c[g + n] = v.i * inv;
  }
};

// Pass 2 of an inverse transform (inverse pass-2 table, split
// 2^log2n1 x n / 2^log2n1) of row pair p = blockIdx.x / (n1 / c), stored as
// two real rows (PairOut).
__device__ __forceinline__ void pair_pass2(const float* __restrict__ mr,
                                           const float* __restrict__ mi,
                                           float* __restrict__ c,
                                           const float* __restrict__ tw2,
                                           int batch, int log2n, int log2n1,
                                           int radix, int lc) {
  size_t p;
  int l0base;
  pass_cta(log2n1, lc, p, l0base);
  pass2(mr, mi, p << log2n, l0base,
        PairOut{c, (2 * p) << log2n, 1 << log2n, 2 * p + 1 < (size_t)batch,
                l0base, log2n1, 1.f / (float)(1 << log2n)},
        tw2, log2n, log2n1, radix, 1.f, lc);
}

// I2 of kernel 4: the inverse's pass 2, c_2p = Re / n, c_2p+1 = Im / n.
__global__ void __launch_bounds__(kPassThreads)
polymul_real_pass2_kernel(const float* __restrict__ mr,
                          const float* __restrict__ mi, float* __restrict__ c,
                          const float* __restrict__ tw2, int batch, int log2n,
                          int log2n1, int radix, int lc) {
  pair_pass2(mr, mi, c, tw2, batch, log2n, log2n1, radix, lc);
}

// Pass 2 of kernel 3: the inverse sweeps from L = n1 to n, y_2p = Re z / n
// and y_2p+1 = Im z / n (the second store skipped past an odd batch).
__global__ void __launch_bounds__(kPassThreads)
irfft_pass2_kernel(const float* __restrict__ mr, const float* __restrict__ mi,
                   float* __restrict__ y, const float* __restrict__ tw2,
                   int batch, int log2n, int log2n1, int radix, int lc) {
  pair_pass2(mr, mi, y, tw2, batch, log2n, log2n1, radix, lc);
}

// Threads for a CTA that transforms `slots` complex rows: one per radix-4
// butterfly of a sweep, at least a warp, at most 1024.
int threads_for(int slots, int log2n) {
  const long work = ((long)slots << log2n) >> 2;
  return work < 32 ? 32 : (work > kMaxThreads ? kMaxThreads : (int)work);
}

bool bad_args(int batch, int log2n, int radix, int block) {
  return batch < 0 || log2n < 0 || log2n > 28 || block < 1 ||
         (radix != 2 && radix != 4);
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

// Dynamic shared memory for `slots` complex rows in two buffers, 0 for the
// device-memory scratch path. Opts the kernel in above 48 KB.
template <typename Kernel>
cudaError_t smem_for(Kernel kernel, bool staged, int slots, int log2n,
                     size_t* bytes) {
  *bytes = staged ? 0 : 4 * ((size_t)slots << log2n) * sizeof(float);
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
      staged ? 0 : 4 * ((size_t)slots << log2n) * sizeof(float);
  return launch_occupancy(kernel, threads_for(slots, log2n), bytes, threads,
                          smem, regs, ctas);
}

// Threads of a pass CTA for `slots` sub-problems of 2^lm points: one per
// work item of a step (max(1, 2^lm / 16) per sub-problem), at least a
// warp.
int pass_threads(int slots, int lm) {
  const long t = (long)slots << (lm >= 4 ? lm - 4 : 0);
  return t < 32 ? 32 : (t > kPassThreads ? kPassThreads : (int)t);
}

// Steps of sub_steps' schedule for a sub-problem of 2^lm points.
int pass_steps(int lm, int radix) {
  int steps = 0;
  for (int L = 1, lr = lm; lr > 0; ++steps) {
    const int lg = (radix == 2 || (L == 1 && (lm & 1))) ? 1
                   : lr >= 4                           ? 4
                                                       : 2;
    L <<= lg;
    lr -= lg;
  }
  return steps;
}

// Dynamic shared memory of a pass CTA holding `slots` sub-problems of 2^lm
// points at row stride 2^lm + 1: one buffer of split planes for every
// state the schedule keeps in shared memory (the copied-in slices unless
// the first step reads device memory, and every step's output but a last
// one written to device memory), two at most (ping-pong).
size_t pass_smem(int slots, int lm, int radix, bool from_global,
                 bool to_global) {
  const int states = (from_global ? 0 : 1) + pass_steps(lm, radix) -
                     (to_global ? 1 : 0);
  const int buffers = states < 1 ? 1 : (states > 2 ? 2 : states);
  return (size_t)buffers * 2 * slots * (((size_t)1 << lm) + 1) *
         sizeof(float);
}

// The launch configuration of a pass kernel for `slots` sub-problems of
// 2^lm points, as the two-pass launchers below make it.
template <typename Kernel>
cudaError_t pass_occupancy(Kernel kernel, int slots, int lm, int radix,
                           bool from_global, bool to_global, int* threads,
                           int* smem, int* regs, int* ctas) {
  return launch_occupancy(kernel, pass_threads(slots, lm),
                          pass_smem(slots, lm, radix, from_global, to_global),
                          threads, smem, regs, ctas);
}

// A two-pass split the kernels take: n1 = 2^log2n1 and n2 both at least 2,
// pass 1's c1 = 2^lc1 sub-problems per CTA at most n2, pass 2's c2 = 2^lc2
// at most n1 (n1 / 2 for the rfft, whose CTA holds 2 c2), radix 4 with an
// even log2 n2, each pass's shared memory within the card's 227 KB, and
// each grid within 2^31 - 1 CTAs.
bool bad_split(int batch, int log2n, int log2n1, int radix, int lc1, int lc2,
               bool real) {
  const int lg2 = log2n - log2n1;
  if (log2n1 < 1 || lg2 < 1 || lc1 < 0 || lc2 < 0 || lc1 > lg2 ||
      lc2 + (real ? 1 : 0) > log2n1 || (radix == 4 && (lg2 & 1))) {
    return true;
  }
  const long rows = real ? (batch + 1L) / 2 : batch;
  const int slots2 = real ? 2 << lc2 : 1 << lc2;
  return pass_smem(1 << lc1, log2n1, radix, true, true) > kMaxSmemBytes ||
         pass_smem(slots2, lg2, radix, true, !real) > kMaxSmemBytes ||
         (rows << (lg2 - lc1)) > 0x7fffffffL ||
         (rows << (log2n1 - lc2)) > 0x7fffffffL;
}

// Whether a product's inverse splits n2 x n1 (the mirrored split on the
// sweep sequence: radix 2, radix 4 at even log2 n), so M runs its pass 1.
bool product_fused(int log2n, int radix) {
  return radix == 2 || !(log2n & 1);
}

// Dynamic shared memory of a product's M: two buffers of split planes for
// `slots` sub-problems of 2^lm points at row stride 2^lm + 1 (the product,
// Q and the inverse's pass 1 use both).
size_t mid_smem(int slots, int lm) {
  return (size_t)2 * 2 * slots * (((size_t)1 << lm) + 1) * sizeof(float);
}

// Dynamic shared memory of the real product's M: two buffers of
// interleaved complex values for `slots` sub-problems of 2^lm points at row
// stride mid_ld(lm).
size_t real_mid_smem(int slots, int lm) {
  return (size_t)2 * slots * mid_ld(lm) * sizeof(float2);
}

// A split-pass launch the products take: n1 = 2^log2n1 and n2 at least 2;
// F1's c1 = 2^lc1 sub-problems per CTA at most n2; M's cm = 2^lcm low ones
// at most n1 (n1 / 2 for kernel 4, `held` = 4 sub-problems per low one,
// against kernel 5's 2); the inverse's last pass's ci = 2^lci at most its
// sub-problem count; at radix 4 every pass-2 sub-problem of even log2;
// each launch's shared memory within the card's 227 KB; each grid within
// 2^31 - 1 CTAs. `rows`: F1's rows (2 B, or B); `rows_m`: the rows of M
// and of the inverse (B, or (B + 1) / 2).
bool bad_product_split(long rows, long rows_m, int log2n, int log2n1,
                       int radix, int lc1, int lcm, int lci, int held) {
  const int lg2 = log2n - log2n1;
  const int li1 = product_fused(log2n, radix) ? lg2 : log2n1;
  const int li2 = log2n - li1;
  const int lpair = held == 4 ? 1 : 0;  // M's CTAs per row: n1 / 2^lpair cm
  if (log2n1 < 1 || lg2 < 1 || lc1 < 0 || lcm < 0 || lci < 0 || lc1 > lg2 ||
      lcm + lpair > log2n1 || lci > li1 ||
      (radix == 4 && ((lg2 & 1) || (li2 & 1)))) {
    return true;
  }
  return pass_smem(1 << lc1, log2n1, radix, true, true) > kMaxSmemBytes ||
         (held == 4 ? real_mid_smem(4 << lcm, lg2)
                    : mid_smem(2 << lcm, lg2)) > kMaxSmemBytes ||
         pass_smem(1 << lci, li2, radix, true, true) > kMaxSmemBytes ||
         (rows << (lg2 - lc1)) > 0x7fffffffL ||
         (rows_m << (log2n1 - lpair - lcm)) > 0x7fffffffL ||
         (rows_m << (li1 - lci)) > 0x7fffffffL;
}

}  // namespace

extern "C" {

const char* stockham_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

// log2n1 > 0: the two-pass schedule, `scratch` the intermediate (two planes
// of batch * n floats), `tw2` the pass-2 twiddle table (two planes of
// n1 (n2 - 1) floats) and `block` unused; both passes are launched on
// `stream`, each checked. log2n1 == 0: one CTA per `block` rows, `tw2`
// unused.
int stockham_fft(const float* xr, const float* xi, float* yr, float* yi,
                 const float* wr, const float* wi, float* scratch,
                 const float* tw2, int batch, int log2n, int radix,
                 int inverse, int block, int log2n1, int lc1, int lc2,
                 void* stream) {
  if (bad_args(batch, log2n, radix, block)) return cudaErrorInvalidValue;
  if (log2n1 != 0 &&
      (scratch == nullptr || tw2 == nullptr ||
       bad_split(batch, log2n, log2n1, radix, lc1, lc2, false))) {
    return cudaErrorInvalidValue;
  }
  if (batch == 0) return cudaSuccess;
  if (log2n1 != 0) {
    const cudaStream_t st = (cudaStream_t)stream;
    const int lg2 = log2n - log2n1;
    float* mr = scratch;
    float* mi = scratch + ((size_t)batch << log2n);
    size_t smem = pass_smem(1 << lc1, log2n1, radix, true, true);
    cudaError_t err = opt_in(fft_pass1_kernel, smem);
    if (err != cudaSuccess) return err;
    fft_pass1_kernel<<<batch << (lg2 - lc1), pass_threads(1 << lc1, log2n1),
                       smem, st>>>(xr, xi, mr, mi, wr, wi, log2n, log2n1,
                                   radix, inverse, lc1);
    err = cudaGetLastError();
    if (err != cudaSuccess) return err;
    smem = pass_smem(1 << lc2, lg2, radix, true, true);
    err = opt_in(fft_pass2_kernel, smem);
    if (err != cudaSuccess) return err;
    const float scale = inverse ? 1.f / (float)(1 << log2n) : 1.f;
    fft_pass2_kernel<<<batch << (log2n1 - lc2), pass_threads(1 << lc2, lg2),
                       smem, st>>>(mr, mi, yr, yi, tw2, log2n, log2n1, radix,
                                   inverse, lc2, scale, scale);
    return cudaGetLastError();
  }
  size_t smem;
  cudaError_t err =
      smem_for(fft_kernel, scratch != nullptr, block, log2n, &smem);
  if (err != cudaSuccess) return err;
  const int grid = (batch + block - 1) / block;
  fft_kernel<<<grid, threads_for(block, log2n), smem,
               (cudaStream_t)stream>>>(xr, xi, yr, yi, wr, wi, scratch,
                                       batch, log2n, radix, inverse, block);
  return cudaGetLastError();
}

// log2n1 > 0: the two-pass schedule, `scratch` the intermediate (two planes
// of (batch + 1) / 2 * n floats), `tw2` the pass-2 twiddle table, `block`
// unused; else one CTA per `block` rows (even), `tw2` unused.
int stockham_rfft(const float* x, float* yr, float* yi, const float* wr,
                  const float* wi, float* scratch, const float* tw2,
                  int batch, int log2n, int radix, int block, int log2n1,
                  int lc1, int lc2, void* stream) {
  if (bad_args(batch, log2n, radix, block) || log2n < 1 || (block & 1)) {
    return cudaErrorInvalidValue;
  }
  if (log2n1 != 0 &&
      (scratch == nullptr || tw2 == nullptr ||
       bad_split(batch, log2n, log2n1, radix, lc1, lc2, true))) {
    return cudaErrorInvalidValue;
  }
  if (batch == 0) return cudaSuccess;
  if (log2n1 != 0) {
    const cudaStream_t st = (cudaStream_t)stream;
    const int lg2 = log2n - log2n1;
    const int pairs = (batch + 1) / 2;
    float* mr = scratch;
    float* mi = scratch + ((size_t)pairs << log2n);
    size_t smem = pass_smem(1 << lc1, log2n1, radix, true, true);
    cudaError_t err = opt_in(rfft_pass1_kernel, smem);
    if (err != cudaSuccess) return err;
    rfft_pass1_kernel<<<pairs << (lg2 - lc1), pass_threads(1 << lc1, log2n1),
                        smem, st>>>(x, mr, mi, wr, wi, batch, log2n, log2n1,
                                    radix, lc1);
    err = cudaGetLastError();
    if (err != cudaSuccess) return err;
    smem = pass_smem(2 << lc2, lg2, radix, true, false);
    err = opt_in(rfft_pass2_kernel, smem);
    if (err != cudaSuccess) return err;
    rfft_pass2_kernel<<<pairs << (log2n1 - 1 - lc2),
                        pass_threads(2 << lc2, lg2), smem, st>>>(
        mr, mi, yr, yi, tw2, batch, log2n, log2n1, radix, lc2);
    return cudaGetLastError();
  }
  size_t smem;
  cudaError_t err =
      smem_for(rfft_kernel, scratch != nullptr, block / 2, log2n, &smem);
  if (err != cudaSuccess) return err;
  const int grid = (batch + block - 1) / block;
  rfft_kernel<<<grid, threads_for(block / 2, log2n), smem,
                (cudaStream_t)stream>>>(x, yr, yi, wr, wi, scratch, batch,
                                        log2n, radix, block);
  return cudaGetLastError();
}

// log2n1 > 0: the two-pass schedule, `scratch` the intermediate (two planes
// of (batch + 1) / 2 * n floats), `tw2` the inverse pass-2 twiddle table,
// `block` unused; else one CTA per `block` rows (even), `tw2` unused.
int stockham_irfft(const float* xr, const float* xi, float* y,
                   const float* wr, const float* wi, float* scratch,
                   const float* tw2, int batch, int log2n, int radix,
                   int block, int log2n1, int lc1, int lc2, void* stream) {
  if (bad_args(batch, log2n, radix, block) || log2n < 1 || (block & 1)) {
    return cudaErrorInvalidValue;
  }
  const int pairs = (batch + 1) / 2;
  // both passes hold c sub-problems of one row (pair) and write device
  // memory, as the fft's do
  if (log2n1 != 0 &&
      (scratch == nullptr || tw2 == nullptr ||
       bad_split(pairs, log2n, log2n1, radix, lc1, lc2, false))) {
    return cudaErrorInvalidValue;
  }
  if (batch == 0) return cudaSuccess;
  if (log2n1 != 0) {
    const cudaStream_t st = (cudaStream_t)stream;
    const int lg2 = log2n - log2n1;
    float* mr = scratch;
    float* mi = scratch + ((size_t)pairs << log2n);
    size_t smem = pass_smem(1 << lc1, log2n1, radix, true, true);
    cudaError_t err = opt_in(irfft_pass1_kernel, smem);
    if (err != cudaSuccess) return err;
    irfft_pass1_kernel<<<pairs << (lg2 - lc1),
                         pass_threads(1 << lc1, log2n1), smem, st>>>(
        xr, xi, mr, mi, wr, wi, batch, log2n, log2n1, radix, lc1);
    err = cudaGetLastError();
    if (err != cudaSuccess) return err;
    smem = pass_smem(1 << lc2, lg2, radix, true, true);
    err = opt_in(irfft_pass2_kernel, smem);
    if (err != cudaSuccess) return err;
    irfft_pass2_kernel<<<pairs << (log2n1 - lc2), pass_threads(1 << lc2, lg2),
                         smem, st>>>(mr, mi, y, tw2, batch, log2n, log2n1,
                                     radix, lc2);
    return cudaGetLastError();
  }
  size_t smem;
  cudaError_t err =
      smem_for(irfft_kernel, scratch != nullptr, block / 2, log2n, &smem);
  if (err != cudaSuccess) return err;
  const int grid = (batch + block - 1) / block;
  irfft_kernel<<<grid, threads_for(block / 2, log2n), smem,
                 (cudaStream_t)stream>>>(xr, xi, y, wr, wi, scratch, batch,
                                         log2n, radix, block);
  return cudaGetLastError();
}

// log2n1 > 0: the split-pass schedule, `scratch` six planes of batch * n
// floats (F1's spectra of a and b, then P or the inverse's pass-1 result),
// `tw2f` the forward transforms' pass-2 table (split n1 x n2) and `tw2i`
// the inverse's (split n2 x n1 where fused, else n1 x n2), `block` unused;
// each launch is checked. log2n1 == 0: one CTA per `block` rows, `tw2f`
// and `tw2i` unused.
int stockham_polymul_complex(const float* ar, const float* ai,
                             const float* br, const float* bi, float* cr,
                             float* ci, const float* wr, const float* wi,
                             float* scratch, const float* tw2f,
                             const float* tw2i, int batch, int log2n,
                             int radix, int block, int log2n1, int lc1,
                             int lcm, int lci, void* stream) {
  if (bad_args(batch, log2n, radix, block)) return cudaErrorInvalidValue;
  if (log2n1 != 0 &&
      (scratch == nullptr || tw2f == nullptr || tw2i == nullptr ||
       bad_product_split(2L * batch, batch, log2n, log2n1, radix, lc1, lcm,
                         lci, 2))) {
    return cudaErrorInvalidValue;
  }
  if (batch == 0) return cudaSuccess;
  if (log2n1 != 0) {
    const cudaStream_t st = (cudaStream_t)stream;
    const int lg2 = log2n - log2n1;
    const bool fused = product_fused(log2n, radix);
    const size_t rn = (size_t)batch << log2n;
    float* fr = scratch;  // F1: a's rows, then b's
    float* fi = scratch + 2 * rn;
    float* pr = scratch + 4 * rn;  // P, or the inverse's pass-1 result
    float* pi = pr + rn;
    size_t smem = pass_smem(1 << lc1, log2n1, radix, true, true);
    cudaError_t err = opt_in(polymul_pass1_kernel, smem);
    if (err != cudaSuccess) return err;
    polymul_pass1_kernel<<<(2 * batch) << (lg2 - lc1),
                           pass_threads(1 << lc1, log2n1), smem, st>>>(
        ar, ai, br, bi, fr, fi, wr, wi, batch, log2n, log2n1, radix, lc1);
    err = cudaGetLastError();
    if (err != cudaSuccess) return err;
    smem = mid_smem(2 << lcm, lg2);
    err = opt_in(polymul_complex_mid_kernel, smem);
    if (err != cudaSuccess) return err;
    polymul_complex_mid_kernel<<<batch << (log2n1 - lcm),
                                 pass_threads(2 << lcm, lg2), smem, st>>>(
        fr, fi, pr, pi, tw2f, wr, wi, batch, log2n, log2n1, radix, lcm,
        fused);
    err = cudaGetLastError();
    if (err != cudaSuccess) return err;
    const float* sr = pr;
    const float* si = pi;
    if (!fused) {  // the inverse's pass 1 on P, into F1's buffer
      smem = pass_smem(1 << lc1, log2n1, radix, true, true);
      err = opt_in(fft_pass1_kernel, smem);
      if (err != cudaSuccess) return err;
      fft_pass1_kernel<<<batch << (lg2 - lc1), pass_threads(1 << lc1, log2n1),
                         smem, st>>>(pr, pi, fr, fi, wr, wi, log2n, log2n1,
                                     radix, 0, lc1);
      err = cudaGetLastError();
      if (err != cudaSuccess) return err;
      sr = fr;
      si = fi;
    }
    const int li1 = fused ? lg2 : log2n1;
    smem = pass_smem(1 << lci, log2n - li1, radix, true, true);
    err = opt_in(fft_pass2_kernel, smem);
    if (err != cudaSuccess) return err;
    const float inv = 1.f / (float)(1 << log2n);
    fft_pass2_kernel<<<batch << (li1 - lci), pass_threads(1 << lci,
                                                          log2n - li1),
                       smem, st>>>(sr, si, cr, ci, tw2i, log2n, li1, radix, 0,
                                   lci, inv, -inv);
    return cudaGetLastError();
  }
  size_t smem;
  cudaError_t err = smem_for(polymul_complex_kernel, scratch != nullptr,
                             2 * block, log2n, &smem);
  if (err != cudaSuccess) return err;
  const int grid = (batch + block - 1) / block;
  polymul_complex_kernel<<<grid, threads_for(2 * block, log2n), smem,
                           (cudaStream_t)stream>>>(
      ar, ai, br, bi, cr, ci, wr, wi, scratch, batch, log2n, radix, block);
  return cudaGetLastError();
}

// log2n1 > 0: the split-pass schedule, `scratch` two planes of batch * n
// floats (F1's spectra of z = a + ib) and two of (batch + 1) / 2 * n (Q, or
// the inverse's pass-1 result), `tw2f` the forward pass-2 table and `tw2i`
// the inverse's (from the inverse table), `twi` (fused only) the inverse
// table's entries W[m n1], m < n2, interleaved (re, im), `block` unused;
// each launch is checked. log2n1 == 0: one CTA per `block` rows (even),
// `twi` unused.
int stockham_polymul_real(const float* a, const float* b, float* c,
                          const float* wr, const float* wi, const float* wir,
                          const float* wii, float* scratch, const float* tw2f,
                          const float* tw2i, const float* twi, int batch,
                          int log2n, int radix, int block, int log2n1,
                          int lc1, int lcm, int lci, void* stream) {
  if (bad_args(batch, log2n, radix, block) || (block & 1)) {
    return cudaErrorInvalidValue;
  }
  const int pairs = (batch + 1) / 2;
  if (log2n1 != 0 &&
      (scratch == nullptr || tw2f == nullptr || tw2i == nullptr ||
       bad_product_split(batch, pairs, log2n, log2n1, radix, lc1, lcm, lci,
                         4) ||
       (product_fused(log2n, radix) && twi == nullptr))) {
    return cudaErrorInvalidValue;
  }
  if (batch == 0) return cudaSuccess;
  if (log2n1 != 0) {
    const cudaStream_t st = (cudaStream_t)stream;
    const int lg2 = log2n - log2n1;
    const bool fused = product_fused(log2n, radix);
    const size_t rn = (size_t)batch << log2n;
    float* fr = scratch;  // F1: Z of each product
    float* fi = scratch + rn;
    float* qr = scratch + 2 * rn;  // Q, or the inverse's pass-1 result
    float* qi = qr + ((size_t)pairs << log2n);
    size_t smem = pass_smem(1 << lc1, log2n1, radix, true, true);
    cudaError_t err = opt_in(fft_pass1_kernel, smem);
    if (err != cudaSuccess) return err;
    fft_pass1_kernel<<<batch << (lg2 - lc1), pass_threads(1 << lc1, log2n1),
                       smem, st>>>(a, b, fr, fi, wr, wi, log2n, log2n1, radix,
                                   0, lc1);
    err = cudaGetLastError();
    if (err != cudaSuccess) return err;
    smem = real_mid_smem(4 << lcm, lg2);
    err = opt_in(polymul_real_mid_kernel, smem);
    if (err != cudaSuccess) return err;
    polymul_real_mid_kernel<<<pairs << (log2n1 - 1 - lcm),
                              pass_threads(4 << lcm, lg2), smem, st>>>(
        fr, fi, qr, qi, tw2f, reinterpret_cast<const float2*>(twi), batch,
        log2n, log2n1, radix, lcm, fused);
    err = cudaGetLastError();
    if (err != cudaSuccess) return err;
    const float* sr = qr;
    const float* si = qi;
    if (!fused) {  // the inverse's pass 1 on Q, into F1's buffer
      smem = pass_smem(1 << lc1, log2n1, radix, true, true);
      err = opt_in(fft_pass1_kernel, smem);
      if (err != cudaSuccess) return err;
      fft_pass1_kernel<<<pairs << (lg2 - lc1), pass_threads(1 << lc1, log2n1),
                         smem, st>>>(qr, qi, fr, fi, wir, wii, log2n, log2n1,
                                     radix, 1, lc1);
      err = cudaGetLastError();
      if (err != cudaSuccess) return err;
      sr = fr;
      si = fi;
    }
    const int li1 = fused ? lg2 : log2n1;
    smem = pass_smem(1 << lci, log2n - li1, radix, true, true);
    err = opt_in(polymul_real_pass2_kernel, smem);
    if (err != cudaSuccess) return err;
    polymul_real_pass2_kernel<<<pairs << (li1 - lci),
                                pass_threads(1 << lci, log2n - li1), smem,
                                st>>>(sr, si, c, tw2i, batch, log2n, li1,
                                      radix, lci);
    return cudaGetLastError();
  }
  size_t smem;
  cudaError_t err = smem_for(polymul_real_kernel, scratch != nullptr, block,
                             log2n, &smem);
  if (err != cudaSuccess) return err;
  const int grid = (batch + block - 1) / block;
  polymul_real_kernel<<<grid, threads_for(block, log2n), smem,
                        (cudaStream_t)stream>>>(
      a, b, c, wr, wi, wir, wii, scratch, batch, log2n, radix, block);
  return cudaGetLastError();
}

// Occupancy of a launch as the launchers above make it: `kernel` is 0 fft,
// 1 rfft, 2 complex product, 3 real product, 4 irfft; `block` the rows per
// CTA the wrapper passes; `staged` whether the rows go through device
// memory. staged = 2, 3 (and 4 for the products) select a launch of the
// two-pass (split-pass) schedule, at radix 4, the planner's radix, with
// `log2n` the log2 of its sub-problem length and `block` its sub-problems
// per CTA: for the fft, the rfft and the irfft pass 1 or pass 2 (for the
// rfft's pass 2 the low sub-problems, each held with its mirror); for the
// products F1,
// M (its low sub-problems: the CTA holds b's beside them, or their mirrors
// and the pair's second row's) or I2. The products' fourth launch off the
// mirrored split is kernel 0's pass 1.
int stockham_occupancy(int kernel, int log2n, int block, int staged,
                       int* threads, int* smem, int* regs, int* ctas) {
  if (bad_args(1, log2n, 2, block)) return cudaErrorInvalidValue;
  if (staged >= 2 && staged <= 4) {
    if (log2n < 1) return cudaErrorInvalidValue;
    switch (kernel * 8 + staged) {
      case 0 * 8 + 2:
        return pass_occupancy(fft_pass1_kernel, block, log2n, 4, true, true,
                              threads, smem, regs, ctas);
      case 0 * 8 + 3:
        return pass_occupancy(fft_pass2_kernel, block, log2n, 4, true, true,
                              threads, smem, regs, ctas);
      case 1 * 8 + 2:
        return pass_occupancy(rfft_pass1_kernel, block, log2n, 4, true, true,
                              threads, smem, regs, ctas);
      case 1 * 8 + 3:
        return pass_occupancy(rfft_pass2_kernel, 2 * block, log2n, 4, true,
                              false, threads, smem, regs, ctas);
      case 2 * 8 + 2:
        return pass_occupancy(polymul_pass1_kernel, block, log2n, 4, true,
                              true, threads, smem, regs, ctas);
      case 2 * 8 + 3:
        return launch_occupancy(polymul_complex_mid_kernel,
                                pass_threads(2 * block, log2n),
                                mid_smem(2 * block, log2n), threads, smem,
                                regs, ctas);
      case 2 * 8 + 4:
        return pass_occupancy(fft_pass2_kernel, block, log2n, 4, true, true,
                              threads, smem, regs, ctas);
      case 3 * 8 + 2:
        return pass_occupancy(fft_pass1_kernel, block, log2n, 4, true, true,
                              threads, smem, regs, ctas);
      case 3 * 8 + 3:
        return launch_occupancy(polymul_real_mid_kernel,
                                pass_threads(4 * block, log2n),
                                real_mid_smem(4 * block, log2n), threads, smem,
                                regs, ctas);
      case 3 * 8 + 4:
        return pass_occupancy(polymul_real_pass2_kernel, block, log2n, 4,
                              true, true, threads, smem, regs, ctas);
      case 4 * 8 + 2:
        return pass_occupancy(irfft_pass1_kernel, block, log2n, 4, true, true,
                              threads, smem, regs, ctas);
      case 4 * 8 + 3:
        return pass_occupancy(irfft_pass2_kernel, block, log2n, 4, true, true,
                              threads, smem, regs, ctas);
    }
    return cudaErrorInvalidValue;
  }
  const bool st = staged != 0;
  switch (kernel) {
    case 0:
      return occupancy_of(fft_kernel, block, log2n, st, threads, smem, regs,
                          ctas);
    case 1:
      return occupancy_of(rfft_kernel, block / 2, log2n, st, threads, smem,
                          regs, ctas);
    case 2:
      return occupancy_of(polymul_complex_kernel, 2 * block, log2n, st,
                          threads, smem, regs, ctas);
    case 3:
      return occupancy_of(polymul_real_kernel, block, log2n, st, threads,
                          smem, regs, ctas);
    case 4:
      return occupancy_of(irfft_kernel, block / 2, log2n, st, threads, smem,
                          regs, ctas);
  }
  return cudaErrorInvalidValue;
}

}  // extern "C"
