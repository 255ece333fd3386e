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
// Bound on this card: device-memory bytes -- each CTA reads 16 bytes and
// writes 16 bytes per point and does ~5 log2(n) flops per point, far below
// the 20 flops/byte at which the H100's fp32 rate would bind. Design: every
// sweep stays in shared memory while the row fits (n <= 8192), so device
// memory sees the input once and the output once; the 1/n scale is folded
// into the write-out. Longer rows take the device-memory scratch.
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
// butterflies and the working set of the complex kernel on real input.
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

// Kernel 3 -- replaces repro/kernels/fft.py::_irfft_kernel (irfft_planes).
// Inverse of rfft_kernel: the packed-Nyquist half-spectra (n/2 bins) of
// rows (2j, 2j+1) are unpacked to full Hermitian spectra A and B on the
// load (bin k > n/2 is conj P[n-k]; DC and Nyquist have zero imaginary
// parts), and one inverse complex transform of Z = A + iB gives both real
// rows, a = Re z and b = Im z, scaled by 1/n. An odd batch pairs its last
// spectrum with a zero spectrum, whose row is never written back. Bound:
// device-memory bytes (4 bytes in and 4 out per real point). Design: the
// unpacking happens in the load, so the full spectra never reach device
// memory, and two real rows share one complex transform.
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

// Kernel 5 -- replaces repro/kernels/polymul.py::_polymul_complex_kernel
// (polymul_complex_planes). Circular product mod x^n - 1 of complex rows:
// both forward transforms in one batched pass over 2*rows rows, the
// pointwise product, and the inverse as conj(FFT(conj P))/n with the
// forward table, all in one residency. Bound: device-memory bytes (32 bytes
// in, 16 out per point). Design: the two spectra and the product never
// leave the CTA while the pair of rows fits shared memory (n <= 4096),
// where the three-call library composite writes and reads every
// intermediate spectrum through device memory.
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
// (n <= 4096); longer rows take the device-memory scratch.
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

// Dynamic shared memory for `slots` complex rows in two buffers, 0 for the
// device-memory scratch path. Opts the kernel in above 48 KB.
template <typename Kernel>
cudaError_t smem_for(Kernel kernel, bool staged, int slots, int log2n,
                     size_t* bytes) {
  *bytes = staged ? 0 : 4 * ((size_t)slots << log2n) * sizeof(float);
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

const char* stockham_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

int stockham_fft(const float* xr, const float* xi, float* yr, float* yi,
                 const float* wr, const float* wi, float* scratch, int batch,
                 int log2n, int radix, int inverse, int block, void* stream) {
  if (bad_args(batch, log2n, radix, block)) return cudaErrorInvalidValue;
  if (batch == 0) return cudaSuccess;
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

int stockham_rfft(const float* x, float* yr, float* yi, const float* wr,
                  const float* wi, float* scratch, int batch, int log2n,
                  int radix, int block, void* stream) {
  if (bad_args(batch, log2n, radix, block) || log2n < 1 || (block & 1)) {
    return cudaErrorInvalidValue;
  }
  if (batch == 0) return cudaSuccess;
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

int stockham_irfft(const float* xr, const float* xi, float* y,
                   const float* wr, const float* wi, float* scratch,
                   int batch, int log2n, int radix, int block, void* stream) {
  if (bad_args(batch, log2n, radix, block) || log2n < 1 || (block & 1)) {
    return cudaErrorInvalidValue;
  }
  if (batch == 0) return cudaSuccess;
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

int stockham_polymul_complex(const float* ar, const float* ai,
                             const float* br, const float* bi, float* cr,
                             float* ci, const float* wr, const float* wi,
                             float* scratch, int batch, int log2n, int radix,
                             int block, void* stream) {
  if (bad_args(batch, log2n, radix, block)) return cudaErrorInvalidValue;
  if (batch == 0) return cudaSuccess;
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

int stockham_polymul_real(const float* a, const float* b, float* c,
                          const float* wr, const float* wi, const float* wir,
                          const float* wii, float* scratch, int batch,
                          int log2n, int radix, int block, void* stream) {
  if (bad_args(batch, log2n, radix, block) || (block & 1)) {
    return cudaErrorInvalidValue;
  }
  if (batch == 0) return cudaSuccess;
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
// 1 rfft, 2 complex product, 3 real product, 4 irfft; `block` the rows per CTA the
// wrapper passes; `staged` whether the rows go through device memory.
int stockham_occupancy(int kernel, int log2n, int block, int staged,
                       int* threads, int* smem, int* regs, int* ctas) {
  if (bad_args(1, log2n, 2, block)) return cudaErrorInvalidValue;
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
