// Stage probes of the timing-recovery resampler (kernel B).
//
// Replaces the Pallas TPU probes of tools/bisect_resample_kernel.py
// (stages dma, rows, rb, barrel, swap, full), tools/
// bisect_resample_kernel2.py (v0..v8) and tools/split_resample_pallas.py
// (kernel B's body on operands staged by a separate prep pass). On the TPU
// they located a compiler fault and split kernel B's time; here they say
// where kernel B's time goes: what a bare copy of the operands costs, what
// the per-tile shift adds, what the parity select adds, what the tap
// polynomial adds, and what staging the operands first would cost.
//
// One templated kernel, one stage per probe. Each stage computes what the
// TPU probe computes for the same inputs, not its block structure: the
// TPU kernels build [TC, WE] row windows by concatenating VMEM rows and
// shift them with a masked barrel; here a thread reads the samples its
// output needs directly, because a per-thread offset costs nothing on
// this card. The probes that exercised the TPU's asynchronous copies
// (v1..v4, dma) stage their TC + extra rows (the halo included) in shared
// memory with cp.async (16 bytes a thread per copy), wait, and compute
// from shared memory. Multiplies and adds of the `full` and `split` stages
// are rounded one by one (__fmul_rn / __fadd_rn) in the order of their
// plain PyTorch versions, so those agree bit for bit.
//
// What bounds every stage: bytes (one to three float planes in, one out,
// a handful of flops per value; `full` does ~190 flops per value and is
// still under the card's float32 rate at its byte time).

#include <cuda_pipeline.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int TS = 256;      // symbols per tile, and threads per block
constexpr int TAPS = 10;
constexpr int DEG = 9;

enum Stage {
  V0 = 0, V1, V2, V3, V4, V5, V6, V7, V8,
  DMA, ROWS, RB, BARREL, SWAP, FULL
};

// Copy `rows` rows of TS floats from global to shared memory with
// cp.async, 16 bytes per copy; the caller commits and waits.
__device__ __forceinline__ void stage_rows(float* dst, const float* src,
                                           int rows) {
  const int chunks = rows * (TS / 4);
  for (int ch = threadIdx.x; ch < chunks; ch += blockDim.x)
    __pipeline_memcpy_async(dst + 4 * ch, src + 4 * ch, 16);
}

// a, b: input planes; u: band coordinate [C, ntp, TS]; rb: per-tile
// shift [C, ntp]; out [C, ntp, TS]. Unblocked planes are [C, rows_in, TS]
// (rows_in = ntp for V0, ntp + extra else); V5..V8 read the blocked
// [C, nck, TC + extra, TS]. Block (k, c) computes tiles k*TC .. k*TC+TC-1
// of carrier c; thread j computes column j of each.
template <int STAGE>
__global__ void __launch_bounds__(TS)
probe_kernel(const float* __restrict__ a, const float* __restrict__ b,
             const float* __restrict__ u, const int* __restrict__ rb,
             float* __restrict__ out, int ntp, int TC, int extra,
             int shift_bits) {
  extern __shared__ __align__(16) float smem[];
  const int c = blockIdx.y;
  const int k = blockIdx.x;
  const int nck = gridDim.x;
  const int j = threadIdx.x;
  const int rows_in = (STAGE == V0) ? ntp : ntp + extra;
  const int hmask = (1 << (shift_bits - 1)) - 1;

  constexpr bool kAsync = STAGE == V1 || STAGE == V2 || STAGE == V3 ||
                          STAGE == V4 || STAGE == DMA;
  constexpr bool kTwo = STAGE == V2 || STAGE == DMA;
  constexpr bool kBlocked = STAGE == V5 || STAGE == V6 || STAGE == V7 ||
                            STAGE == V8;
  float* sa = smem;
  float* sb = smem + (size_t)(TC + extra) * TS;
  if (kAsync) {
    // V4 derives the carrier's plane first and the row window from it
    // (the TPU probe's chained .at[c].at[rows]); the address is the same
    const float* plane_a = a + (size_t)c * rows_in * TS;
    stage_rows(sa, plane_a + (size_t)k * TC * TS, TC + extra);
    if (kTwo)
      stage_rows(sb, b + (size_t)c * rows_in * TS + (size_t)k * TC * TS,
                 TC + extra);
    __pipeline_commit();
    __pipeline_wait_prior(0);
    __syncthreads();
  }
  // flat views: A[t*TS + x] for the unblocked planes, blk[i*TS + x] for
  // the blocked one (the TPU probes' rows-concat window is this view)
  const float* A = a + (size_t)c * rows_in * TS;
  const float* B = (b != nullptr) ? b + (size_t)c * rows_in * TS : nullptr;
  const float* blk = a + ((size_t)c * nck + k) * (size_t)(TC + extra) * TS;

  for (int i = 0; i < TC; ++i) {
    const int t = k * TC + i;
    const size_t o = ((size_t)c * ntp + t) * TS + j;
    const size_t p = (size_t)t * TS + j;
    float r = 0.f;
    if (STAGE == V0) {
      r = A[p] * 2.0f;
    } else if (STAGE == V1 || STAGE == V3 || STAGE == V4) {
      r = sa[i * TS + j] * 2.0f;
    } else if (kTwo) {
      r = sa[i * TS + j] + sb[i * TS + j];
    } else if (STAGE == V5 || STAGE == V6) {
      r = blk[i * TS + j] * 2.0f;
    } else if (STAGE == V7) {
      r = blk[i * TS + j] + (float)rb[c * ntp + t];
    } else if (STAGE == V8) {
      const int hv = (rb[c * ntp + t] >> 1) & 255;      // 8 barrel stages
      r = blk[i * TS + hv + j];
    } else if (STAGE == ROWS) {
      r = A[p] + B[p];
    } else if (STAGE == RB) {
      r = A[p] + B[p] + (float)(rb[c * ntp + t] >> 1);
    } else {
      const int rbv = rb[c * ntp + t];
      const int hv = (rbv >> 1) & hmask;
      const bool odd = (rbv & 1) != 0;
      const float* Ae = A + p + hv;          // even plane after the barrel
      const float* Ao = B + p + hv;          // odd plane after the barrel
      if (STAGE == BARREL) {
        r = Ae[0] + Ao[0];
      } else if (STAGE == SWAP) {
        const float e_pre = odd ? Ao[0] : Ae[0];
        const float o_pre = odd ? Ae[1] : Ao[0];
        r = e_pre + o_pre;
      } else {  // FULL: the stand-in polynomial, the same for every tap
        const float uu = u[o];
        float tap = 0.1f;
#pragma unroll
        for (int dg = 1; dg <= DEG; ++dg)
          tap = __fadd_rn(__fmul_rn(tap, uu), (float)(0.01 * dg));
#pragma unroll
        for (int ci = 0; ci < TAPS; ++ci) {
          const int h = ci >> 1;
          float v;
          if ((ci & 1) == 0) v = odd ? Ao[h] : Ae[h];          // e_pre
          else v = odd ? Ae[h + 1] : Ao[h];                    // o_pre
          r = __fadd_rn(r, __fmul_rn(tap, v));
        }
      }
    }
    out[o] = r;
  }
}

// split, prep pass: the four parity planes of y zero-padded by bias + 4
// on the left: plane_e[i] = ypp[2i], plane_o[i] = ypp[2i + 1] with
// ypp[x] = y[x - (bias + 4)], 0 outside [0, n2). Planes are [C, Wp].
__global__ void __launch_bounds__(TS)
split_prep_kernel(const float2* __restrict__ y, int n2, int bias, int Wp,
                  float* __restrict__ e_re, float* __restrict__ o_re,
                  float* __restrict__ e_im, float* __restrict__ o_im) {
  const int c = blockIdx.y;
  const int i = blockIdx.x * TS + threadIdx.x;
  if (i >= Wp) return;
  const float2* yc = y + (size_t)c * n2;
  const long s0 = 2L * i - (bias + 4);
  const float2 z = make_float2(0.f, 0.f);
  const float2 ve = (s0 >= 0 && s0 < n2) ? yc[s0] : z;
  const float2 vo = (s0 + 1 >= 0 && s0 + 1 < n2) ? yc[s0 + 1] : z;
  const size_t o = (size_t)c * Wp + i;
  e_re[o] = ve.x;
  e_im[o] = ve.y;
  o_re[o] = vo.x;
  o_im[o] = vo.y;
}

// split, kernel pass: resample_farrow.cu's arithmetic on the staged
// planes. Sample t of symbol (ti, j) sits at padded index
// 2*(TS*ti + hv + j) + odd + t with rb = 2*hv + odd, so it is plane
// (odd + t) & 1 at TS*ti + hv + j + ((odd + t) >> 1).
__global__ void __launch_bounds__(TS)
split_farrow_kernel(const float* __restrict__ e_re,
                    const float* __restrict__ o_re,
                    const float* __restrict__ e_im,
                    const float* __restrict__ o_im, int Wp,
                    const float* __restrict__ u, const int* __restrict__ rb,
                    int S, int nt, const float* __restrict__ coef,
                    float2* __restrict__ out) {
  __shared__ float cs[TAPS * (DEG + 1)];
  for (int k = threadIdx.x; k < TAPS * (DEG + 1); k += blockDim.x)
    cs[k] = coef[k];
  __syncthreads();
  const int c = blockIdx.y;
  const int ti = blockIdx.x;
  const int j = threadIdx.x;
  const int k = ti * TS + j;
  if (k >= S) return;
  const float uu = u[(size_t)c * nt * TS + k];
  const int rbv = rb[c * nt + ti];
  const int odd = rbv & 1;
  const size_t base = (size_t)c * Wp + (size_t)TS * ti + (rbv >> 1) + j;
  float re = 0.f, im = 0.f;
#pragma unroll
  for (int t = 0; t < TAPS; ++t) {
    float tap = cs[t * (DEG + 1)];
#pragma unroll
    for (int d = 1; d <= DEG; ++d)
      tap = __fadd_rn(__fmul_rn(tap, uu), cs[t * (DEG + 1) + d]);
    const int m = odd + t;
    const size_t idx = base + (m >> 1);
    const float vr = (m & 1) ? o_re[idx] : e_re[idx];
    const float vi = (m & 1) ? o_im[idx] : e_im[idx];
    re = __fadd_rn(re, __fmul_rn(tap, vr));
    im = __fadd_rn(im, __fmul_rn(tap, vi));
  }
  out[(size_t)c * S + k] = make_float2(re, im);
}

template <int STAGE>
int launch_stage(const float* a, const float* b, const float* u,
                 const int* rb, float* out, int C, int ntp, int TC,
                 int extra, int shift_bits, size_t smem, cudaStream_t st) {
  dim3 grid(ntp / TC, C);
  probe_kernel<STAGE><<<grid, TS, smem, st>>>(a, b, u, rb, out, ntp, TC,
                                              extra, shift_bits);
  return (int)cudaGetLastError();
}

}  // namespace

// One probe stage (see Stage). Planes float32, rb int32, out float32
// [C, ntp, TS]; ntp a multiple of TC. Returns cudaGetLastError() after
// the launch, or cudaErrorInvalidValue for an unknown stage or a row
// window above 48 KB of shared memory.
extern "C" int resample_probe(int stage, void* a, void* b, void* u, void* rb,
                              void* out, int C, int ntp, int TC, int extra,
                              int shift_bits, void* stream) {
  const float* pa = (const float*)a;
  const float* pb = (const float*)b;
  const float* pu = (const float*)u;
  const int* prb = (const int*)rb;
  float* po = (float*)out;
  cudaStream_t st = (cudaStream_t)stream;
  if (ntp % TC != 0) return (int)cudaErrorInvalidValue;
  const size_t plane = (size_t)(TC + extra) * TS * sizeof(float);
  if (2 * plane > 48 * 1024) return (int)cudaErrorInvalidValue;
#define DVBS_PROBE_CASE(S, SM) \
  case S: return launch_stage<S>(pa, pb, pu, prb, po, C, ntp, TC, extra, \
                                 shift_bits, SM, st);
  switch (stage) {
    DVBS_PROBE_CASE(V0, 0)
    DVBS_PROBE_CASE(V1, plane)
    DVBS_PROBE_CASE(V2, 2 * plane)
    DVBS_PROBE_CASE(V3, plane)
    DVBS_PROBE_CASE(V4, plane)
    DVBS_PROBE_CASE(V5, 0)
    DVBS_PROBE_CASE(V6, 0)
    DVBS_PROBE_CASE(V7, 0)
    DVBS_PROBE_CASE(V8, 0)
    DVBS_PROBE_CASE(DMA, 2 * plane)
    DVBS_PROBE_CASE(ROWS, 0)
    DVBS_PROBE_CASE(RB, 0)
    DVBS_PROBE_CASE(BARREL, 0)
    DVBS_PROBE_CASE(SWAP, 0)
    DVBS_PROBE_CASE(FULL, 0)
  }
#undef DVBS_PROBE_CASE
  return (int)cudaErrorInvalidValue;
}

// split, prep pass: y [C, n2] complex64 -> four planes [C, Wp] float32.
extern "C" int resample_probe_prep(void* y, int C, int n2, int bias, int Wp,
                                   void* e_re, void* o_re, void* e_im,
                                   void* o_im, void* stream) {
  dim3 grid((Wp + TS - 1) / TS, C);
  split_prep_kernel<<<grid, TS, 0, (cudaStream_t)stream>>>(
      (const float2*)y, n2, bias, Wp, (float*)e_re, (float*)o_re,
      (float*)e_im, (float*)o_im);
  return (int)cudaGetLastError();
}

// split, kernel pass: planes [C, Wp], u [C, nt*TS], rb [C, nt] (biased),
// coef [TAPS, DEG+1] -> out [C, S] complex64.
extern "C" int resample_probe_split(void* e_re, void* o_re, void* e_im,
                                    void* o_im, int C, int Wp, void* u,
                                    void* rb, int S, int nt, void* coef,
                                    void* out, void* stream) {
  dim3 grid(nt, C);
  split_farrow_kernel<<<grid, TS, 0, (cudaStream_t)stream>>>(
      (const float*)e_re, (const float*)o_re, (const float*)e_im,
      (const float*)o_im, Wp, (const float*)u, (const int*)rb, S, nt,
      (const float*)coef, (float2*)out);
  return (int)cudaGetLastError();
}
