// Timing-recovery interpolator, positions in, symbols out: per-tile
// integer shift + 10-tap Farrow.
//
// Replaces the Pallas TPU kernel of dvbs_tpu/ops/resample_pallas.py:202
// (_kernel, launched by pl.pallas_call in _resample_core) and takes what
// its entry takes (resample_windowed_pallas through _resample_batched):
// the samples y [C, n2] and each symbol's sample position t [C, S]. For
// the 256-symbol tile ti of carrier c it derives, as _resample_batched
// does (ops/resample_kernel.shifts_and_band is the plain version),
//
//   g[k]  = t[c, min(k, S-1)] - 2k           (edge pad past S)
//   r     = rint((g[TS ti + 127] + g[TS ti + 128]) / 2)
//   rb    = clamp(r + bias, 0, 2 bias - 1)
//   u[k]  = (clamp(g[k] - r + 4, lo, hi) - mid) / halfr
//   out[c, k] = sum_{t<10} tap_t(u[k]) * y[c, 2 TS ti + rb-bias + 2j + t-4]
//
// with j = k - TS ti, tap_t Horner's rule over the fitted coefficients
// (highest power first) and a read outside [0, n2) taken as 0 (the
// zero-padded buffer of frontend.resample_windowed). rb and u are
// bit-exact with the plain version: the same float32 operations in the
// same order, each rounded on its own (__fsub_rn, __fadd_rn, __fmul_rn,
// __fdiv_rn; rintf rounds half to even as torch.round; fminf/fmaxf
// clamp), since another rb would read other samples. The tap polynomial
// and the tap sum are fused multiply-adds (fmaf), so the output differs
// from the plain version's at float32 rounding (<= 1e-5 on unit-variance
// samples, the tolerance dvbs_tpu holds its kernel to against XLA).
//
// What bounds it: bytes. A symbol reads two samples of y (neighbouring
// tiles' windows overlap by 8 samples), one position and writes one
// complex value: ~28 B a symbol, 124 MB for the 8-carrier bank's block
// (0.037 ms at 3.35 TB/s), against ~110 FFMA a symbol (0.015 ms at the
// float32 peak). What the design does about it:
//   - the shift and the band coordinate are computed here from t, so u
//     makes no round trip through HBM and the ~15 elementwise launches
//     that computed it before the kernel are gone;
//   - the 100 coefficients are a launch parameter (constant bank), so
//     each Horner step takes its coefficient as an FFMA operand: no
//     shared-memory load in the tap loop (cuobjdump -sass shows no LDS);
//   - four consecutive symbols a thread, 64 threads a tile: their
//     10-sample windows overlap by 8, so 16 samples serve 40 taps, read
//     in eight (or seven, at an odd address) 16-byte loads; the four
//     outputs go out in two 16-byte stores;
//   - a tile whose window lies inside [0, n2) loads without bounds
//     checks; only edge tiles take the masked path (a CTA-uniform
//     branch);
//   - FMA: ~110 float instructions a symbol where rounding each multiply
//     and add on its own took ~200.
// What holds at one carrier: the launch's fixed cost and two dependent
// trips to memory (the positions, then the samples at the shift they
// give). [1, 131072] is 512 CTAs and [1, 32768] 128, each a few hundred
// ns of work.

#include <cuda_runtime.h>
#include <stdint.h>
#include <string.h>

namespace {

constexpr int TS = 256;                     // tables.TILE_SYM
constexpr int TAPS = 10;                    // tables.FARROW_TAPS
constexpr int DEG = 9;                      // tables.FARROW_DEG
constexpr int SPT = 4;                      // symbols a thread
constexpr int THREADS = TS / SPT;           // a tile's CTA
constexpr int WIN = 2 * (SPT - 1) + TAPS;   // samples a thread reads
constexpr int SPAN = 2 * (TS - 1) + TAPS;   // samples a tile reads

struct Farrow {
  float c[TAPS][DEG + 1];       // highest power first
  float lo, hi, mid, halfr;     // u = (clamp(d, lo, hi) - mid) / halfr
};

// how a thread loads its WIN samples from w on: masked 8-byte loads (zero
// outside [0, n2)) in a tile whose window leaves the block; else 16-byte
// loads, from w where that address is 16-byte aligned (ALIGNED), from w + 1
// with one 8-byte load at each end where it is not (SHIFTED)
enum Loads { EDGE, ALIGNED, SHIFTED };

template <Loads MODE>
__device__ __forceinline__ void load_window(const float2* __restrict__ yc,
                                            int n2, int w,
                                            float2 (&v)[WIN]) {
  if (MODE == EDGE) {
#pragma unroll
    for (int i = 0; i < WIN; ++i)
      v[i] = (w + i >= 0 && w + i < n2) ? yc[w + i] : make_float2(0.f, 0.f);
    return;
  }
  constexpr int a = MODE == SHIFTED;
  const float4* p = reinterpret_cast<const float4*>(yc + w + a);
#pragma unroll
  for (int i = 0; i < WIN / 2 - a; ++i) {
    const float4 q = p[i];
    v[a + 2 * i] = make_float2(q.x, q.y);
    v[a + 2 * i + 1] = make_float2(q.z, q.w);
  }
  if (a) {
    v[0] = yc[w];
    v[WIN - 1] = yc[w + WIN - 1];
  }
}

__global__ void __launch_bounds__(THREADS)
farrow_kernel(const float2* __restrict__ y, int n2,
              const float* __restrict__ t, int S, int bias, const Farrow f,
              float2* __restrict__ out, float* __restrict__ u_out,
              int* __restrict__ rb_out) {
  const int c = blockIdx.y;
  const int ti = blockIdx.x;
  const float* tc = t + (size_t)c * S;
  // the tile's shift, from the positions of its two centre symbols
  const int kc = ti * TS + TS / 2 - 1;
  const float g0 = __fsub_rn(tc[min(kc, S - 1)], (float)(2 * kc));
  const float g1 = __fsub_rn(tc[min(kc + 1, S - 1)], (float)(2 * kc + 2));
  const float r = rintf(__fmul_rn(0.5f, __fadd_rn(g0, g1)));
  const int rb = min(max((int)r + bias, 0), 2 * bias - 1);
  const int w0 = 2 * TS * ti + rb - bias - 4;     // the tile's first sample
  const int k0 = ti * TS + SPT * threadIdx.x;
  float u[SPT];
#pragma unroll
  for (int s = 0; s < SPT; ++s) {
    const int k = k0 + s;
    const float g = __fsub_rn(tc[min(k, S - 1)], (float)(2 * k));
    const float d = __fadd_rn(__fsub_rn(g, r), 4.0f);
    u[s] = __fdiv_rn(__fsub_rn(fminf(fmaxf(d, f.lo), f.hi), f.mid), f.halfr);
  }
  if (u_out != nullptr) {       // the checks' copy of the shifts and band
    if (threadIdx.x == 0) rb_out[c * gridDim.x + ti] = rb;
#pragma unroll
    for (int s = 0; s < SPT; ++s)
      u_out[(size_t)c * gridDim.x * TS + k0 + s] = u[s];
  }
  if (k0 >= S) return;
  const float2* yc = y + (size_t)c * n2;
  const int w = w0 + 2 * SPT * threadIdx.x;
  float2 v[WIN];
  // CTA-uniform: w - w0 is a multiple of 8 samples
  if (!(w0 >= 0 && w0 + SPAN <= n2))
    load_window<EDGE>(yc, n2, w, v);
  else if ((reinterpret_cast<uintptr_t>(yc + w0) & 15) == 0)
    load_window<ALIGNED>(yc, n2, w, v);
  else
    load_window<SHIFTED>(yc, n2, w, v);
  float re[SPT], im[SPT];
#pragma unroll
  for (int s = 0; s < SPT; ++s) re[s] = im[s] = 0.f;
#pragma unroll
  for (int tp = 0; tp < TAPS; ++tp) {
#pragma unroll
    for (int s = 0; s < SPT; ++s) {
      float p = f.c[tp][0];
#pragma unroll
      for (int d = 1; d <= DEG; ++d) p = fmaf(p, u[s], f.c[tp][d]);
      re[s] = fmaf(p, v[2 * s + tp].x, re[s]);
      im[s] = fmaf(p, v[2 * s + tp].y, im[s]);
    }
  }
  float2* oc = out + (size_t)c * S + k0;
  if (k0 + SPT <= S && (reinterpret_cast<uintptr_t>(oc) & 15) == 0) {
#pragma unroll
    for (int s = 0; s < SPT; s += 2)
      reinterpret_cast<float4*>(oc)[s / 2] =
          make_float4(re[s], im[s], re[s + 1], im[s + 1]);
  } else {
#pragma unroll
    for (int s = 0; s < SPT; ++s)
      if (k0 + s < S) oc[s] = make_float2(re[s], im[s]);
  }
}

}  // namespace

// y [C, n2] complex64 (interleaved float2), t [C, S] float32, coef the
// host's [TAPS, DEG+1] float32 table, the band (lo, hi, mid, halfr) ->
// out [C, S] complex64; u_out [C, nt*TS] float32 and rb_out [C, nt]
// int32 receive the band coordinates and shifts unless u_out is null.
// Returns cudaGetLastError() after the launch.
extern "C" int resample_farrow(void* y, int C, int n2, void* t, int S,
                               int bias, const void* coef, float lo,
                               float hi, float mid, float halfr, void* out,
                               void* u_out, void* rb_out, void* stream) {
  Farrow f;
  memcpy(f.c, coef, sizeof f.c);
  f.lo = lo;
  f.hi = hi;
  f.mid = mid;
  f.halfr = halfr;
  dim3 grid((S + TS - 1) / TS, C);
  farrow_kernel<<<grid, THREADS, 0, (cudaStream_t)stream>>>(
      (const float2*)y, n2, (const float*)t, S, bias, f, (float2*)out,
      (float*)u_out, (int*)rb_out);
  return (int)cudaGetLastError();
}

extern "C" const char* dvbs_cuda_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
